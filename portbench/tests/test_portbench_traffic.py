"""The read pool is a function of the seed, and its FASTQ text is the
pool's reads under their names."""

import json
from pathlib import Path

import numpy as np

from portbench import traffic
from portbench.genome import genome_codes

ROOT = Path(__file__).resolve().parents[2]


def mix(name, pool_bases):
    m = json.loads((ROOT / "portbench" / "mixes" / f"{name}.json")
                   .read_text())
    m["pool_bases"] = pool_bases
    return m


def genome(n=50_000):
    return genome_codes(dict(contigs=1, genome_length=n, sequence_seed=3))


def test_pool_repeats_for_a_seed_and_differs_across_seeds():
    g = genome()
    two_lengths = dict(mix("illumina_se150", 60_000),
                       reads={"kind": "single", "lengths": [150, 1000],
                              "ratio": [4, 1], "substitution_rate": 0.01})
    for m in (mix("illumina_se150", 60_000), mix("illumina_pe150", 60_000),
              two_lengths):
        a = traffic.make_pool(g, m, 2**33 + 5)
        b = traffic.make_pool(g, m, 2**33 + 5)
        c = traffic.make_pool(g, m, 2**33 + 6)
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.origins, b.origins)
        assert not np.array_equal(a.origins, c.origins)
        assert np.array_equal(
            traffic.sample_records(a, 9, 20, 2),
            traffic.sample_records(b, 9, 20, 2))


def test_reads_come_from_their_origins():
    g = genome()
    doubled = np.concatenate([g, 3 - g[::-1]])
    p = traffic.make_pool(g, mix("illumina_pe150", 30_000), 1)
    err = 0
    for k in range(p.n):
        s = p.seq(k)
        err += int((s != doubled[p.origins[k]:p.origins[k] + len(s)]).sum())
    rate = err / p.cum_bases[-1]
    assert 0.003 < rate < 0.007  # 0.5% substitutions


def test_fastq_text_holds_the_pool():
    g = genome()
    m = dict(mix("illumina_se150", 20_000),
             reads={"kind": "single", "lengths": [150, 1000], "ratio": [4, 1],
                    "substitution_rate": 0.01})
    p = traffic.make_pool(g, m, 4)
    (fq,) = traffic.fastq_streams(p)
    fq.rename(17)
    lines = bytes(fq.buf).split(b"\n")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for k in range(p.n):
        assert lines[4 * k] == b"@" + p.name(k, 17).encode()
        assert lines[4 * k + 1] == acgt[p.seq(k)].tobytes()
        assert lines[4 * k + 3] == b"I" * p.lengths[k]


def test_stream_serves_whole_passes_renamed():
    p = traffic.make_pool(genome(), mix("illumina_se150", 6_000), 5)
    (fq,) = traffic.fastq_streams(p)
    one = bytes(traffic.open_stream(fq, 7, limit=p.n).read())
    fq.rename(7)
    assert one == bytes(fq.buf)
    assert bytes(traffic.open_stream(fq, 7, limit=3).read()) == \
        bytes(fq.buf[:fq.off[3]])
    endless = traffic.open_stream(fq, 998)
    got = endless.read(3 * len(fq.buf))
    while len(got) < 3 * len(fq.buf):
        got += endless.read(3 * len(fq.buf) - len(got))
    for i, pass_no in enumerate((998, 999, 0)):
        fq.rename(pass_no)
        part = got[i * len(fq.buf):(i + 1) * len(fq.buf)]
        assert part == bytes(fq.buf)


def test_pairs_stream_as_two_files_in_step():
    p = traffic.make_pool(genome(), mix("illumina_pe150", 30_000), 2)
    f1, f2 = traffic.fastq_streams(p)
    n1 = bytes(f1.buf).split(b"\n")[0::4]
    n2 = bytes(f2.buf).split(b"\n")[0::4]
    assert n1 == n2
    assert p.chunk_records(3000) % 2 == 0
