"""BWA-SW on the CPU: the SAM bytes of the port's `bwasw`
(bwa_tpu_torch.cli) equal bwa_tpu's (bwa_tpu.cli), both run in process on
test_bwasw.py's cases: SE FASTQ, FASTA input (no qualities), reads with N,
PE with and without -S, and the seven option variants.  Tolerance: none,
whole files equal (the @SQ/@PG header included: both print bwasw's)."""

import numpy as np
import pytest

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()
    d = tmp_path_factory.mktemp("torch_bwasw")
    contigs = random_genome(200_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", contigs)
    reads = simulate_reads(contigs, 60, read_len=400, seed=133,
                           err_rate=0.01, indel_rate=0.001)
    write_fastq(d / "long.fq", reads)
    with open(d / "long.fa", "w") as f:  # the qual=None path
        for name, seq, _ in reads:
            f.write(f">{name}\n{seq.decode()}\n")
    rng = np.random.default_rng(9)
    noisy = []
    for name, seq, q in simulate_reads(contigs, 25, read_len=350, seed=134,
                                       err_rate=0.02, indel_rate=0.002):
        s = bytearray(seq)
        for _ in range(int(rng.integers(0, 6))):
            s[int(rng.integers(0, len(s)))] = ord("N")
        noisy.append((name, bytes(s), q))
    write_fastq(d / "ns.fq", noisy)
    a, b = simulate_reads(contigs, 40, read_len=250, seed=135,
                          err_rate=0.01, indel_rate=0.001, paired=True,
                          insert_mean=600, insert_std=60)
    write_fastq(d / "pe_1.fq", a)
    write_fastq(d / "pe_2.fq", b)
    return dict(prefix=index_build(str(d / "g.fa")), dir=d)


CASES = {
    "se": (["-t1"], ["long.fq"]),
    "fasta": ([], ["long.fa"]),
    "ambiguous": ([], ["ns.fq"]),
    "pe": ([], ["pe_1.fq", "pe_2.fq"]),
    "pe_S": (["-S"], ["pe_1.fq", "pe_2.fq"]),
    "z10": (["-z10"], ["long.fq"]),
    "pacbio": (["-b5", "-q2", "-r1", "-z10"], ["long.fq"]),
    "H_M": (["-H", "-M"], ["long.fq"]),
    "s5_T20": (["-s5", "-T20"], ["long.fq"]),
    "N1_G500": (["-N1", "-G500"], ["long.fq"]),
    "w20": (["-w20"], ["long.fq"]),
    "a2": (["-a2"], ["long.fq"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bwasw_matches_jax(world, tmp_path, case):
    from bwa_tpu.cli import main as jax_main
    from bwa_tpu_torch.cli import main

    flags, inputs = CASES[case]
    fqs = [str(world["dir"] / f) for f in inputs]
    outs = []
    for tag, run in (("jax", jax_main), ("port", main)):
        sam = tmp_path / f"{tag}.sam"
        assert run(["bwasw", *flags, "-f", str(sam), world["prefix"],
                    *fqs]) == 0
        outs.append(sam.read_bytes())
    assert outs[1] == outs[0]
    assert outs[0].count(b"\n") > len(CASES[case][1]) * 20
