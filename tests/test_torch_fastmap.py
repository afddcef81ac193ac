"""fastmap on the CPU: the port's command line (seeding machine, one read a
lane, then one SA lookup) prints bwa_tpu's fastmap output byte for byte,
bwa_tpu running its per-read host route in process.  Tolerance: none."""

import io

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_fastmap")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    reads = simulate_reads(g, 24, read_len=150, seed=81, err_rate=0.02)
    fq = d / "r.fq"
    write_fastq(fq, reads)
    return dict(prefix=index_build(str(d / "g.fa")), genome=g, dir=d,
                reads=reads, fq=fq)


def _outputs(prefix, fq, flags, monkeypatch):
    """(bwa_tpu's, the port's) fastmap output text for the FASTQ fq."""
    from bwa_tpu.cli import main as jax_main
    from bwa_tpu_torch.cli import main

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    outs = []
    for run, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        out = io.StringIO()
        assert run(["fastmap", *flags, *extra, prefix, str(fq)],
                   out_fp=out) == 0
        outs.append(out.getvalue())
    return outs


@pytest.mark.parametrize("flags", [[], ["-w", "3", "-l", "20"], ["-p"],
                                   ["-i", "2", "-I", "50", "-l", "10"]],
                         ids=["default", "w3_l20", "p", "i2_I50_l10"])
def test_cli_fastmap_matches_jax(world, monkeypatch, flags):
    """-i/-I take the per-read route (the engine's scalar API); -l 10 lets
    some of their repeated SMEMs print."""
    want, got = _outputs(world["prefix"], world["fq"], flags, monkeypatch)
    assert want.count("SQ\t") == len(world["reads"])
    assert "EM\t" in want
    assert got == want


def test_cli_fastmap_n_runs_match_jax(world, monkeypatch):
    """Reads with runs of N (a run inside, one at each end, a lone N, an
    all-N read): N ends every SMEM, on the machine as in the host spec."""
    runs = [[(40, 6)], [(0, 3)], [(148, 2)], [(100, 1)],
            [(40, 6), (0, 3), (148, 2), (100, 1)]]
    rng = np.random.default_rng(83)
    reads = []
    for i, (name, seq, qual) in enumerate(world["reads"][:8]):
        s = bytearray(seq)
        for at, ln in (runs[i] if i < len(runs)
                       else [(int(rng.integers(10, 140)), 1)]):
            s[at:at + ln] = b"N" * ln
        reads.append((name, bytes(s), qual))
    reads.append(("allN", b"N" * 150, b"I" * 150))
    fq = world["dir"] / "n.fq"
    write_fastq(fq, reads)
    want, got = _outputs(world["prefix"], fq, [], monkeypatch)
    assert want.count("SQ\t") == len(reads)
    assert got == want


def test_fastmap_overflow_lane_takes_per_read_route(world):
    """One lane overflows at cap 64 and again at min(192, L + 2): that lane
    alone climbs to the second cap, and that read alone takes the per-read
    route (the engine's scalar API); the lines stay bwa_tpu's."""
    from bwa_tpu.index.fmindex import FMIndex as JaxFM
    from bwa_tpu.mem.fastmap import fastmap_batch as jax_fastmap
    from bwa_tpu.mem.types import Read as JaxRead
    from bwa_tpu.ops.fm_host import HostFM as JaxHostFM
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.fastmap import fastmap_batch
    from bwa_tpu_torch.mem.types import Read

    rs = world["reads"][:6]
    fm = FMIndex.load(world["prefix"])
    eng = make_engine(fm, "cpu")
    caps, per_read = [], []
    real_wait, real_smem = eng.collect_seeds_wait, eng.smem1a

    def wait(h):
        out = real_wait(h)
        caps.append((h[2], len(out[5])))
        sn = out[5].copy()
        sn[2 if len(caps) == 1 else 0] = h[2] + 1
        return out[:5] + (sn,) + out[6:]

    eng.collect_seeds_wait = wait
    eng.smem1a = lambda *a: per_read.append(1) or real_smem(*a)
    got = list(fastmap_batch(fm, eng, [Read(name=n, seq=s, qual=q)
                                       for n, s, q in rs]))
    assert caps == [(64, 6), (192, 1)] and per_read
    jfm = JaxFM.load(world["prefix"])
    want = list(jax_fastmap(jfm, JaxHostFM(jfm), [
        JaxRead(name=n, seq=s, qual=q) for n, s, q in rs]))
    assert got == want
