"""End-to-end mem paired-end on the CPU: SAM bytes from the port
(bwa_tpu_torch) equal the JAX package's, through process_seqs with
MEM_F_PE and through both command lines (two FASTQs with -I, -p on an
interleaved file)."""

import io

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
    d = tmp_path_factory.mktemp("torch_mem_pe")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    return dict(prefix=index_build(str(d / "g.fa")), genome=g, dir=d)


def _interleave(r1, r2):
    return [r for pair in zip(r1, r2) for r in pair]


def _jax_sam(prefix, rs, mode=None):
    """bwa_tpu's PE SAM of interleaved reads rs (its batched engine)."""
    from bwa_tpu.engine import make_engine
    from bwa_tpu.index.fmindex import FMIndex
    from bwa_tpu.mem.pipeline import process_seqs
    from bwa_tpu.mem.types import Read
    from bwa_tpu.options import MEM_F_PE, MemOptions

    fm = FMIndex.load(prefix)
    opt = MemOptions()
    opt.apply_mode(mode)
    opt.flag |= MEM_F_PE
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    process_seqs(opt, make_engine(fm, "tpu"), fm, reads, 0, None, None)
    return "".join(r.sam for r in reads)


def _torch_sam(prefix, rs, mode=None, device_ext=None, engine_hook=None):
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import MEM_F_PE, MemOptions

    fm = FMIndex.load(prefix)
    eng = make_engine(fm, "cpu")
    if engine_hook is not None:
        engine_hook(eng)
    opt = MemOptions()
    opt.apply_mode(mode)
    opt.flag |= MEM_F_PE
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    process_seqs(opt, eng, fm, reads, 0, None, None, device_ext=device_ext)
    return "".join(r.sam for r in reads)


def _pairs(world, n, seed, **kw):
    return _interleave(*simulate_reads(world["genome"], n, read_len=150,
                                       seed=seed, paired=True, **kw))


def test_mem_pe_150bp_matches_jax(world):
    rs = _pairs(world, 64, 43)
    want = _jax_sam(world["prefix"], rs)
    assert want.count("\n") >= 128
    assert _torch_sam(world["prefix"], rs) == want


def test_mem_pe_several_buckets_match_jax(world, monkeypatch):
    """Buckets of 32 reads: 60 pairs seed in four machine calls (the last
    one partly filled) and collect_se_flat joins them with batch-global
    offsets before the one PE finalize, with the same SAM bytes as
    bwa_tpu's single bucket."""
    from bwa_tpu_torch.mem import batch_seed

    monkeypatch.setattr(batch_seed, "_lane_bucket", lambda L, nb=None: 32)
    calls = []

    def hook(eng):
        real = eng.collect_seeds_dispatch

        def dispatch(q, lens, *a, **kw):
            calls.append(len(lens))
            return real(q, lens, *a, **kw)

        eng.collect_seeds_dispatch = dispatch

    rs = _pairs(world, 60, 67)
    got = _torch_sam(world["prefix"], rs, engine_hook=hook)
    assert calls == [16, 16, 16, 16]
    assert got == _jax_sam(world["prefix"], rs)


def test_mem_pe_retry_ladder_matches_jax(world, monkeypatch):
    """A stack cap of 2 overflows lanes: both climb the device cap ladder
    before the PE finalize and still agree byte for byte."""
    monkeypatch.setenv("BWA_TPU_STACK_CAP", "2")
    rs = _pairs(world, 12, 47, err_rate=0.03)
    assert _torch_sam(world["prefix"], rs) == _jax_sam(world["prefix"], rs)


def test_mem_pe_tuple_fallback_matches_jax(world):
    """Every rung of the port's ladder, the lane-wide one included,
    reports overflow: the batch takes the per-read tuple path into the PE
    finalize, with the same SAM bytes."""
    caps = []

    def hook(eng):
        real_wait = eng.collect_seeds_wait

        def wait(h):
            out = real_wait(h)
            caps.append(h[2])
            return out[:5] + (out[5] * 0 + h[2] + 1,) + out[6:]

        eng.collect_seeds_wait = wait

    rs = _pairs(world, 8, 53)
    got = _torch_sam(world["prefix"], rs, engine_hook=hook)
    assert caps == [24, 96, 256]
    assert got == _jax_sam(world["prefix"], rs)


@pytest.mark.parametrize("stage", ["first", "all"])
def test_mem_pe_pacbio_device_extension_matches_jax(world, monkeypatch,
                                                    stage):
    """-x pacbio 700 bp reads as pairs with the seed extensions on the
    device path through the PE finalize's callback: the port's band DP
    (plain version on the CPU) vs bwa_tpu's Pallas kernel."""
    from bwa_tpu_torch.ops.ext_gather import ExtGatherEngine

    jobs = []
    real = ExtGatherEngine.run_fused
    monkeypatch.setattr(ExtGatherEngine, "run_fused",
                        lambda self, meta, opt: jobs.append(len(meta))
                        or real(self, meta, opt))
    monkeypatch.setenv("BWA_TPU_EXT", "device")
    monkeypatch.setenv("BWA_TPU_EXT_STAGE", stage)
    rs = simulate_reads(world["genome"], 6 if stage == "first" else 4,
                        read_len=700, seed=59, err_rate=0.04,
                        indel_rate=0.02)
    want = _jax_sam(world["prefix"], rs, "pacbio")
    assert _torch_sam(world["prefix"], rs, "pacbio", device_ext=True) == want
    assert jobs and sum(jobs) > 0


def _cli_body(main, argv):
    out = io.StringIO()
    assert main(argv, out_fp=out) == 0
    return "".join(ln for ln in out.getvalue().splitlines(keepends=True)
                   if not ln.startswith("@"))


@pytest.mark.parametrize("extra", [["-I", "250,30"],
                                   ["-I", "250,30,400,100"],
                                   ["-p"], ["-5"]])
def test_cli_pe_matches_jax(world, monkeypatch, extra):
    """Both command lines on the same files: two FASTQs with a given
    insert-size distribution (-I) or with -5, or -p on one interleaved file
    that also holds unpaired reads (smart pairing)."""
    from bwa_tpu.cli import main as jax_main

    from bwa_tpu_torch.cli import main as torch_main

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    r1, r2 = simulate_reads(world["genome"], 24, read_len=150, seed=61,
                            paired=True)
    d = world["dir"]
    if extra == ["-p"]:
        rs = _interleave(r1, r2)
        rs = rs[:6] + rs[7:31] + rs[32:]  # two unpaired reads
        write_fastq(d / "il.fq", rs)
        files = [str(d / "il.fq")]
    else:
        write_fastq(d / "r1.fq", r1)
        write_fastq(d / "r2.fq", r2)
        files = [str(d / "r1.fq"), str(d / "r2.fq")]
    want = _cli_body(jax_main, ["mem", *extra, world["prefix"], *files])
    assert want.count("\n") >= 46
    got = _cli_body(torch_main, ["mem", *extra, "--device", "cpu",
                                 world["prefix"], *files])
    assert got == want
