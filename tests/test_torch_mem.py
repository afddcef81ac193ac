"""End-to-end mem SE on the CPU: SAM bytes from the port (bwa_tpu_torch)
equal the JAX package's process_seqs with its batched engine."""

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
    d = tmp_path_factory.mktemp("torch_mem")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    return dict(prefix=index_build(str(d / "g.fa")), genome=g, dir=d)


def _jax_sam(prefix, rs, mode, w=None):
    from bwa_tpu.engine import make_engine
    from bwa_tpu.index.fmindex import FMIndex
    from bwa_tpu.mem.pipeline import process_seqs
    from bwa_tpu.mem.types import Read
    from bwa_tpu.options import MemOptions

    fm = FMIndex.load(prefix)
    opt = MemOptions()
    opt.apply_mode(mode)
    if w is not None:
        opt.w = w
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    process_seqs(opt, make_engine(fm, "tpu"), fm, reads, 0, None, None)
    return "".join(r.sam for r in reads)


def _torch_sam(prefix, rs, mode, device_ext=None, w=None):
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import MemOptions

    fm = FMIndex.load(prefix)
    opt = MemOptions()
    opt.apply_mode(mode)
    if w is not None:
        opt.w = w
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    process_seqs(opt, make_engine(fm, "cpu"), fm, reads, 0, None, None,
                 device_ext=device_ext)
    return "".join(r.sam for r in reads)


def test_mem_se_150bp_matches_jax(world):
    rs = simulate_reads(world["genome"], 64, read_len=150, seed=13)
    want = _jax_sam(world["prefix"], rs, None)
    assert want.count("\n") >= 64
    assert _torch_sam(world["prefix"], rs, None) == want


@pytest.mark.parametrize("stage", ["first", "all"])
def test_mem_pacbio_device_extension_matches_jax(world, monkeypatch, stage):
    """-x pacbio long reads with the seed extensions on the device path
    (fused, both stages): the port's plain band DP vs the Pallas kernel."""
    monkeypatch.setenv("BWA_TPU_EXT", "device")
    monkeypatch.setenv("BWA_TPU_EXT_STAGE", stage)
    rs = simulate_reads(world["genome"], 4 if stage == "first" else 2,
                        read_len=700, seed=21, err_rate=0.05,
                        indel_rate=0.03)
    want = _jax_sam(world["prefix"], rs, "pacbio")
    assert _torch_sam(world["prefix"], rs, "pacbio", device_ext=True) == want


def test_mem_retry_ladder_matches_jax(world, monkeypatch):
    """A stack cap of 2 overflows lanes: both climb the device cap ladder
    (mem/batch_seed.py) and must still agree byte for byte."""
    monkeypatch.setenv("BWA_TPU_STACK_CAP", "2")
    rs = simulate_reads(world["genome"], 24, read_len=150, seed=29,
                        err_rate=0.03)
    assert _torch_sam(world["prefix"], rs, None) == \
        _jax_sam(world["prefix"], rs, None)


def test_mem_lane_wide_rung_before_host_fallback(world):
    """Long-read lanes that overflow every rung of the reference's ladder
    take one more rung as wide as the lane before the host fallback (here
    the overflow is forced below that width); SAM bytes stay bwa_tpu's."""
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import MemOptions

    rs = simulate_reads(world["genome"], 2, read_len=700, seed=37,
                        err_rate=0.05, indel_rate=0.03)
    fm = FMIndex.load(world["prefix"])
    eng = make_engine(fm, "cpu")
    caps = []
    real_wait = eng.collect_seeds_wait

    def wait(h):
        out = real_wait(h)
        caps.append(h[2])
        if h[2] < 704:  # narrower than the 704-base lane: report overflow
            out = out[:5] + (out[5] * 0 + h[2] + 1,) + out[6:]
        return out

    eng.collect_seeds_wait = wait
    opt = MemOptions()
    opt.apply_mode("pacbio")
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    process_seqs(opt, eng, fm, reads, 0, None, None)
    assert caps == [24, 96, 256, 704]
    assert "".join(r.sam for r in reads) == \
        _jax_sam(world["prefix"], rs, "pacbio")


def test_mem_se_tuple_fallback_matches_jax(world):
    """Every rung of the ladder, the lane-wide one included, reports
    overflow: the bucket takes the per-read host seeding path into the SE
    finalize, with the same SAM bytes."""
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import MemOptions

    rs = simulate_reads(world["genome"], 8, read_len=150, seed=31)
    fm = FMIndex.load(world["prefix"])
    eng = make_engine(fm, "cpu")
    caps = []
    real_wait = eng.collect_seeds_wait

    def wait(h):
        out = real_wait(h)
        caps.append(h[2])
        return out[:5] + (out[5] * 0 + h[2] + 1,) + out[6:]

    eng.collect_seeds_wait = wait
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    process_seqs(MemOptions(), eng, fm, reads, 0, None, None)
    assert caps == [24, 96, 256]
    assert "".join(r.sam for r in reads) == \
        _jax_sam(world["prefix"], rs, None)


def test_cli_mem_on_cpu(world):
    from bwa_tpu_torch.cli import main

    rs = simulate_reads(world["genome"], 16, read_len=150, seed=3)
    fq = world["dir"] / "cli.fq"
    write_fastq(fq, rs)
    out = io.StringIO()
    assert main(["mem", "--device", "cpu", world["prefix"], str(fq)],
                out_fp=out) == 0
    lines = out.getvalue().splitlines(keepends=True)
    assert lines[0].startswith("@HD") and any(
        ln.startswith("@PG\tID:bwa\tPN:bwa-tpu-torch") for ln in lines)
    body = "".join(ln for ln in lines if not ln.startswith("@"))
    assert body == _jax_sam(world["prefix"], rs, None)


def test_device_extension_gate():
    """Auto sends a batch to the band kernel only from a CUDA engine, for
    reads of 512 bp or more, at every band width (K2 takes any band)."""
    from types import SimpleNamespace

    import numpy as np

    from bwa_tpu_torch.mem.pipeline import use_device_ext
    from bwa_tpu_torch.options import MemOptions

    opt = MemOptions()
    opt.apply_mode("pacbio")
    gpu = SimpleNamespace(device=torch.device("cuda"))
    cpu = SimpleNamespace(device=torch.device("cpu"))
    long_, short = [np.zeros(2000, np.uint8)], [np.zeros(150, np.uint8)]
    assert use_device_ext(opt, gpu, long_)
    assert not use_device_ext(opt, cpu, long_)
    assert not use_device_ext(opt, gpu, short)
    assert use_device_ext(opt, cpu, short, device_ext=True)
    assert not use_device_ext(opt, gpu, long_, device_ext=False)
    opt.w = 1000  # the 2w retry band: P = 4096
    assert use_device_ext(opt, gpu, long_)
    opt.w = 1100  # P = 2304, retry P = 4480
    assert use_device_ext(opt, gpu, long_)
    assert not use_device_ext(opt, gpu, short)
    assert use_device_ext(opt, cpu, long_, device_ext=True)


def _deletion_read(genome, name, seed, pre=1100, gap=860, post=1100):
    """A read of `pre` bases, then the `post` bases that start `gap` bases
    further on (a deletion of `gap` bases), 2% substitutions: a seed
    extension crosses the deletion, so its best cell lies about `gap`
    columns off the diagonal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = np.frombuffer(genome[0][1], np.uint8)
    while True:
        s = int(rng.integers(0, len(seq) - pre - gap - post))
        r = np.concatenate([seq[s:s + pre], seq[s + pre + gap:
                                                s + pre + gap + post]])
        if not (r == ord("N")).any():
            break
    m = rng.random(len(r)) < 0.02
    r[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(m.sum()))]
    return name, r.tobytes(), b"I" * len(r)


def test_mem_pacbio_w1100_device_extension_matches_jax(world):
    """-x pacbio -w 1100 with the seed extensions on the device path: the
    port's plain band DP at P = 2304 and, for the band-doubling retry of
    the extensions that cross an 860-base deletion (max_off >= 825), at
    P = 4480, past the 4,096 slots the first K2 took; 700 bp reads and two
    2,200 bp reads with the deletion give bwa_tpu's SAM bytes."""
    from bwa_tpu_torch.ops import ext_gather

    rs = simulate_reads(world["genome"], 2, read_len=700, seed=43,
                        err_rate=0.05, indel_rate=0.03) \
        + [_deletion_read(world["genome"], f"del{k}", 47 + k)
           for k in range(2)]
    live = {}
    real = ext_gather.ksw_band_side

    def side(*a):
        live[a[-1]] = live.get(a[-1], 0) + int((a[8] > 0).sum())
        return real(*a)

    ext_gather.ksw_band_side = side
    try:
        got = _torch_sam(world["prefix"], rs, "pacbio", device_ext=True,
                         w=1100)
    finally:
        ext_gather.ksw_band_side = real
    assert live.get(2304) and live.get(4480)  # live jobs at both bands
    assert got == _jax_sam(world["prefix"], rs, "pacbio", w=1100)


def test_unported_modes_raise(world):
    """Single-end -5, which raised until it was ported, gives bwa_tpu's SAM
    bytes (the Python route: seeds one read a lane on the engine, chaining,
    extension, primary marking, the -5 reorder and SAM in Python)."""
    from bwa_tpu.engine import make_engine as jax_engine
    from bwa_tpu.index.fmindex import FMIndex as JaxFM
    from bwa_tpu.mem.pipeline import process_seqs as jax_process
    from bwa_tpu.mem.types import Read as JaxRead
    from bwa_tpu.options import MemOptions as JaxOptions
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import (MEM_F_KEEP_SUPP_MAPQ, MEM_F_PRIMARY5,
                                       MemOptions)

    rs = simulate_reads(world["genome"], 64, read_len=150, seed=13)
    sams = []
    for fm_cls, mk, run, rd, o, dev in (
            (JaxFM, jax_engine, jax_process, JaxRead, JaxOptions, "tpu"),
            (FMIndex, make_engine, process_seqs, Read, MemOptions, "cpu")):
        fm = fm_cls.load(world["prefix"])
        opt = o()
        opt.flag |= MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ
        reads = [rd(name=n, seq=s, qual=q) for n, s, q in rs]
        run(opt, mk(fm, dev), fm, reads, 0, None, None)
        sams.append("".join(r.sam for r in reads))
    assert sams[0].count("\n") >= 64
    assert sams[1] == sams[0]


@pytest.mark.parametrize("flags", [
    ["-a"], ["-T", "20"], ["-k", "25"], ["-Y"], ["-M"], ["-K", "10000"],
    ["-R", "@RG\\tID:x\\tSM:y"]],
    ids=["a", "T20", "k25", "Y", "M", "K10000", "R"])
def test_cli_mem_se_flags_match_jax(world, monkeypatch, flags):
    """The single-end options through both command lines (the port's on
    its CPU engine): the SAM, header included, equals bwa_tpu's but for
    @PG.  72 reads are 10,800 bases, so -K 10000 reads two chunks."""
    from bwa_tpu.cli import main as jax_main
    from bwa_tpu_torch.cli import main

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    fq = world["dir"] / "flags.fq"
    write_fastq(fq, simulate_reads(world["genome"], 72, read_len=150,
                                   seed=71, err_rate=0.02))
    outs = []
    for run, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        out = io.StringIO()
        assert run(["mem", *flags, *extra, world["prefix"], str(fq)],
                   out_fp=out) == 0
        outs.append([ln for ln in out.getvalue().splitlines()
                     if not ln.startswith("@PG")])
    assert sum(not ln.startswith("@") for ln in outs[0]) >= 72
    assert outs[1] == outs[0]
