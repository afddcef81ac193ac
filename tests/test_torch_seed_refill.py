"""K1's retire-and-refill mode (BWA_TPU_SEED_REFILL) on the CPU, after
tests/test_seed_refill.py without its oracle fixtures: the plain refill
machine's flat seed arrays equal the static route's and bwa_tpu's, lanes
recycle, a tiny seed store climbs the ladder, and the SAM bytes equal
bwa_tpu's under the same setting."""

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_seed_refill")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    fm = FMIndex.load(prefix)
    return dict(prefix=prefix, genome=g, fm=fm, eng=make_engine(fm, "cpu"))


def _codes(world, n, seed, L=151):
    """Reads simulated from the genome (real SMEM structure), plus a few
    random and N-riddled ones for the edge paths."""
    from bwa_tpu_torch.index.pack import NT4_TABLE

    sim = simulate_reads(world["genome"], max(1, n - n // 8),
                         read_len=min(150, L - 1), seed=seed, err_rate=0.02,
                         indel_rate=0.002)
    out = [NT4_TABLE[np.frombuffer(s, dtype=np.uint8)].copy()
           for _, s, _ in sim]
    rng = np.random.default_rng(seed)
    for _ in range(n - len(out)):
        ln = int(rng.integers(40, L))
        r = rng.integers(0, 4, size=ln).astype(np.uint8)
        if rng.random() < 0.5:
            r[rng.integers(0, ln)] = 4
        out.append(r)
    return out[:n]


def _flat(world, codes, refill, monkeypatch, lanes=None):
    from bwa_tpu_torch.mem.batch_seed import collect_se_flat
    from bwa_tpu_torch.options import MemOptions

    monkeypatch.delenv("BWA_TPU_REFILL_LANES", raising=False)
    if refill:
        monkeypatch.setenv("BWA_TPU_SEED_REFILL", "1")
        if lanes is not None:
            monkeypatch.setenv("BWA_TPU_REFILL_LANES", str(lanes))
    else:
        monkeypatch.delenv("BWA_TPU_SEED_REFILL", raising=False)
    return collect_se_flat(MemOptions(), world["eng"], world["fm"], codes)


def _jax_flat(world, codes, monkeypatch):
    """bwa_tpu's refill route on JAX CPU (one device: no mesh)."""
    from bwa_tpu.index.fmindex import FMIndex
    from bwa_tpu.mem.batch_seed import collect_se_flat
    from bwa_tpu.ops.fm import BatchedFMEngine
    from bwa_tpu.options import MemOptions

    monkeypatch.setenv("BWA_TPU_MESH", "off")
    monkeypatch.setenv("BWA_TPU_SEED_REFILL", "1")
    fm = FMIndex.load(world["prefix"])
    return collect_se_flat(MemOptions(), BatchedFMEngine(fm), fm, codes)


@pytest.fixture(scope="module")
def static97(world):
    """97 reads (seed 3) and their static route's flat arrays."""
    from bwa_tpu_torch.mem.batch_seed import collect_se_flat
    from bwa_tpu_torch.options import MemOptions

    codes = _codes(world, 97, 3)
    mp = pytest.MonkeyPatch()
    mp.delenv("BWA_TPU_SEED_REFILL", raising=False)
    try:
        flat = collect_se_flat(MemOptions(), world["eng"], world["fm"], codes)
    finally:
        mp.undo()
    return codes, flat


def _equal(a, b):
    assert a is not None and b is not None
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_reads,seed", [(97, 3), (300, 5)])
def test_refill_flat_equals_static(world, static97, monkeypatch, n_reads,
                                   seed):
    from bwa_tpu_torch.ops import fm_machine

    if n_reads == 97:
        codes, a = static97
    else:
        codes = _codes(world, n_reads, seed)
        a = _flat(world, codes, False, monkeypatch)
    n0 = fm_machine.refill_launches
    b = _flat(world, codes, True, monkeypatch)
    assert fm_machine.refill_launches == n0  # the plain version, no kernel
    _equal(a, b)
    if n_reads == 97:
        _equal(b, _jax_flat(world, codes, monkeypatch))


def test_refill_lanes_recycle(world, static97, monkeypatch):
    """More reads than lanes: 32 lanes recycle through 97 reads (the
    utilization mechanism) and the queue drains exactly."""
    codes, a = static97
    eng = world["eng"]
    got = []
    real = eng.collect_seeds_refill_wait

    def wait(h):
        got.append(real(h))
        return got[-1]

    eng.collect_seeds_refill_wait = wait
    try:
        b = _flat(world, codes, True, monkeypatch, lanes=32)
    finally:
        del eng.collect_seeds_refill_wait
    _equal(a, b)
    (out, n_drawn), = got
    assert out[5].shape[0] == 32 and n_drawn == 97
    # the tag column names each row's read: the lanes seeded every read
    # with seeds, most lanes more than one
    tags = [set(out[6][i, :out[5][i]].tolist()) for i in range(32)]
    assert set().union(*tags) == set(np.nonzero(np.diff(a[0]))[0].tolist())
    assert sum(len(t) >= 2 for t in tags) >= 16


def test_refill_tiny_store_climbs_ladder(world, static97, monkeypatch):
    """A tiny seed store trips a degraded mode (a lane overflows or the
    lanes fill before the queue drains); the refill route's ladder (2x, then 4x
    the store) still gives the static route's arrays."""
    from bwa_tpu_torch.mem.batch_seed import _pad_reads
    from bwa_tpu_torch.options import MemOptions

    codes, a = static97
    eng = world["eng"]
    q, lens, _ = _pad_reads(codes)
    out, n_drawn = eng.collect_seeds_refill(q, lens, MemOptions(), cap_s=26,
                                            cap_r=24, lanes=16)
    assert (out[5] > 26).any() or n_drawn < len(codes)
    stores = []
    real_wait = eng.collect_seeds_refill_wait

    def wait(h):  # the first launch reports an undrained queue
        out, n = real_wait(h)
        stores.append(h[2])
        return out, n - (len(stores) == 1)

    eng.collect_seeds_refill_wait = wait
    try:
        b = _flat(world, codes, True, monkeypatch)
    finally:
        del eng.collect_seeds_refill_wait
    assert stores == [96, 192]
    _equal(a, b)


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_refill_sam_matches_jax(world, monkeypatch, pe):
    """SAM bytes under BWA_TPU_SEED_REFILL=1 equal bwa_tpu's under it."""
    from bwa_tpu.engine import make_engine as jax_engine
    from bwa_tpu.index.fmindex import FMIndex as JaxFM
    from bwa_tpu.mem.pipeline import process_seqs as jax_process
    from bwa_tpu.mem.types import Read as JaxRead
    from bwa_tpu.options import MEM_F_PE as JPE
    from bwa_tpu.options import MemOptions as JaxOptions
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import MEM_F_PE, MemOptions

    monkeypatch.setenv("BWA_TPU_SEED_REFILL", "1")
    monkeypatch.setenv("BWA_TPU_REFILL_LANES", "16")
    monkeypatch.setenv("BWA_TPU_MESH", "off")
    if pe:
        r1, r2 = simulate_reads(world["genome"], 24, read_len=150, seed=83,
                                paired=True)
        rs = [r for pair in zip(r1, r2) for r in pair]
    else:
        rs = simulate_reads(world["genome"], 48, read_len=150, seed=81,
                            err_rate=0.02)
    sams = []
    for fm, eng, run, rd, o, flag in (
            (None, None, jax_process, JaxRead, JaxOptions, JPE),
            (world["fm"], world["eng"], process_seqs, Read, MemOptions,
             MEM_F_PE)):
        if fm is None:
            fm = JaxFM.load(world["prefix"])
            eng = jax_engine(fm, "tpu")
        opt = o()
        if pe:
            opt.flag |= flag
        reads = [rd(name=n, seq=s, qual=q) for n, s, q in rs]
        run(opt, eng, fm, reads, 0, None, None)
        sams.append("".join(r.sam for r in reads))
    assert sams[0].count("\n") >= 48
    assert sams[1] == sams[0]
