"""The SA lookup's three routes on the CPU: the dense sidecar, a walker on a
device (`card`: ops/fm.py DeviceSA, K9, on a CUDA engine; K9's plain
version here) and the host's native walk (bsw2.cpp fm_sa_batch).  A light
index holds the sampled SA, and K9's plain version reads the fused occtab
there; positions and walk steps equal the native walk's, rank for rank.
No JAX."""

from pathlib import Path

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 150 kb genome's index with its dense sidecar (`dense`) and the
    same index without it (`walk`), and 48 simulated 150 bp reads."""
    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE

    d = tmp_path_factory.mktemp("torch_sa_route")
    g = random_genome(150_000, seed=17, n_contigs=2)
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    dense = FMIndex.load(prefix)
    assert dense.sad is not None
    Path(prefix + ".sad.npy").unlink()
    walk = FMIndex.load(prefix)
    assert walk.sad is None
    codes = [NT4_TABLE[np.frombuffer(s, np.uint8)]
             for _, s, _ in simulate_reads(g, 48, read_len=150, seed=19,
                                           err_rate=0.02)]
    return dict(dense=dense, walk=walk, codes=codes)


def _ranks(fm, n=3000, seed=0):
    """Random ranks, rank 0 (the -1 poison), the $ row and its neighbours,
    the last rows, and ranks beside multiples of 32 (walks of 0, 1 and 31
    steps)."""
    rng = np.random.default_rng(seed)
    m32 = 32 * rng.integers(1, fm.seq_len // 32, 60)
    ks = np.concatenate([rng.integers(0, fm.seq_len + 1, n),
                         [0, 1, 31, 32, 33, fm.primary - 1, fm.primary,
                          fm.primary + 1, fm.seq_len - 1, fm.seq_len],
                         m32 - 1, m32, m32 + 1])
    return np.clip(ks, 0, fm.seq_len).astype(np.int64)


def _traced(fn):
    """fn()'s result and the one sa_lookup span it made."""
    from bwa_tpu_torch import tracing

    tracing.drain()
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.enable(False)
    (sp,) = [s for s in tracing.drain() if s.name == "sa_lookup"]
    return out, sp


def _plain_card(tt):
    """A walker on a device as DeviceSA is one, on K9's plain version."""
    from bwa_tpu_torch.ops.fm import sa_batch_plain

    def card(ranks):
        work = torch.zeros(2, dtype=torch.int64)
        pos = sa_batch_plain(tt, torch.from_numpy(ranks), work=work)
        return pos.numpy().astype(np.int64), int(work[0])
    return card


def _tree(fm, R, coords, light=True):
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex

    tt = DeviceFMIndex(fm, light=light, occ_r=R, device="cpu").tree()
    if coords == "int64":
        tt = dict(tt, cdt=torch.int64, L2=tt["L2"].long(),
                  ckpt=tt["ckpt"].long(), ssa=tt["ssa"].long())
    return tt


@pytest.mark.parametrize("R", [1, 4])
def test_light_index_holds_the_sampled_sa(world, R):
    """A light index uploads the sampled SA beside the occtab, a one-row
    stub of ckpt and words and no packed reference; K9 reads its occtab,
    and a full index's ckpt and words."""
    from bwa_tpu_torch.ops.fm import sa_form

    fm = world["walk"]
    tt = _tree(fm, R, "int32")
    assert set(tt) >= {"ssa", "occtab"} and "pac" not in tt
    assert tt["ckpt"].shape[0] == tt["words"].shape[0] == 1
    assert tt["occtab"].shape[1] == 4 + 8 * R
    np.testing.assert_array_equal(tt["ssa"].numpy(), fm.ssa)
    assert tt["ssa"].dtype == torch.int32
    assert sa_form(tt) == "occtab"
    full = _tree(fm, R, "int32", light=False)
    assert "pac" in full and sa_form(full) == "ckpt"
    with pytest.raises(ValueError, match="occtab"):
        sa_form({k: v for k, v in tt.items() if k != "occtab"})


@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("R", [1, 4])
def test_occtab_walk_matches_native(world, R, coords):
    """K9's plain version on a light index (the occtab read) against the
    native walk: every position equal, the steps in work[0] equal to
    fm_sa_batch's, work[1] the longest walk."""
    from bwa_tpu_torch.ops.fm import sa_batch, sa_batch_plain

    fm = world["walk"]
    ks = _ranks(fm, seed=R)
    want, sp = _traced(lambda: fm.sa_lookup(ks))
    tt = _tree(fm, R, coords)
    work = torch.zeros(2, dtype=torch.int64)
    got = sa_batch_plain(tt, torch.from_numpy(ks), work=work)
    assert got.dtype == tt["cdt"]
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert want[ks == 0].tolist() == [-1]
    assert int(work[0]) == sp.counters["walk_steps"] > len(ks)
    assert 31 <= int(work[1]) <= int(work[0])
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        sa_batch(tt, torch.from_numpy(ks)).numpy().astype(np.int64), want)


def test_occ1_and_b0_read_the_occtab(world):
    """_occ1 and _B0 give the same counts and bases from the occtab (R = 1
    and 4) as from ckpt and words."""
    from bwa_tpu_torch.ops.fm import _B0, _occ1

    fm = world["walk"]
    full = _tree(fm, 1, "int32", light=False)
    words = {k: v for k, v in full.items() if k != "occtab"}
    rng = np.random.default_rng(3)
    k = torch.from_numpy(np.concatenate([
        rng.integers(0, fm.seq_len, 500),
        [0, fm.primary, fm.seq_len - 1, 127, 128, 511, 512]]))
    c = torch.from_numpy(rng.integers(0, 4, k.shape[0]))
    x = k - (k > fm.primary).long()
    want_occ, want_b0 = _occ1(words, k, c), _B0(words, x)
    for R in (1, 4):
        tt = _tree(fm, R, "int32")
        assert torch.equal(_occ1(tt, k, c), want_occ)
        assert torch.equal(_B0(tt, x), want_b0)


def test_card_route_counts_device_ranks(world):
    """FMIndex.sa_lookup with a walker on a device (K9's plain version on
    a light R = 4 tree): the native walk's positions and steps, every rank
    counted in device_ranks; an empty lookup calls no walker."""
    def refuse(ranks):
        raise AssertionError("a walker ran on no ranks")

    fm = world["walk"]
    ks = _ranks(fm, seed=5)
    want, sp_host = _traced(lambda: fm.sa_lookup(ks))
    card = _plain_card(_tree(fm, 4, "int32"))
    got, sp = _traced(lambda: fm.sa_lookup(ks, card=card))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    assert sp_host.counters == {"ranks": len(ks), "device_ranks": 0,
                                "walk_steps": sp.counters["walk_steps"]}
    assert sp.counters == {"ranks": len(ks), "device_ranks": len(ks),
                           "walk_steps": sp_host.counters["walk_steps"]}
    empty, sp0 = _traced(lambda: fm.sa_lookup(ks[:0], card=refuse))
    assert empty.shape == (0,) and sp0.counters == {
        "ranks": 0, "walk_steps": 0, "device_ranks": 0}


def test_sidecar_and_cpu_engine_routes(world):
    """With the dense sidecar no walker runs (device_ranks and walk_steps
    0); a CPU engine has no walker on a device, so its sa_many and the
    demux's lookup take the native walk (device_ranks 0); neither
    launches K9."""
    from bwa_tpu_torch.mem.batch_seed import _sa_route
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.ops.fm import BatchedFMEngine

    def refuse(ranks):
        raise AssertionError("the sidecar route ran a walker")

    n0 = fm_ops.sa_launches
    dense, fm = world["dense"], world["walk"]
    ks = _ranks(fm, seed=7)
    ks = ks[ks < fm.seq_len]
    want, sp_walk = _traced(lambda: fm.sa_lookup(ks))
    got, sp = _traced(lambda: dense.sa_lookup(ks, card=refuse))
    np.testing.assert_array_equal(got, want)
    assert sp.counters == {"ranks": len(ks), "walk_steps": 0,
                           "device_ranks": 0}
    for f in (dense, fm):
        eng = BatchedFMEngine(f, device="cpu")
        assert eng.sa_card is None
        assert _sa_route(eng, f).keywords == {"card": None}
    eng = BatchedFMEngine(fm, device="cpu")
    got, sp = _traced(lambda: eng.sa_many(ks))
    np.testing.assert_array_equal(got, want)
    assert sp.counters == sp_walk.counters
    assert sp.counters["device_ranks"] == 0
    assert fm_ops.sa_launches == n0  # no K9 launch on either route


def test_demux_on_the_card_route(world):
    """collect_se_flat with a walker on a device as the engine's sa_card
    (K9's plain version over a light R = 4 index) gives the flat arrays of
    the native walk's route; each bucket's lookup counts its ranks in
    device_ranks."""
    from bwa_tpu_torch import tracing
    from bwa_tpu_torch.mem.batch_seed import collect_se_flat
    from bwa_tpu_torch.ops.fm import BatchedFMEngine
    from bwa_tpu_torch.options import MemOptions

    fm, opt = world["walk"], MemOptions()
    eng = BatchedFMEngine(fm, device="cpu")
    want = collect_se_flat(opt, eng, fm, world["codes"])
    eng.sa_card = _plain_card(_tree(fm, 4, "int32"))
    tracing.drain()
    tracing.enable()
    try:
        got = collect_se_flat(opt, eng, fm, world["codes"])
    finally:
        tracing.enable(False)
    spans = [s for s in tracing.drain() if s.name == "sa_lookup"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert spans and all(s.counters["device_ranks"] == s.counters["ranks"]
                         for s in spans)
    assert sum(s.counters["ranks"] for s in spans) == len(want[4]) > 0
