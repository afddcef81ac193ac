"""Trip-sorted bucket packing on the CPU: K8's plain version
(ops/fm.py::probe_breaks), _gather_pack, _reorder_flat, trip_order and its
gates, and trip-sorted SE and PE SAM against the JAX package's, exact."""

import os

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

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_trip_sort")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    return dict(prefix=index_build(str(d / "g.fa")), genome=g)


def _jax_engine(fm):
    """bwa_tpu's batched engine on one JAX CPU device: trip_order sorts
    nothing on a mesh (the tests' JAX sees 8 devices)."""
    from bwa_tpu.engine import make_engine

    old = os.environ.get("BWA_TPU_MESH")
    os.environ["BWA_TPU_MESH"] = "off"
    try:
        return make_engine(fm, "tpu")
    finally:
        if old is None:
            del os.environ["BWA_TPU_MESH"]
        else:
            os.environ["BWA_TPU_MESH"] = old


@pytest.fixture(scope="module")
def engines(world):
    from bwa_tpu.index.fmindex import FMIndex as JaxFM
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex

    jfm = JaxFM.load(world["prefix"])
    tfm = FMIndex.load(world["prefix"])
    return dict(jfm=jfm, jeng=_jax_engine(jfm), tfm=tfm,
                teng=make_engine(tfm, "cpu"))


def _codes(world, n, seed, read_len=150):
    """Reads from the genome (2% substitutions), a few with N runs."""
    from bwa_tpu_torch.index.pack import NT4_TABLE

    rs = simulate_reads(world["genome"], n, read_len=read_len, seed=seed,
                        err_rate=0.02)
    rng = np.random.default_rng(seed)
    out = []
    for _, s, _ in rs:
        c = NT4_TABLE[np.frombuffer(s, np.uint8)].copy()
        if rng.random() < 0.2:
            p = int(rng.integers(0, len(c) - 3))
            c[p:p + int(rng.integers(1, 4))] = 4
        out.append(c)
    return out


@pytest.mark.parametrize("L", [64, 192, 256])
def test_probe_breaks_matches_jax(world, engines, L):
    """Break counts equal bwa_tpu.ops.fm.probe_breaks on JAX CPU, count for
    count, on reads with Ns, reads shorter than the row and zero-length
    padded rows."""
    import jax.numpy as jnp

    from bwa_tpu.ops.fm import probe_breaks as jax_probe
    from bwa_tpu_torch.ops.fm import probe_breaks

    rng = np.random.default_rng(L)
    codes = _codes(world, 40, L, read_len=min(L, 150))
    q = np.full((48, L), 4, np.uint8)
    lens = np.zeros(48, np.int32)
    for i, c in enumerate(codes):
        n = int(rng.integers(L // 2, len(c) + 1)) if i % 3 else len(c)
        q[i, :n] = c[:n]
        lens[i] = n
    # rows 40..47 are padding (qlen 0, all N)
    want = np.asarray(jax_probe(engines["jeng"].idx, jnp.asarray(q),
                                jnp.asarray(lens)))
    got = probe_breaks(engines["teng"].idx, torch.from_numpy(q),
                       torch.from_numpy(lens)).numpy()
    assert got.dtype == np.int32
    assert (want[40:] == 0).all() and want[:40].sum() > 0
    np.testing.assert_array_equal(got, want)


def test_gather_pack_and_reorder_flat_match_jax():
    import jax.numpy as jnp

    from bwa_tpu.mem.batch_seed import _reorder_flat as jax_reorder
    from bwa_tpu.ops.fm import _gather_pack as jax_gather
    from bwa_tpu_torch.mem.batch_seed import _reorder_flat
    from bwa_tpu_torch.ops.fm import _gather_pack

    rng = np.random.default_rng(5)
    q_all = rng.integers(0, 5, (37, 64)).astype(np.uint8)
    pa = rng.permutation(37)[:20].astype(np.int32)
    pb = np.full(20, -1, np.int32)
    pb[:11] = rng.permutation(37)[:11]
    want = np.asarray(jax_gather(jnp.asarray(q_all), jnp.asarray(pa),
                                 jnp.asarray(pb)))
    got = _gather_pack(torch.from_numpy(q_all), torch.from_numpy(pa).long(),
                       torch.from_numpy(pb).long()).numpy()
    np.testing.assert_array_equal(got, want)

    # flat arrays of 30 reads (some seedless) in a permuted order
    B = 30
    cnt = rng.integers(0, 5, B)
    iv_off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    n = int(iv_off[-1])
    rbc = rng.integers(0, 4, n)
    rb_off = np.concatenate([[0], np.cumsum(rbc)]).astype(np.int32)
    flat = (iv_off, rng.integers(1, 9, n).astype(np.int64),
            rng.integers(0, 150, n).astype(np.int32),
            rng.integers(0, 150, n).astype(np.int32),
            rng.integers(0, 10**6, int(rb_off[-1])).astype(np.int64), rb_off)
    order = rng.permutation(B).astype(np.int64)
    for x, y in zip(_reorder_flat(flat, order), jax_reorder(flat, order)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_trip_order_matches_jax_under_force(world, engines, monkeypatch):
    from bwa_tpu.mem.batch_seed import trip_order as jax_trip
    from bwa_tpu.options import MemOptions as JaxOptions
    from bwa_tpu_torch.mem.batch_seed import trip_order
    from bwa_tpu_torch.options import MemOptions

    monkeypatch.setenv("BWA_TPU_TRIP_SORT", "force")
    codes = _codes(world, 160, 3)
    want = jax_trip(JaxOptions(), engines["jeng"], codes)
    got, qdev = trip_order(MemOptions(), engines["teng"], codes)
    assert want is not None and sorted(want.tolist()) == list(range(160))
    np.testing.assert_array_equal(got, want)
    assert tuple(qdev.shape) == (160, 192)
    for i in (0, 77, 159):
        np.testing.assert_array_equal(qdev[i, :len(codes[i])].numpy(),
                                      codes[i])


class _Stub:
    """An engine whose probe predicts fixed trips (no K1, no K8)."""

    mesh = None

    def __init__(self, l_pac, pred):
        self.fm = type("FM", (), {"l_pac": l_pac})()
        self.pred = pred

    def probe_trips(self, codes_list):
        return self.pred[:len(codes_list)], None


class _JaxStub(_Stub):
    """The same stub for bwa_tpu, whose probe returns the predictions
    alone."""

    def probe_trips(self, codes_list):
        return self.pred[:len(codes_list)]


@pytest.mark.parametrize("mode,B,read_len,l_pac,on", [
    ("off", 5000, 150, 3_000_000_000, False),
    ("auto", 4095, 150, 3_000_000_000, False),
    ("auto", 4096, 150, 199_999_999, False),
    ("auto", 4096, 150, 200_000_000, True),
    ("force", 300, 257, 3_000_000_000, False),
    ("force", 300, 150, 1, True),
    ("auto", 30_000, 100, 200_000_000, True),  # the round-robin deal
], ids=["off", "auto-small", "auto-199999999", "auto-200000000",
        "force-L320", "force-small", "auto-deal"])
def test_trip_order_gates(monkeypatch, mode, B, read_len, l_pac, on):
    """The gates of BWA_TPU_TRIP_SORT, on a stub engine with fixed
    predictions; where the route is on, the permutation is bwa_tpu's."""
    from bwa_tpu.mem.batch_seed import trip_order as jax_trip
    from bwa_tpu_torch.mem.batch_seed import trip_order

    monkeypatch.setenv("BWA_TPU_TRIP_SORT", mode)
    rng = np.random.default_rng(B)
    pred = rng.integers(0, 30, B).astype(np.int32)
    codes = [np.zeros(read_len, np.uint8)] * B
    got, _ = trip_order(None, _Stub(l_pac, pred), codes)
    want = jax_trip(None, _JaxStub(l_pac, pred), codes)
    if not on:
        assert got is None and want is None
        return
    assert sorted(got.tolist()) == list(range(B))
    np.testing.assert_array_equal(got, want)


def test_collect_se_flat_order_matches(world, engines, monkeypatch):
    """collect_se_flat(order=) (seeding in trip order, gathered lanes)
    equals the unsorted arrays and bwa_tpu's sorted ones."""
    from bwa_tpu.mem.batch_seed import collect_se_flat as jax_flat
    from bwa_tpu.mem.batch_seed import trip_order as jax_trip
    from bwa_tpu.options import MemOptions as JaxOptions
    from bwa_tpu_torch.mem.batch_seed import collect_se_flat, trip_order
    from bwa_tpu_torch.options import MemOptions

    monkeypatch.setenv("BWA_TPU_TRIP_SORT", "force")
    codes = _codes(world, 160, 9)
    eng, fm = engines["teng"], engines["tfm"]
    gathered = []
    real = eng.collect_seeds_dispatch_gather
    eng.collect_seeds_dispatch_gather = \
        lambda *a, **k: gathered.append(1) or real(*a, **k)
    try:
        opt = MemOptions()
        plain = collect_se_flat(opt, eng, fm, codes)
        order, qdev = trip_order(opt, eng, codes)
        got = collect_se_flat(opt, eng, fm, codes, order=order, qdev=qdev)
    finally:
        del eng.collect_seeds_dispatch_gather
    assert gathered == [1]
    jopt = JaxOptions()
    want = jax_flat(jopt, engines["jeng"], engines["jfm"], codes,
                    order=jax_trip(jopt, engines["jeng"], codes))
    for x, y, z in zip(got, plain, want):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def _sams(world, rs, pe, teng_hook=None):
    """(bwa_tpu's SAM, the port's SAM) of reads rs through process_seqs."""
    from bwa_tpu.index.fmindex import FMIndex as JaxFM
    from bwa_tpu.mem.pipeline import process_seqs as jax_process
    from bwa_tpu.mem.types import Read as JaxRead
    from bwa_tpu.options import MEM_F_PE as JPE
    from bwa_tpu.options import MemOptions as JaxOptions
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import MEM_F_PE, MemOptions

    out = []
    for fm_cls, mk, run, rd, o, pe_flag, dev in (
            (JaxFM, lambda fm, _: _jax_engine(fm), jax_process, JaxRead,
             JaxOptions, JPE, "tpu"),
            (FMIndex, make_engine, process_seqs, Read, MemOptions, MEM_F_PE,
             "cpu")):
        fm = fm_cls.load(world["prefix"])
        eng = mk(fm, dev)
        if dev == "cpu" and teng_hook is not None:
            teng_hook(eng)
        opt = o()
        if pe:
            opt.flag |= pe_flag
        reads = [rd(name=n, seq=s, qual=q) for n, s, q in rs]
        run(opt, eng, fm, reads, 0, None, None)
        out.append("".join(r.sam for r in reads))
    return out


def _overflow_gathered(calls):
    """Engine hook: the gathered bucket reports overflow, so it rebuilds
    its host lanes and climbs the ladder (the caps land in calls)."""
    def hook(eng):
        real_wait = eng.collect_seeds_wait
        real_gather = eng.collect_seeds_dispatch_gather
        real_collect = eng.collect_seeds
        gathered = set()

        def gather(*a, **k):
            h = real_gather(*a, **k)
            gathered.add(id(h))
            return h

        def wait(h):
            out = real_wait(h)
            if id(h) in gathered:
                calls.append(("gather", h[2]))
                out = out[:5] + (out[5] * 0 + h[2] + 1,) + out[6:]
            return out

        def collect(q, lens, opt, cs, **k):
            calls.append(("ladder", cs, q.shape[1]))
            return real_collect(q, lens, opt, cs, **k)

        eng.collect_seeds_dispatch_gather = gather
        eng.collect_seeds_wait = wait
        eng.collect_seeds = collect
    return hook


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_trip_sorted_sam_matches_jax(world, monkeypatch, pe):
    """SE and PE SAM bytes under BWA_TPU_TRIP_SORT=force equal bwa_tpu's
    under force, the port's gathered bucket forced to overflow: it builds
    its host lanes (2 x 193 columns) and climbs the ladder."""
    monkeypatch.setenv("BWA_TPU_TRIP_SORT", "force")
    if pe:
        r1, r2 = simulate_reads(world["genome"], 80, read_len=150, seed=71,
                                paired=True)
        rs = [r for pair in zip(r1, r2) for r in pair]
    else:
        rs = simulate_reads(world["genome"], 160, read_len=150, seed=73,
                            err_rate=0.02)
    calls = []
    want, got = _sams(world, rs, pe, _overflow_gathered(calls))
    assert calls == [("gather", 48), ("ladder", 192, 386)]
    assert want.count("\n") >= 160
    assert got == want
