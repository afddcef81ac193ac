"""The hand-written kernels against their plain PyTorch versions on a CUDA
card: K1 (csrc/seed_machine.cu, its refill mode and its state mode, K12
and K13, too), K8 (the same source), K2 (csrc/ksw_band.cu, gather and
host-array modes), K5 (csrc/ksw_full.cu), K7/K7w (csrc/gap_machine.cu) and
K9, K10a, K10b, K11 (csrc/smem_batch.cu), exactly.  This file imports no
JAX, so it runs on a card machine without it:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Without a card every test here skips."""

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world(tmp_path_factory, card):
    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE

    d = tmp_path_factory.mktemp("torch_cuda")
    g = random_genome(150_000, seed=41, n_contigs=2)
    write_fasta(d / "g.fa", g)
    fm = FMIndex.load(index_build(str(d / "g.fa")))
    codes = lambda rs: [NT4_TABLE[np.frombuffer(s, np.uint8)]  # noqa: E731
                        for _, s, _ in rs]
    return dict(fm=fm, short=codes(simulate_reads(g, 64, read_len=150,
                                                  seed=5, err_rate=0.02)),
                long=codes(simulate_reads(g, 4, read_len=600, seed=6,
                                          err_rate=0.05, indel_rate=0.01)))


def _lanes(world, kind):
    from bwa_tpu_torch.mem.batch_seed import _pack_bucket
    from bwa_tpu_torch.options import MemOptions

    if kind == "pack2":
        L, codes = 192, world["short"]
        B2 = len(codes) // 2
        q = np.full((B2, 2 * (L + 1)), 4, np.uint8)
        ql = np.zeros(B2, np.int32)
        for r in range(2):
            for i in range(B2):
                c = codes[r * B2 + i]
                q[i, r * (L + 1):r * (L + 1) + len(c)] = c
                ql[i] = r * (L + 1) + len(c)
        return q, ql, None
    opt = MemOptions()
    opt.apply_mode("pacbio")
    q, ql, _, _, _, _, shard, ns = _pack_bucket(opt, world["long"], 64)
    n = len(world["long"]) * ns
    return q[:n], ql[:n], tuple(a[:n] for a in shard)


def _k1_vs_plain(tt, q, ql, shard, consts, cap, cap_s, use_p3):
    """K1 and the plain version on the same device tensors: seeds after
    sort_seeds, seed_n, ovf, done_step and steps, each equal; returns K1's
    overflow flags."""
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    qd = torch.from_numpy(q).cuda()
    qld = torch.from_numpy(ql).cuda()
    nv = _next_valid_device(qd, qld)
    n0 = fmm.launches
    outs = []
    for fn in (fmm.seed_machine, fmm.seed_machine_plain):
        s, n, st, o, ds = fn(tt, qd, qld, nv, *consts, cap=cap, cap_s=cap_s,
                             use_p3=use_p3, shard=shard)
        outs.append((fmm.sort_seeds(s, n, key64=False), n, o, ds,
                     torch.tensor([int(st)])))
    torch.cuda.synchronize()
    assert fmm.launches == n0 + 1
    assert outs[0][0].dtype == tt["cdt"]
    for g, w, name in zip(*outs, ("seeds", "seed_n", "ovf", "done_step",
                                  "steps")):
        assert torch.equal(g.cpu(), w.cpu()), name
    return outs[0][2].cpu()


def _tree(fm, coords, occ_r=None):
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex

    tt = DeviceFMIndex(fm, device="cuda", occ_r=occ_r).tree()
    if coords == "int64":  # the 2*l_pac+2 >= 2^31 code path
        tt = dict(tt, cdt=torch.int64, L2=tt["L2"].long())
    return tt


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind,cap,cap_s,use_p3", [
    ("pack2", 16, 48, True), ("pack2", 2, 6, True), ("pack2", 16, 48, False),
    ("shard", 16, 96, True), ("shard", 3, 8, True), ("shard", 2, 8, True)])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k1_matches_plain(world, kind, cap, cap_s, use_p3, coords):
    """Occtab R = 1 (8 text words a row); 600 bp reads at cap 2 and 3 push
    rows longer than the stack."""
    q, ql, shard = _lanes(world, kind)
    consts = (17, 170, 10, 20) if shard else (19, 28, 10, 20)
    ovf = _k1_vs_plain(_tree(world["fm"], coords), q, ql, shard, consts, cap,
                       cap_s, use_p3)
    if cap <= 3:
        assert bool(ovf.any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind,cap,cap_s", [
    ("pack2", 16, 48), ("pack2", 2, 6), ("shard", 16, 96), ("shard", 2, 8)])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k1_occtab_r4_matches_plain(world, kind, cap, cap_s, coords):
    """The production occtab layout, R = 4 (32 text words a row: groups of
    8 threads a lookup), on the same genome."""
    q, ql, shard = _lanes(world, kind)
    consts = (17, 170, 10, 20) if shard else (19, 28, 10, 20)
    _k1_vs_plain(_tree(world["fm"], coords, occ_r=4), q, ql, shard, consts,
                 cap, cap_s, True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind,cap_s", [("fastmap", 64), ("fastmap", 192),
                                        ("primary5", 96)])
@pytest.mark.parametrize("occ_r", [1, 4])
def test_k1_one_read_lanes_match_plain(world, kind, cap_s, occ_r):
    """One read a lane (collect_intv_batch's and fastmap's layout,
    batch_seed._pad_reads) and one empty lane.  fastmap's parameters:
    min_seed_len 1 keeps every SMEM, split_len int(2^30 + 0.499) =
    1,073,741,824 reaches K1 as an int32, split_width 0 and max_mem_intv 0
    turn passes 2 and 3 off; -5 runs mem's defaults at cap_s 96."""
    from bwa_tpu_torch.mem.batch_seed import _pad_reads

    q, ql, L = _pad_reads(world["short"] + [np.zeros(0, np.uint8)])
    assert q.shape == (65, 192) and ql[-1] == 0
    consts = (1, 1 << 30, 0, 0) if kind == "fastmap" else (19, 28, 10, 20)
    _k1_vs_plain(_tree(world["fm"], "int32", occ_r=occ_r), q, ql, None,
                 consts, min(16, L + 2), cap_s, kind == "primary5")


# tandem arrays in the repeat genome: (start, unit, copies)
ARRAYS = ((20_000, b"AC", 60), (60_000, b"AGT", 45), (100_000, b"A", 40))


@pytest.fixture(scope="module")
def repeat_world(tmp_path_factory, card):
    """A 150 kb genome with three tandem arrays, and lanes of one read each:
    all N, empty, reads starting in or before an array (a forward pass
    through an array changes the interval at almost every base, so rows
    reach 33-64 entries and beyond) and four plain reads."""
    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE

    name, seq = random_genome(150_000, seed=43, n_contigs=1,
                              with_ns=False)[0]
    seq = bytearray(seq)
    for s, unit, n in ARRAYS:
        seq[s:s + len(unit) * n] = unit * n
    d = tmp_path_factory.mktemp("torch_cuda_repeats")
    write_fasta(d / "g.fa", [(name, bytes(seq))])
    fm = FMIndex.load(index_build(str(d / "g.fa")))
    codes = NT4_TABLE[np.frombuffer(bytes(seq), np.uint8)]
    rows = [np.full(200, 4, np.uint8), np.zeros(0, np.uint8)]
    for s, unit, n in ARRAYS:
        span = len(unit) * n
        for m in (30, 45, 60, span):
            for f in (0, 30):
                rows.append(codes[s - f:s + min(m, span) + 30])
    rng = np.random.default_rng(3)
    for _ in range(4):
        p = int(rng.integers(0, 149_000))
        rows.append(codes[p:p + 150])
    q = np.full((len(rows), 256), 4, np.uint8)
    ql = np.zeros(len(rows), np.int32)
    for k, r in enumerate(rows):
        q[k, :len(r)] = r
        ql[k] = len(r)
    return fm, q, ql


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", [64, 32, 2])
@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k1_edge_lanes_match_plain(repeat_world, cap, occ_r, coords):
    """An all-N lane, an empty lane and tandem-repeat reads whose backward
    rows are longer than a warp (lane 2, 60 bases of (AC)n, overflows a
    stack of 32 but not one of 64) or than the stack."""
    fm, q, ql = repeat_world
    ovf = _k1_vs_plain(_tree(fm, coords, occ_r), q, ql, None,
                       (19, 28, 10, 20), cap, 64, True)
    assert bool(ovf[2]) == (cap < 64)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("what", ["stack_past_shared_memory", "occtab_r2"])
def test_k1_raises_and_launches_nothing(world, what):
    """Stacks of cap 4096 need 512 KB of shared memory a block, and an
    occtab of R = 2 is a layout K1 does not take: both raise on the card,
    nothing falls back to the plain version, and a launch after them runs."""
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    q, ql, _ = _lanes(world, "pack2")
    tt = _tree(world["fm"], "int32", occ_r=2 if what == "occtab_r2" else 1)
    cap = 4096 if what == "stack_past_shared_memory" else 16
    qd = torch.from_numpy(q).cuda()
    qld = torch.from_numpy(ql).cuda()
    nv = _next_valid_device(qd, qld)
    n0 = fmm.launches
    with pytest.raises((RuntimeError, ValueError)):
        fmm.seed_machine(tt, qd, qld, nv, 19, 28, 10, 20, cap=cap, cap_s=48,
                         use_p3=True)
    assert fmm.launches == n0
    _k1_vs_plain(_tree(world["fm"], "int32"), q[:8], ql[:8], None,
                 (19, 28, 10, 20), 16, 48, True)


def _probe_rows(world):
    """Reads for K8: the 64 simulated reads, every fifth with an N, and
    an empty row."""
    from bwa_tpu_torch.mem.batch_seed import _pad_reads

    rng = np.random.default_rng(9)
    codes = [c.copy() for c in world["short"]]
    for c in codes[::5]:
        c[int(rng.integers(0, len(c)))] = 4
    q, ql, L = _pad_reads(codes + [np.zeros(0, np.uint8)])
    return q, ql


@pytest.mark.requires_cuda
@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k8_matches_plain(world, repeat_world, occ_r, coords):
    """K8 (probe_breaks) against its plain version on the same device
    tensors, count for count: simulated reads with Ns and an empty row on
    one genome, the tandem-array lanes on the other; one launch each."""
    from bwa_tpu_torch.ops import fm as fm_ops

    rfm, rq, rql = repeat_world
    q, ql = _probe_rows(world)
    for fm, qq, qql in ((world["fm"], q, ql), (rfm, rq, rql)):
        tt = _tree(fm, coords, occ_r)
        qd = torch.from_numpy(qq).cuda()
        n0 = fm_ops.probe_launches
        got = fm_ops.probe_breaks(tt, qd, torch.from_numpy(qql).cuda())
        want = fm_ops.probe_breaks_plain(tt, qd)
        torch.cuda.synchronize()
        assert fm_ops.probe_launches == n0 + 1
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want.cpu())
    # the simulated reads' errors break intervals (the repeat genome's
    # reads are exact copies)
    assert int(fm_ops.probe_breaks_plain(_tree(world["fm"], coords, occ_r),
                                         torch.from_numpy(q).cuda()).sum())


def _refill_rows(out):
    """A refill launch's seed rows of every read in a lane whose store did
    not overflow, sorted as _demux_refill sorts them (sort_seeds in each
    lane, then stably by read, start, end), and the reads drawn."""
    from bwa_tpu_torch.ops import fm_machine as fmm

    s = fmm.sort_seeds(out[0], out[1], False).cpu().numpy()
    sn = out[1].cpu().numpy().astype(np.int64)
    sn[sn > s.shape[1]] = 0
    rows = s[np.arange(s.shape[1])[None, :] < sn[:, None]]
    return rows[np.lexsort((rows[:, 4], rows[:, 3], rows[:, 5]))], \
        int(out[5])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lanes,cap_s", [(8, 240), (128, 96), (4, 26)])
@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("group", [False, True])
def test_k1_refill_matches_plain(world, lanes, cap_s, occ_r, coords, group):
    """K1's refill mode, a warp a lane and its group form, against its plain
    version: 8 lanes recycle through 65 reads, 128 lanes start with every
    read, and at cap_s 26 the lanes fill (each stops drawing), so only the
    reads drawn are compared, as the same set.  Each read's seeds, in
    _demux_refill's order, equal."""
    from bwa_tpu_torch.mem.batch_seed import _pad_reads
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _refill_table

    q, ql, _ = _pad_reads(world["short"] + [np.zeros(0, np.uint8)])
    table = _refill_table(torch.from_numpy(q).cuda(),
                          torch.from_numpy(ql).cuda())
    tt = _tree(world["fm"], coords, occ_r)
    n0, g0 = fmm.refill_launches, fmm.refill_group_launches
    outs = [fmm.seed_machine_refill(tt, table, lanes, 19, 28, 10, 20, cap=16,
                                    cap_s=cap_s, use_p3=True, cap_r=24,
                                    group=group),
            fmm.seed_machine_refill_plain(tt, table, lanes, 19, 28, 10, 20,
                                          cap=16, cap_s=cap_s, use_p3=True,
                                          cap_r=24)]
    torch.cuda.synchronize()
    assert fmm.refill_launches == n0 + 1
    assert fmm.refill_group_launches == g0 + int(group)
    assert outs[0][0].dtype == tt["cdt"] and outs[0][0].shape[2] == 6
    (g, gn), (w, wn) = (_refill_rows(o) for o in outs)
    if cap_s >= 96:
        assert min(gn, wn) >= 65 and len(w) > 0
        np.testing.assert_array_equal(g, w)
    else:  # which reads were drawn follows the lanes' finishing order
        assert wn < 65 and gn < 65
        drawn = set(g[:, 5].tolist()) & set(w[:, 5].tolist())
        assert drawn
        keep = lambda r: r[np.isin(r[:, 5], list(drawn))]  # noqa: E731
        np.testing.assert_array_equal(keep(g), keep(w))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k8_byte_rows_match_plain(world, occ_r, coords):
    """K8's codes a byte at a time: rows of 150 codes (not a multiple of
    16) and the same rows one byte off 16-byte alignment, qlen < L where an
    N run ends a read early; equal to the plain version, one launch each."""
    from bwa_tpu_torch.ops import fm as fm_ops

    q, ql = _probe_rows(world)
    q = q[:, :150].copy()
    ql = np.minimum(ql, 150)
    for r in range(0, len(q) - 1, 7):  # reads cut short: pads past qlen
        ql[r] = min(ql[r], 120)
        q[r, ql[r]:] = 4
    tt = _tree(world["fm"], coords, occ_r)
    buf = torch.zeros(q.size + 1, dtype=torch.uint8, device="cuda")
    buf[1:] = torch.from_numpy(q.reshape(-1)).cuda()
    for qd in (torch.from_numpy(q).cuda(), buf[1:].view(q.shape)):
        n0 = fm_ops.probe_launches
        got = fm_ops.probe_breaks(tt, qd, torch.from_numpy(ql).cuda())
        want = fm_ops.probe_breaks_plain(tt, qd)
        torch.cuda.synchronize()
        assert fm_ops.probe_launches == n0 + 1
        assert torch.equal(got.cpu(), want.cpu())
        assert int(want.sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap,L", [(2, 192), (3, 150), (16, 150)])
@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("group", [False, True])
def test_k1_refill_overflow_matches_plain(world, cap, L, coords, group):
    """The refill mode at R = 4, both forms, with stacks of 2 and 3 (rows
    longer than the stack) and reads of 150 codes (staged a byte at a
    time): on 128 lanes, more lanes than the 65 reads, lane b seeds read b
    alone, so every lane's seeds, seed_n and overflow flag equal the plain
    version's; on 40 lanes with stacks of 16 (no overflow) each read's
    seeds, in _demux_refill's order, equal."""
    from bwa_tpu_torch.mem.batch_seed import _pad_reads
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _refill_table

    q, ql, _ = _pad_reads(world["short"] + [np.zeros(0, np.uint8)])
    q = np.ascontiguousarray(q[:, :L])
    table = _refill_table(torch.from_numpy(q).cuda(),
                          torch.from_numpy(ql).cuda())
    tt = _tree(world["fm"], coords, 4)
    lanes = 128 if cap < 16 else 40
    kw = dict(cap=cap, cap_s=96, use_p3=True, cap_r=24)
    got = fmm.seed_machine_refill(tt, table, lanes, 19, 28, 10, 20, **kw,
                                  group=group)
    want = fmm.seed_machine_refill_plain(tt, table, lanes, 19, 28, 10, 20,
                                         **kw)
    torch.cuda.synchronize()
    if cap < 16:
        assert bool(want[3].any())
        for i in (1, 3, 4):  # seed_n, ovf, done_step
            assert torch.equal(got[i].cpu(), want[i].cpu()), i
        assert int(got[2]) == int(want[2])
        assert torch.equal(fmm.sort_seeds(got[0], got[1], False).cpu(),
                           fmm.sort_seeds(want[0], want[1], False).cpu())
    else:
        assert not bool(want[3].any()) and not bool(got[3].any())
        (g, gn), (w, wn) = (_refill_rows(o) for o in (got, want))
        assert min(gn, wn) >= 65 and len(w) > 0
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def jobs(card):
    """mem_chain2aln job rows over a random reference, with seeds placed
    off the read's diagonal so the band-doubling retry runs."""
    from bwa_tpu_torch.index.pack import pack_codes

    rng = np.random.default_rng(17)
    l_pac = 6000
    ref = rng.integers(0, 4, l_pac).astype(np.uint8)
    pac = np.zeros(l_pac // 4 + 1, np.uint8)
    pac[:(l_pac + 3) // 4] = pack_codes(ref)[:(l_pac + 3) // 4]
    two = np.concatenate([ref, 3 - ref[::-1]])
    qflat, meta, pos = [], [], 0
    for r in range(10):
        s = int(rng.integers(0, 2 * l_pac - 800))
        lo, hi = (0, l_pac) if s < l_pac else (l_pac, 2 * l_pac)
        s = min(s, hi - 700)
        q = two[s:s + 600].copy()
        m = rng.random(600) < 0.05
        q[m] = rng.integers(0, 4, int(m.sum()))
        ln = len(q)
        qflat.append(q)
        for k in range(3):
            qbeg = int(rng.integers(1, ln - 60)) if k else 0
            slen = int(rng.integers(15, 40))
            rbeg = min(s + qbeg + (90 if k == 2 else 0), hi - slen - 1)
            meta.append([pos, ln, qbeg, slen, rbeg,
                         max(lo, rbeg - qbeg - 150),
                         min(hi, rbeg + (ln - qbeg) + 150),
                         int(rng.integers(slen, 3 * slen))])
        pos += ln
    return pac, l_pac, np.concatenate(qflat), np.array(meta, np.int64)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("zdrop", [100, 20])
def test_k2_fused_matches_plain(jobs, zdrop):
    from bwa_tpu_torch.ops import ksw_band
    from bwa_tpu_torch.ops.ext_gather import ExtGatherEngine
    from bwa_tpu_torch.options import MemOptions

    pac, l_pac, qflat, meta = jobs
    opt = MemOptions()
    opt.apply_mode("pacbio")
    opt.zdrop = zdrop
    outs = []
    for dev in ("cuda", "cpu"):
        e = ExtGatherEngine(pac, l_pac, np.int32, device=dev)
        e.set_reads(qflat)
        n0 = ksw_band.launches
        outs.append(e.run_fused(meta, opt))
        if dev == "cuda":
            assert ksw_band.launches == n0 + 4
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0][:, 5] == 2 * opt.w).any()  # the P = 512 retry ran


@pytest.mark.requires_cuda
@pytest.mark.parametrize("w", [100, 200, 500, 600])
def test_k2_single_pass_matches_plain(jobs, w):
    from bwa_tpu_torch.ops.ext_gather import ExtGatherEngine, band_clamp
    from bwa_tpu_torch.options import MemOptions

    pac, l_pac, qflat, meta = jobs
    opt = MemOptions()
    opt.apply_mode("pacbio")
    n = len(meta)
    qe = meta[:, 2] + meta[:, 3]
    qlen = meta[:, 1] - qe
    args = (meta[:, 0] + qe, np.ones(n), qlen, meta[:, 4] + meta[:, 3],
            np.ones(n), meta[:, 6] - (meta[:, 4] + meta[:, 3]),
            band_clamp(qlen, np.full(n, w), 1, 1, 1, 1, 1, 5), meta[:, 7])
    rest = (opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    outs = []
    for dev in ("cuda", "cpu"):
        e = ExtGatherEngine(pac, l_pac, np.int32, device=dev)
        e.set_reads(qflat)
        outs.append(e.run(*args, *rest))
    np.testing.assert_array_equal(outs[0], outs[1])


def _k2_problems(seed, n, P, kind, l_pac=20_000):
    """n extension problems over a random reference of l_pac bases (with
    kind "repeats", a tandem repeat of a 3-base unit over its middle half,
    where most rows tie for their max): targets read from either half of
    the doubled genome in either direction, queries mutated copies of the
    target (5% substitutions, one indel) stored forwards or backwards in
    a flat read array.  Every fifth problem is dead (tlen 0), h0 is 0 on
    every fourth, bands run from 1 to W with W itself on every third, and
    queries run from 0 bases up to several times W, so many are shorter
    than W.  Returns (pac, qflat, coordinate columns, code rows)."""
    from bwa_tpu_torch.index.pack import pack_codes

    rng = np.random.default_rng(seed)
    W = P // 2 - 1
    ref = rng.integers(0, 4, l_pac).astype(np.uint8)
    if kind == "repeats":
        ref[l_pac // 4:3 * l_pac // 4] = np.resize(rng.integers(0, 4, 3),
                                                   l_pac // 2)
    two = np.concatenate([ref, 3 - ref[::-1]])
    cols = {k: np.zeros(n, np.int64) for k in
            ("qbase", "qdir", "qlen", "tbase", "tdir", "tlen", "w", "h0")}
    qflat, trows, qrows, pos = [], [], [], 0
    for k in range(n):
        tl = 0 if k % 5 == 4 else int(rng.integers(40, 700))
        td = 1 if rng.random() < 0.5 else -1
        half = int(rng.integers(0, 2)) * l_pac
        lo, hi = half + l_pac // 4 + 800, half + 3 * l_pac // 4 - 800
        x0 = int(rng.integers(lo, hi))
        t = two[x0 + td * np.arange(tl)] if tl else np.zeros(0, np.uint8)
        q = two[x0 + td * np.arange(900)].copy()
        m = rng.random(len(q)) < 0.05
        q[m] = rng.integers(0, 4, int(m.sum()))
        cut = int(rng.integers(20, 400))
        q = np.delete(q, np.arange(cut, cut + int(rng.integers(1, 9))))
        q = q[:int(rng.integers(0, min(len(q), 3 * W + 40) + 1))]
        qd = 1 if rng.random() < 0.5 else -1
        qflat.append(q if qd == 1 else q[::-1])
        cols["qbase"][k] = pos if qd == 1 else pos + len(q) - 1
        pos += len(q)
        cols["qdir"][k], cols["qlen"][k] = qd, len(q)
        cols["tbase"][k], cols["tdir"][k], cols["tlen"][k] = x0, td, tl
        cols["w"][k] = W if k % 3 == 0 else int(rng.integers(1, W + 1))
        cols["h0"][k] = 0 if k % 4 == 0 else int(rng.integers(1, 60))
        qrows.append(q)
        trows.append(t)
    pac = np.zeros(l_pac // 4 + 1, np.uint8)
    pac[:(l_pac + 3) // 4] = pack_codes(ref)[:(l_pac + 3) // 4]
    qflat = np.concatenate(qflat + [np.full(1, 4, np.uint8)])
    qs = np.full((n, max(1, max(len(r) for r in qrows))), 4, np.uint8)
    ts = np.full((n, max(1, max(len(r) for r in trows))), 4, np.uint8)
    for k in range(n):
        qs[k, :len(qrows[k])] = qrows[k]
        ts[k, :len(trows[k])] = trows[k]
    return pac, qflat, cols, qs, ts


def _k2_both_modes(card, pac, l_pac, qflat, cols, qs, ts, zdrop, P):
    """Gather mode and host-array mode on the card, each against its plain
    version on the same device tensors, exactly; the two modes agree."""
    from bwa_tpu_torch.ops import ksw_band

    mat = np.full((5, 5), -4, np.int64)
    np.fill_diagonal(mat, 1)
    mat[4, :] = mat[:, 4] = -1
    rest = (mat, 6, 1, 6, 1, zdrop, P)
    d = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt,  # noqa: E731
                                                  device=card)
    gather = (d(pac, torch.uint8), l_pac, d(qflat, torch.uint8),
              *(d(cols[k]) for k in ("qbase", "qdir", "qlen", "tbase",
                                     "tdir", "tlen", "w", "h0")))
    n0, a0 = ksw_band.launches, ksw_band.array_launches
    got = ksw_band.ksw_band_side(*gather, *rest)
    want = ksw_band.ksw_band_side_plain(*gather, *rest)
    assert ksw_band.launches == n0 + 1
    assert torch.equal(got.cpu(), want.cpu())
    arrays = (d(qs, torch.uint8), d(ts, torch.uint8),
              *(d(cols[k], torch.int32) for k in ("qlen", "tlen", "w",
                                                  "h0")))
    got_a = ksw_band.ksw_band_arrays(*arrays, *rest)
    want_a = ksw_band.ksw_band_arrays_plain(*arrays, *rest)
    assert ksw_band.array_launches == a0 + 1
    assert torch.equal(got_a.cpu(), want_a.cpu())
    assert torch.equal(got_a.cpu(), got.cpu())
    return got.cpu()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["random", "repeats"])
@pytest.mark.parametrize("P", [128, 256, 512, 1024, 1280, 3072, 4096, 4480,
                               8192])
def test_k2_both_modes_match_plain(card, P, kind):
    """K2 in both modes at the warp path's bands (P <= 1024) and the wide
    path's, with 1, 3 and 37 problems (37: the last block of four warps
    holds one), z-drop on and off, dead problems among live ones, h0 = 0,
    qlen < W, tandem repeats (row-max ties), and rows past several 32-row
    code chunks."""
    for n in (1, 3, 37):
        pac, qflat, cols, qs, ts = _k2_problems(P + n, n, P, kind)
        for zdrop in (100, -1):
            out = _k2_both_modes(card, pac, 20_000, qflat, cols, qs, ts,
                                 zdrop, P)
            if n == 37 and zdrop < 0:
                assert int(out[:, 6].max()) > 96
                assert bool((out[:, 6] == 0).any())  # the dead ones


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P", [256, 1280])
def test_k2_gather_past_2g_matches_plain(card, P):
    """A reference of 2^30 + 4,321 bases (a 256 MB .pac on the card):
    targets on the reverse half, whose doubled-genome positions pass
    2^31, in both directions, against the plain version."""
    from bwa_tpu_torch.ops import ksw_band

    l_pac = (1 << 30) + 4321
    g = torch.Generator(device=card).manual_seed(5)
    pac = torch.randint(0, 256, (l_pac // 4 + 1,), dtype=torch.uint8,
                        device=card, generator=g)
    rng = np.random.default_rng(P)
    n, W = 12, P // 2 - 1
    two_l = 2 * l_pac
    x0 = two_l - 1 - rng.integers(0, 3000, n)
    td = np.where(np.arange(n) % 2 == 0, -1, 1)
    tl = np.where(td < 0, rng.integers(100, 600, n),
                  np.minimum(two_l - x0, 600))
    tl[5] = 0
    # queries: the targets' own codes with a few substitutions
    j = torch.arange(700, device=card)[None, :]
    pos = torch.as_tensor(x0, device=card)[:, None] \
        + torch.as_tensor(td, device=card)[:, None] * j
    codes = ksw_band._pac_gather(pac, l_pac, pos, pos < two_l).cpu().numpy()
    ql = rng.integers(1, 3 * W, n).clip(max=700)
    qflat = np.concatenate([np.where(rng.random(ql[k]) < 0.03, 3 - codes[
        k, :ql[k]], codes[k, :ql[k]]).astype(np.uint8) for k in range(n)])
    qbase = np.concatenate([[0], np.cumsum(ql)[:-1]])
    cols = (qbase, np.ones(n), ql, x0, td, tl, np.full(n, W),
            np.full(n, 30))
    args = (pac, l_pac, torch.as_tensor(qflat, device=card),
            *(torch.as_tensor(np.asarray(c, np.int64), device=card)
              for c in cols))
    mat = np.full((5, 5), -4, np.int64)
    np.fill_diagonal(mat, 1)
    mat[4, :] = mat[:, 4] = -1
    rest = (mat, 6, 1, 6, 1, 100, P)
    got = ksw_band.ksw_band_side(*args, *rest)
    want = ksw_band.ksw_band_side_plain(*args, *rest)
    assert torch.equal(got.cpu(), want.cpu())
    assert int(x0.min()) >= 1 << 31 and int(want[:, 0].max()) > 100


_SHAPES = [(1, 37, 80, 150, 100, 120), (2, 64, 128, 128, -1, 120),
           (3, 16, 33, 300, 20, 120), (4, 8, 700, 900, 100, 120),
           (5, 6, 1500, 1200, 100, 700), (6, 3, 3000, 1600, 100, 1200)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed,n,q,t,zdrop,w_hi", _SHAPES)
def test_k5_and_k2_arrays_match_plain(card, seed, n, q, t, zdrop, w_hi):
    """K5 (a window of each problem's own band on K2's device code) and K2
    in host-array mode (the warp path, and the wide path at Q = 1500 and
    3000) against their plain versions on the same device tensors; the two
    entry points agree with each other."""
    from bwa_tpu_torch.bench_kernel import ragged_problems
    from bwa_tpu_torch.ops import ksw_band, ksw_full
    from bwa_tpu_torch.ops.ksw_pallas import (device_rows, extend_band_pallas,
                                              extend_batch_pallas)

    qs, qlens, ts, tlens, mat, ws, h0s = ragged_problems(seed, n, q, t, w_hi)
    args = (qs, qlens, ts, tlens, mat, 6, 1, 6, 1, ws, 5, h0s)
    QP = -(-(q + 1) // 128) * 128
    qd, td, ql, tl, w, h0 = device_rows(*args, QP, card)
    rest = (mat, 6, 1, 6, 1, zdrop)
    n0 = ksw_full.launches
    got = ksw_full.ksw_full(qd, td, ql, tl, w, h0, *rest)
    assert ksw_full.launches == n0 + 1
    want = ksw_full.full_rows(qd, td, ql, tl, w, h0, *rest)
    assert torch.equal(got.cpu(), want.cpu())

    qd, td, ql, tl, w, h0 = device_rows(*args, q, card)
    P = ksw_band._band_for(int(w.max()))
    n0 = ksw_band.array_launches
    got = ksw_band.ksw_band_arrays(qd, td, ql, tl, w, h0, *rest, P)
    assert ksw_band.array_launches == n0 + 1
    want = ksw_band.ksw_band_arrays_plain(qd, td, ql, tl, w, h0, *rest, P)
    assert torch.equal(got.cpu(), want.cpu())

    full = extend_batch_pallas(*args[:11], zdrop, h0s)
    band = extend_band_pallas(*args[:11], zdrop, h0s)
    for a, b in zip(full, band):
        np.testing.assert_array_equal(a, b)


def _entry_vs_plain(card, kind, problems, zdrop=100):
    """K5 (kind "full") or K2's host-array mode ("band") on the card against
    its plain version on the same device tensors, exactly; returns the
    output and the band K2 took (None for K5)."""
    from bwa_tpu_torch.ops import ksw_band, ksw_full
    from bwa_tpu_torch.ops.ksw_pallas import device_rows

    qs, qlens, ts, tlens, mat, ws, h0s = problems
    q = qs.shape[1]
    width = -(-(q + 1) // 128) * 128 if kind == "full" else q
    d = device_rows(qs, qlens, ts, tlens, mat, 6, 1, 6, 1, ws, 5, h0s, width,
                    card)
    rest = (mat, 6, 1, 6, 1, zdrop)
    if kind == "full":
        n0 = ksw_full.launches
        got = ksw_full.ksw_full(*d, *rest)
        assert ksw_full.launches == n0 + 1
        want = ksw_full.full_rows(*d, *rest)
        P = None
    else:
        P = ksw_band._band_for(int(d[4].max()))
        n0 = ksw_band.array_launches
        got = ksw_band.ksw_band_arrays(*d, *rest, P)
        assert ksw_band.array_launches == n0 + 1
        want = ksw_band.ksw_band_arrays_plain(*d, *rest, P)
    assert torch.equal(got.cpu(), want.cpu())
    return got.cpu(), P


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind,q,w,width", [
    ("full", 4200, 100, 4224), ("full", 6000, 100, 6016),
    ("full", 6000, 3000, 6016), ("full", 14000, 13050, 14080),
    ("band", 4200, 2050, 4224), ("band", 4200, 2200, 4480),
    ("band", 6000, 4090, 8192), ("band", 14000, 13250, 26624)])
def test_k5_and_k2_arrays_match_plain_past_4096(card, kind, q, w, width):
    """Past the widths the first kernels refused (QP > 4096 for K5, P > 4096
    for K2): K5 at QP = 4224, 6016 (with windows of 256 and 6016 slots)
    and 14080, K2's host-array mode at P = 4224, 4480, 8192 and 26624, the
    last two windows (K5's 26,112 slots and K2's 26,624) wider than the
    wide path's shared-memory ring, so they run from the global scratch
    band; 300-row targets holding the query from their fourth base, 85%
    of it, with z-drop off."""
    from bwa_tpu_torch.bench_kernel import ragged_problems

    p = ragged_problems(q + w, 5, q, 300, w + 1)
    qs, qlens, ts, tlens, mat, ws, h0s = p
    qlens[:] = q - np.arange(5)  # long queries, so w is not clamped below
    tlens[:] = 300
    ws[:] = w - np.arange(5) * 7
    got, P = _entry_vs_plain(card, kind, (qs, qlens, ts, tlens, mat, ws,
                                          h0s), zdrop=-1)
    if kind == "band":
        assert P == width
    else:
        assert -(-(q + 1) // 128) * 128 == width
    assert int(got[:, 0].max()) > 100 and int(got[:, 6].max()) == 300


@pytest.mark.requires_cuda
@pytest.mark.parametrize("zdrop", [100, -1])
def test_k5_mixed_windows_match_plain(card, zdrop):
    """One K5 launch whose bands run from 1 to 1,200, so every window
    class (128 to 1,024 slots on the warp path, wider on the wide path)
    holds problems, some of them empty (qlen or tlen 0)."""
    from bwa_tpu_torch.bench_kernel import ragged_problems
    from bwa_tpu_torch.ops.ext_gather import band_clamp
    from bwa_tpu_torch.ops.ksw_band import _band_for

    qs, qlens, ts, tlens, mat, ws, h0s = ragged_problems(17, 96, 1400, 700)
    ws[:] = np.linspace(1, 1200, 96).astype(np.int32)
    qlens[::11] = 0
    tlens[5::13] = 0
    got, _ = _entry_vs_plain(card, "full", (qs, qlens, ts, tlens, mat, ws,
                                            h0s), zdrop)
    wc = band_clamp(qlens, ws, 1, 6, 1, 6, 1, 5)
    assert len(set(np.minimum(_band_for(wc), 1152).tolist())) == 9
    assert bool((got[:, 6] == 0).any())


# ---------------------------------------------------------------- K7, K7w

@pytest.fixture(scope="module")
def aln_reads(world):
    """60 bp reads (3% substitutions, 1% indels), an all-N read and an
    empty one, all as live lanes."""
    from bwa_tpu_torch.index.pack import NT4_TABLE

    fm = world["fm"]
    g = random_genome(150_000, seed=41, n_contigs=2)
    rs = simulate_reads(g, 94, read_len=60, seed=9, err_rate=0.03,
                        indel_rate=0.01)
    codes = [NT4_TABLE[np.frombuffer(s, np.uint8)] for _, s, _ in rs]
    return fm, codes + [np.full(60, 4, np.uint8), np.zeros(0, np.uint8)]


def _k7_vs_plain(tt, codes, cap, cap_a, max_steps, flags, **opt_kw):
    """K7w and K7 against cal_width_plain and gap_machine_plain on the same
    device tensors (every lane live), every output equal; returns K7's."""
    import types

    from bwa_tpu_torch.aln.batch_search import _prep_chunk
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.ops import gap_machine as gm

    opt = GapOpt(**opt_kw)
    lens = np.array([len(c) for c in codes], np.int32)
    off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    pk = types.SimpleNamespace(n=len(codes), lens=lens, codes_off=off,
                               codes_flat=np.concatenate(codes))
    _, md, mg, orig, qc, seed_en, use_seed, swin, _ = _prep_chunk(pk, opt)
    f_gape, f_nonstop, f_loggap, seed = (bool(flags >> i & 1)
                                         for i in range(4))
    assert use_seed
    d = {k: torch.from_numpy(v).cuda() for k, v in dict(
        qc=qc, orig=orig, lens=lens, md=md, mg=mg, seed_en=seed_en,
        swin=swin).items()}
    n = len(codes)
    k0, w0 = gm.launches, gm.width_launches
    wb = gm.cal_width(tt, d["orig"])
    sb = gm.cal_width(tt, d["swin"])
    assert torch.equal(wb, gm.cal_width_plain(tt, d["orig"]))
    assert torch.equal(sb, gm.cal_width_plain(tt, d["swin"]))
    if not seed:
        sb = torch.zeros((n, 1, 2), dtype=tt["cdt"], device="cuda")
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    scal = tuple(getattr(opt, k) for k in gm.SCALARS)
    args = (tt, d["qc"], d["lens"], d["md"], d["mg"], d["seed_en"], sb, wb,
            live, scal)
    kw = dict(cap=cap, cap_a=cap_a, use_seed=seed, f_gape=f_gape,
              f_nonstop=f_nonstop, f_loggap=f_loggap, max_steps=max_steps)
    got = gm.gap_machine(*args, **kw)
    torch.cuda.synchronize()
    assert (gm.launches, gm.width_launches) == (k0 + 1, w0 + 2)
    want = gm.gap_machine_plain(*args, **kw)
    for k in ("aln_m", "aln_kl", "n_aln", "n_stk", "ovf", "done_step",
              "n_occ", "n_walk", "steps"):
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k
    return {k: v.cpu() for k, v in got.items()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("flags", range(16))
def test_k7_flags_match_plain(aln_reads, flags):
    """Every instantiation: GAPE | NONSTOP << 1 | LOGGAP << 2 |
    use_seed << 3 (occtab R = 1, int32 coordinates, the first rung's
    caps)."""
    fm, codes = aln_reads
    got = _k7_vs_plain(_tree(fm, "int32"), codes, 64, 32, 200000, flags,
                       max_diff=2, fnr=0.0)
    assert int(got["n_aln"].sum()) > 0
    assert int(got["n_aln"][-1]) == 1  # the empty read is a hit at once


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap,cap_a,max_steps", [(64, 32, 200000),
                                                 (8, 2, 120)])
@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k7_caps_coords_occtab_match_plain(aln_reads, cap, cap_a, max_steps,
                                           occ_r, coords):
    """Default options; at cap 8 (cap_a 2, 120 steps) most lanes overflow
    their stack, their hits or the step limit."""
    fm, codes = aln_reads
    got = _k7_vs_plain(_tree(fm, coords, occ_r), codes, cap, cap_a,
                       max_steps, 0x9)
    assert got["aln_kl"].dtype == (torch.int64 if coords == "int64"
                                   else torch.int32)
    assert bool(got["ovf"].any())
    if cap == 8:
        assert int(got["ovf"].sum()) > len(codes) // 2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", [3, 16, 40])
@pytest.mark.parametrize("occ_r", [1, 4])
def test_k7_slot_reuse_and_full_pool_match_plain(aln_reads, cap, occ_r):
    """Pools of a few slots: lanes that end reuse freed slots (through the
    free-slot stack and the chunk list), the rest fill the pool (n_stk ==
    cap, n_push > cap - n_stk)."""
    from bwa_tpu_torch.ops import gap_machine as gm

    fm, codes = aln_reads
    got = _k7_vs_plain(_tree(fm, "int32", occ_r), codes, cap, 32, 200000,
                       0x9)
    causes = gm.overflow_causes(got, cap, 32)
    assert causes["stack"] > 0
    assert bool((~got["ovf"] & (got["done_step"] > 4 * cap)).any())


@pytest.fixture(scope="module")
def long_reads(aln_reads):
    """The 60 bp reads and two of 600 bp (past the compact record's 512)."""
    from bwa_tpu_torch.index.pack import NT4_TABLE

    fm, codes = aln_reads
    g = random_genome(150_000, seed=41, n_contigs=2)
    rs = simulate_reads(g, 2, read_len=600, seed=10, err_rate=0.01,
                        indel_rate=0.002)
    return fm, [NT4_TABLE[np.frombuffer(s, np.uint8)] for _, s, _ in rs] \
        + codes[:30]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("why", ["long_read", "max_gape"])
@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k7_wide_records_match_plain(aln_reads, long_reads, why, occ_r,
                                     coords):
    """The wide-record variant (records, lists and tables in global
    memory), forced by a read past PACK_L or by max_gape past PACK_D (and
    with it more score lists than the register bitmap holds)."""
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.ops import gap_machine as gm

    if why == "long_read":
        fm, codes = long_reads
        kw = dict(max_diff=2, fnr=0.0)
        L = 1024
    else:
        fm, codes = aln_reads
        kw = dict(max_diff=3, fnr=0.0, max_gape=gm.PACK_D + 45)
        L = 64
    opt = GapOpt(**kw)
    scal = tuple(getattr(opt, k) for k in gm.SCALARS)
    md = opt.max_diff
    n_lists = gm.score_lists(md, opt.max_gapo, scal)
    assert gm.wide_records(L, md, opt.max_gapo, scal, n_lists)
    got = _k7_vs_plain(_tree(fm, coords, occ_r), codes, 64, 32, 200000,
                       0x9, **kw)
    assert int(got["n_aln"].sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("L", [100, 128])
def test_k7w_n_runs_and_padding_match_plain(aln_reads, occ_r, coords, L):
    """K7w on reads with runs of N, an all-N read, reads shorter than the
    row (padding, code 4) and a row width that is not a multiple of 32."""
    from bwa_tpu_torch.ops import gap_machine as gm

    fm, codes = aln_reads
    rng = np.random.default_rng(L + occ_r)
    q = np.full((len(codes), L), 4, np.uint8)
    for i, c in enumerate(codes):
        n = min(len(c), L - int(rng.integers(0, 20)))
        q[i, :n] = c[:n]
        if i % 3 == 0 and n > 10:  # a run of N
            a = int(rng.integers(0, n - 5))
            q[i, a:a + int(rng.integers(1, 6))] = 4
    tt = _tree(fm, coords, occ_r)
    qd = torch.from_numpy(q).cuda()
    w0 = gm.width_launches
    got = gm.cal_width(tt, qd)
    torch.cuda.synchronize()
    assert gm.width_launches == w0 + 1
    assert got.dtype == tt["cdt"]
    assert torch.equal(got.cpu(), gm.cal_width_plain(tt, qd).cpu())


@pytest.mark.requires_cuda
def test_k7_refused_launch_raises(aln_reads):
    """An occtab layout K7 does not take (R = 2) raises in the wrapper; a
    launch the library refuses (cap 0) raises; neither counts a launch or
    falls back to the plain version, and a launch after them runs."""
    from bwa_tpu_torch.ops import cuda_kernels
    from bwa_tpu_torch.ops import gap_machine as gm

    fm, codes = aln_reads
    n0 = gm.launches
    tt2 = _tree(fm, "int32", occ_r=2)
    q = torch.zeros((4, 64), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        gm.cal_width(tt2, q)
    tt = _tree(fm, "int32")
    z = torch.zeros(4, dtype=torch.int32, device="cuda")
    u = torch.zeros(4, dtype=torch.uint8, device="cuda")
    wb = torch.zeros((4, 64, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError):
        cuda_kernels.gap_machine(
            tt["occtab"], tt["L2"].long(), tt["primary"], tt["seq_len"], q,
            z, z, z, u, wb, wb.clone(), u, [1] * 10, 10, 0, 1, False, False,
            False, False, False, 4, z, z, z, z, wb, z, z, z, z, z, u, z)
    assert gm.launches == n0
    _k7_vs_plain(tt, codes[:8], 64, 32, 200000, 0x9)


# ------------------------------------------------- the mesh; a second card

def _k7_args(tt, codes, dev):
    """K7's arguments for `codes` (default options, every lane live) on
    dev, its width tables made by K7w there."""
    import types

    from bwa_tpu_torch.aln.batch_search import _prep_chunk
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.ops import gap_machine as gm

    opt = GapOpt()
    lens = np.array([len(c) for c in codes], np.int32)
    off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    pk = types.SimpleNamespace(n=len(codes), lens=lens, codes_off=off,
                               codes_flat=np.concatenate(codes))
    _, md, mg, orig, qc, seed_en, use_seed, swin, _ = _prep_chunk(pk, opt)
    d = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        qc=qc, orig=orig, lens=lens, md=md, mg=mg, seed_en=seed_en,
        swin=swin).items()}
    wb = gm.cal_width(tt, d["orig"])
    sb = gm.cal_width(tt, d["swin"])
    live = torch.ones(len(codes), dtype=torch.bool, device=dev)
    scal = tuple(getattr(opt, k) for k in gm.SCALARS)
    return (d["qc"], d["lens"], d["md"], d["mg"], d["seed_en"], sb, wb,
            live, scal), dict(cap=64, cap_a=32, use_seed=use_seed,
                              f_gape=True, f_nonstop=False, f_loggap=False)


def _k1_consts():
    from bwa_tpu_torch.options import MemOptions

    o = MemOptions()
    return (o.min_seed_len, int(o.min_seed_len * o.split_factor + 0.499),
            o.split_width, o.max_mem_intv)


def _pe_reads(n_pairs):
    g = random_genome(150_000, seed=41, n_contigs=2)
    r1, r2 = simulate_reads(g, n_pairs, read_len=150, seed=12, paired=True)
    return [r for pair in zip(r1, r2) for r in pair]


@pytest.mark.requires_cuda
def test_mesh_two_shards_on_one_card_match_single_engine(world, aln_reads):
    """A mesh of two shards on cuda:0 (one index tree) against the single
    engine: K1's outputs through machine_sharded (a launch a shard), K7's
    through gap_machine_sharded, SE and PE SAM bytes and aln .sai bytes."""
    import io
    import types

    from bwa_tpu_torch.aln.batch_search import aln_batch_device
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.aln.sai import SaiWriter
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops import gap_machine as gm
    from bwa_tpu_torch.ops.fm import BatchedFMEngine, _next_valid_device
    from bwa_tpu_torch.options import MEM_F_PE, MemOptions
    from bwa_tpu_torch.parallel.mesh import (gap_machine_sharded,
                                             machine_sharded, make_mesh)

    fm = world["fm"]
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    em = make_engine(fm, "cuda", mesh=mesh)
    e1 = BatchedFMEngine(fm, device="cuda:0")
    assert em.mesh is mesh and list(em.trees) == [torch.device("cuda", 0)]
    # K1
    q, ql, _ = _lanes(world, "pack2")
    consts = _k1_consts()
    kw = dict(cap=16, cap_s=48, use_p3=True)
    qd, qld = torch.from_numpy(q).cuda(), torch.from_numpy(ql).cuda()
    s, n, st, o, ds = fmm.seed_machine(e1.idx, qd, qld,
                                       _next_valid_device(qd, qld), *consts,
                                       **kw)
    n0 = fmm.launches
    got = machine_sharded(em.trees, mesh, *consts, tagged=False, **kw)(q, ql)
    assert fmm.launches == n0 + 2
    for g, w in zip(got[:4], (fmm.sort_seeds(s, n, False), n, o, ds)):
        assert torch.equal(g.cpu(), w.cpu())
    assert got[4] == int(st)
    # K7 on the R = 1 tree
    fm7, codes = aln_reads
    tt = _tree(fm7, "int32")
    args, flags = _k7_args(tt, codes, "cuda")
    want = gm.gap_machine(tt, *args, max_steps=200000, **flags)
    k0 = gm.launches
    got = gap_machine_sharded(mesh, **flags)(
        {torch.device("cuda", 0): tt}, *args, max_steps=200000)
    assert gm.launches == k0 + 2
    for k in ("aln_m", "aln_kl", "n_aln", "n_stk", "ovf", "done_step",
              "n_occ", "n_walk", "steps"):
        assert torch.equal(got[k].cpu(), want[k].cpu()), k
    # SAM, SE and PE
    g = random_genome(150_000, seed=41, n_contigs=2)
    for rs, pe in ((simulate_reads(g, 128, read_len=150, seed=11), False),
                   (_pe_reads(64), True)):
        sams = []
        for eng in (em, e1):
            opt = MemOptions()
            if pe:
                opt.flag |= MEM_F_PE
            reads = [Read(name=a, seq=b, qual=c) for a, b, c in rs]
            process_seqs(opt, eng, fm, reads, 0, None, None)
            sams.append("".join(r.sam for r in reads))
        assert sams[0] == sams[1] and sams[0].count("\n") >= len(rs)
    # aln .sai
    lens = np.array([len(c) for c in codes], np.int32)
    pk = types.SimpleNamespace(
        n=len(codes), lens=lens, codes_flat=np.concatenate(codes),
        codes_off=np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
    sai = []
    for eng in (em, e1):
        out_n, rows = aln_batch_device(fm7, eng, pk, GapOpt())
        b = io.BytesIO()
        SaiWriter(b, GapOpt()).write_batch_raw(out_n, rows)
        sai.append(b.getvalue())
    assert sai[0] == sai[1] and len(sai[0]) > 0


def _every_kernel(world, aln_reads, dev):
    """K1, K8, K2 (gather mode on the warp and the wide path, host-array
    mode), K5, K7w and K7, each launched once on dev: their outputs on the
    host."""
    from bwa_tpu_torch.bench_kernel import ragged_problems
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops import gap_machine as gm
    from bwa_tpu_torch.ops import ksw_band, ksw_full
    from bwa_tpu_torch.ops.fm import _next_valid_device
    from bwa_tpu_torch.ops.ksw_pallas import device_rows

    out = {}
    tt = DeviceFMIndex(world["fm"], device=dev, occ_r=4).tree()
    q, ql, _ = _lanes(world, "pack2")
    qd, qld = torch.from_numpy(q).to(dev), torch.from_numpy(ql).to(dev)
    k1 = fmm.seed_machine(tt, qd, qld, _next_valid_device(qd, qld),
                          *_k1_consts(), cap=16, cap_s=48, use_p3=True)
    for name, t in zip(("seeds", "seed_n", "steps", "ovf", "done_step"), k1):
        out[f"K1 {name}"] = t.cpu()
    pq, pql = _probe_rows(world)
    out["K8"] = fm_ops.probe_breaks(tt, torch.from_numpy(pq).to(dev),
                                    torch.from_numpy(pql).to(dev)).cpu()
    mat = np.full((5, 5), -4, np.int64)
    np.fill_diagonal(mat, 1)
    mat[4, :] = mat[:, 4] = -1
    for P in (256, 1280):
        pac, qflat, cols, qs, ts = _k2_problems(P + 5, 5, P, "random")
        d = lambda a, dt=torch.int64: torch.as_tensor(  # noqa: E731
            a, dtype=dt, device=dev)
        rest = (mat, 6, 1, 6, 1, 100, P)
        out[f"K2 P={P}"] = ksw_band.ksw_band_side(
            d(pac, torch.uint8), 20_000, d(qflat, torch.uint8),
            *(d(cols[k]) for k in ("qbase", "qdir", "qlen", "tbase", "tdir",
                                   "tlen", "w", "h0")), *rest).cpu()
        out[f"K2 host-array P={P}"] = ksw_band.ksw_band_arrays(
            d(qs, torch.uint8), d(ts, torch.uint8),
            *(d(cols[k], torch.int32) for k in ("qlen", "tlen", "w", "h0")),
            *rest).cpu()
    qs, qlens, ts, tlens, kmat, ws, h0s = ragged_problems(1, 37, 80, 150,
                                                          120)
    rows = device_rows(qs, qlens, ts, tlens, kmat, 6, 1, 6, 1, ws, 5, h0s,
                       128, dev)
    out["K5"] = ksw_full.ksw_full(*rows, kmat, 6, 1, 6, 1, 100).cpu()
    fm7, codes = aln_reads
    t7 = DeviceFMIndex(fm7, device=dev, occ_r=1).tree()
    args, flags = _k7_args(t7, codes, dev)
    out["K7w"] = args[6].cpu()
    k7 = gm.gap_machine(t7, *args, max_steps=200000, **flags)
    out.update({f"K7 {k}": v.cpu() for k, v in k7.items()})
    torch.cuda.synchronize(dev)
    return out


@pytest.mark.requires_cuda
def test_kernels_on_second_card_match_first(world, aln_reads):
    """The device guard's witness on a host with two cards or more: every
    kernel launched on cuda:1 while cuda:0 is the current device equals
    the same launch on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    res = []
    for i in (0, 1):
        with torch.cuda.device(0):
            res.append(_every_kernel(world, aln_reads,
                                     torch.device("cuda", i)))
    assert res[0].keys() == res[1].keys()
    for k, v in res[0].items():
        assert torch.equal(v, res[1][k]), k


# ------------------------------------------ K12, K13: K1's state mode
def _state_equal(got, want, what):
    from bwa_tpu_torch.ops import fm_machine as fmm

    for k in fmm.SEG_FIELDS + ("stkA", "stkB", "seeds", "qmask", "steps"):
        g, w = got[k], want[k]
        g = g.cpu().long() if torch.is_tensor(g) else torch.tensor(int(g))
        w = w.cpu().long() if torch.is_tensor(w) else torch.tensor(int(w))
        assert torch.equal(g.reshape(w.shape), w), f"{what}: {k}"


# (lanes, stack cap, seed cap, occtab R, coordinates) of the state mode's
# tests: pack-2 lanes at default and tiny caps on both layouts and widths,
# the tandem-repeat lanes (rows longer than a warp) once each way
STATE_CASES = [("pack2", 16, 48, 1, "int32"), ("pack2", 16, 48, 4, "int64"),
               ("pack2", 2, 4, 4, "int32"), ("pack2", 3, 8, 1, "int64"),
               ("edge", 32, 64, 4, "int32"), ("edge", 32, 64, 1, "int64")]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lanes,cap,cap_s,occ_r,coords", STATE_CASES)
def test_k12_split_passes_match_plain(world, repeat_world, lanes, cap, cap_s,
                                      occ_r, coords):
    """K12 (smem_machine's pass 1 and pass 2, seed3_machine) against the
    plain stage range on the same device tensors: seeds as emitted,
    seed_n, steps, ovf and done_step, each launch counted once."""
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    if lanes == "edge":
        fm, q, ql = repeat_world
    else:
        fm, (q, ql, _) = world["fm"], _lanes(world, "pack2")
    tt = _tree(fm, coords, occ_r)
    qd, qld = torch.from_numpy(q).cuda(), torch.from_numpy(ql).cuda()
    nv = _next_valid_device(qd, qld)
    c = (19, 28, 10, 20)
    outs = []
    for plain in (False, True):
        dev = "cpu" if plain else "cuda"
        t = {k: (v.cpu() if torch.is_tensor(v) else v)
             for k, v in tt.items()} if plain else tt
        a = [x.to(dev) for x in (qd, qld, nv)]
        s = torch.zeros((q.shape[0], cap_s, 5), dtype=tt["cdt"], device=dev)
        n = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
        n1 = (fmm.smem_launches, fmm.seed3_launches)
        p1 = fmm.smem_machine(t, *a, *c[:3], s, n, n, cap=cap, cap_s=cap_s,
                              pass2=False)
        p2 = fmm.smem_machine(t, *a, *c[:3], p1[0], p1[1], p1[1], cap=cap,
                              cap_s=cap_s, pass2=True)
        p3 = fmm.seed3_machine(t, *a, c[0], c[3], p2[0], p2[1], cap_s=cap_s)
        assert (fmm.smem_launches, fmm.seed3_launches) == (
            (n1[0], n1[1]) if plain else (n1[0] + 2, n1[1] + 1))
        outs.append([[x.cpu() if torch.is_tensor(x) else torch.tensor(x)
                      for x in p] for p in (p1, p2, p3)])
    for p, (g, w) in enumerate(zip(*outs)):
        for i, (x, y) in enumerate(zip(g, w)):
            assert torch.equal(x.long().reshape(y.shape), y.long()), (p, i)
    if cap <= 3:
        assert bool(outs[1][0][3].any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lanes,cap,cap_s,occ_r,coords", STATE_CASES)
def test_k13_segments_match_plain(world, repeat_world, lanes, cap, cap_s,
                                  occ_r, coords):
    """K13 (K1's state mode with a step budget) run in segments of odd
    sizes, a segment ending inside backward rows: the whole state after
    each segment equals the plain version's."""
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    if lanes == "edge":
        fm, q, ql = repeat_world
    else:
        fm, (q, ql, _) = world["fm"], _lanes(world, "pack2")
    tt = _tree(fm, coords, occ_r)
    th = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in tt.items()}
    qh, qlh = torch.from_numpy(q), torch.from_numpy(ql)
    nvh = _next_valid_device(qh, qlh)
    dc = fmm.seed_state_init(q.shape[0], cap, cap_s, "cuda")
    dh = fmm.seed_state_init(q.shape[0], cap, cap_s, "cpu")
    mid_row = 0
    for n in (37, 53, 101, 1, 64, fmm.BIG_STEPS):
        n0 = fmm.segment_launches
        dc = fmm.segment(dc, tt, qh.cuda(), qlh.cuda(), nvh.cuda(),
                         19, 28, 10, 20, n, cap, cap_s, True)
        assert fmm.segment_launches == n0 + 1
        dh = fmm.segment(dh, th, qh, qlh, nvh, 19, 28, 10, 20, n, cap,
                         cap_s, True)
        _state_equal(dc, dh, f"after {n}")
        mid_row += int(((dh["phase"] == fmm.P_BWD) & (dh["j"] > 0)).sum())
    assert mid_row > 0
    assert bool((dh["phase"] == fmm.P_DONE).all())


# ------------------------------------------------------- K9, K10, K11
def _tree64(tt):
    return dict(tt, cdt=torch.int64, L2=tt["L2"].long(),
                ckpt=tt["ckpt"].long(), ssa=tt["ssa"].long())


def _to_host(tt):
    return {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in tt.items()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_k9_matches_plain(world, coords):
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex
    from bwa_tpu_torch.ops import fm as fm_ops

    fm = world["fm"]
    tt = DeviceFMIndex(fm, device="cuda").tree()
    if coords == "int64":
        tt = _tree64(tt)
    rng = np.random.default_rng(0)
    ks = np.concatenate([rng.integers(0, fm.seq_len + 1, 5000),
                         [0, fm.primary, fm.seq_len]])
    k = torch.from_numpy(ks).to(tt["cdt"])
    n0 = fm_ops.sa_launches
    work = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = fm_ops.sa_batch(tt, k.cuda(), work=work)
    torch.cuda.synchronize()
    assert fm_ops.sa_launches == n0 + 1 and got.dtype == tt["cdt"]
    want = fm_ops.sa_batch_plain(_to_host(tt), k)
    assert torch.equal(got.cpu(), want)
    assert int(work) > len(ks)  # walk steps counted
    ok = ks < fm.seq_len
    assert np.array_equal(want.numpy()[ok], fm.sa_lookup(ks[ok]))


def _read_rows(world, long=False):
    """The short reads plus random reads with Ns (one read a row), or the
    600 bp reads repeated to 8,000 bases a row (lists past a block's
    shared memory at int64)."""
    rng = np.random.default_rng(1)
    if long:
        codes = [np.tile(c, 14)[:8000] for c in world["long"]]
    else:
        codes = list(world["short"][:40])
        for _ in range(16):
            r = rng.integers(0, 4, int(rng.integers(30, 151))).astype(
                np.uint8)
            if rng.random() < 0.5:
                r[rng.integers(0, r.size)] = 4
            codes.append(r)
    L = max(len(c) for c in codes)
    q = np.full((len(codes), L), 4, np.uint8)
    ql = np.array([len(c) for c in codes], np.int32)
    for i, c in enumerate(codes):
        q[i, :len(c)] = c
    return q, ql


def _both(fn, tt, args, kw=None):
    """fn on the card and on the host with the same inputs, outputs on the
    host."""
    kw = kw or {}
    got = fn(tt, *[a.cuda() if torch.is_tensor(a) else a for a in args],
             **kw)
    torch.cuda.synchronize()
    want = fn(_to_host(tt), *args, **kw)
    return [g.cpu() for g in got], list(want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("max_intv,cap,occ_r,coords", [
    (0, None, 1, "int32"), (0, None, 4, "int64"), (30, None, 4, "int32"),
    (30, None, 1, "int64"), (0, 2, 4, "int32"), (0, 2, 1, "int64"),
    ("long", None, 4, "int64")])
def test_k10a_matches_plain(world, max_intv, cap, occ_r, coords):
    """K10a: every output equal; cap 2 overflows the lists; 8,000-base
    reads take the global scratch at int64."""
    from bwa_tpu_torch.ops import fm as fm_ops

    long = max_intv == "long"
    q, ql = _read_rows(world, long)
    B, L = q.shape
    rng = np.random.default_rng(2)
    x = np.array([rng.integers(0, max(1, n - 5)) for n in ql], np.int32)
    tt = _tree(world["fm"], coords, occ_r)
    minv = torch.from_numpy(rng.integers(1, 3, B)).to(tt["cdt"])
    args = (torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(x),
            minv, 0 if long else max_intv,
            torch.from_numpy(rng.random(B) < 0.9), cap or L + 2)
    n0 = fm_ops.smem1a_launches
    got, want = _both(fm_ops.smem1a_batch, tt, args)
    assert fm_ops.smem1a_launches == n0 + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    assert int((want[6] > 0).sum()) > B // 2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("min_len,max_intv,occ_r,coords", [
    (19, 20, 1, "int32"), (19, 20, 4, "int64"), (12, 5, 4, "int32"),
    (12, 5, 1, "int64")])
def test_k10b_matches_plain(world, min_len, max_intv, occ_r, coords):
    from bwa_tpu_torch.ops import fm as fm_ops

    q, ql = _read_rows(world)
    rng = np.random.default_rng(3)
    x = np.array([rng.integers(0, n) for n in ql], np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(x),
            min_len, max_intv, torch.from_numpy(rng.random(len(ql)) < 0.9))
    n0 = fm_ops.strategy1_launches
    got, want = _both(fm_ops.seed_strategy1_batch,
                      _tree(world["fm"], coords, occ_r), args)
    assert fm_ops.strategy1_launches == n0 + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    assert bool(want[1].any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,cap_s,occ_r,coords", [
    ("reads", 96, 1, "int32"), ("reads", 96, 4, "int64"),
    ("reads", 4, 4, "int32"), ("edge", 64, 1, "int64"),
    ("edge", 64, 4, "int32"), ("long", 512, 4, "int64")])
def test_k11_matches_plain(world, repeat_world, rows, cap_s, occ_r,
                           coords):
    """K11: the sorted seeds and seed_n equal the plain version's; cap_s 4
    overflows the seed store; the tandem-repeat lanes have rows longer
    than a warp; 8,000-base reads take the global scratch at int64."""
    from bwa_tpu_torch.ops import fm as fm_ops

    if rows == "edge":
        fm, q, ql = repeat_world
    else:
        fm = world["fm"]
        q, ql = _read_rows(world, rows == "long")
    L = q.shape[1]
    args = (torch.from_numpy(q), torch.from_numpy(ql), 19, 28, 10, 20)
    n0 = fm_ops.collect_launches
    got, want = _both(fm_ops.collect_intv_device, _tree(fm, coords, occ_r),
                      args, dict(cap=L + 2, cap_s=cap_s, key64=False))
    assert fm_ops.collect_launches == n0 + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    if cap_s < 10:
        assert bool((want[5] > cap_s).any())


@pytest.mark.requires_cuda
def test_engine_routes_on_the_card(world):
    """engine.collect_seeds under split and compaction (segments of 60
    steps over 600 lanes: compactions, then a run-out) on the card equal
    the unified route's on the card, with K12 and K13 launched."""
    import os

    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import BatchedFMEngine
    from bwa_tpu_torch.options import MemOptions

    eng = BatchedFMEngine(world["fm"], device="cuda")
    q, ql = _read_rows(world)
    q, ql = np.tile(q, (11, 1))[:600], np.tile(ql, 11)[:600]
    opt = MemOptions()
    want = eng.collect_seeds(q, ql, opt, 24)
    env = {"split": {"BWA_TPU_SEED_MACHINE": "split"},
           "compact": {"BWA_TPU_SEED_COMPACT": "1", "BWA_TPU_SEED_SEG": "60",
                       "BWA_TPU_SEED_SEG2": "60"}}
    for route, kv in env.items():
        n0 = (fmm.smem_launches, fmm.segment_launches)
        os.environ.update(kv)
        try:
            got = eng.collect_seeds(q, ql, opt, 24)
        finally:
            for k in kv:
                os.environ.pop(k)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), route
        if route == "split":
            assert fmm.smem_launches == n0[0] + 2
        else:
            assert fmm.segment_launches > n0[1] + 1
            assert len(eng.last_levels) > 1
