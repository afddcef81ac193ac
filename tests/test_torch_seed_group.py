"""The group forms of csrc/seed_machine.cu in plain PyTorch, held to the
plain versions and to the JAX package:

- the group lookup of K8 and K1's refill mode (ops/fm.py::group_lookup:
  2R threads, four text words each, loaded only up to each end, one row
  load for both ends where they share it) against _occ4, at R = 1 and 4;
- K8's loop (ops/fm.py::probe_breaks_group: a lookup only where the
  interval extends, the reverse start never formed, 16 codes at a time)
  against probe_breaks_plain, and probe_breaks_plain with qlen against
  bwa_tpu's probe_breaks on JAX CPU;
- K1's refill mode as the group form runs it (RefillLanes below: one plain
  step an iteration, a backward row one entry a step, at most one lookup a
  step) against seed_machine_refill_plain, lane for lane.

The kernels run only on a card; these models are what they do, step by
step.  Inputs are made from a seed with numpy; equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta

from bwa_tpu_torch.ops import fm as fm_ops
from bwa_tpu_torch.ops import fm_machine as fmm
from bwa_tpu_torch.ops.fm import _occ4


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex

    d = tmp_path_factory.mktemp("seed_group")
    g = random_genome(40_000, seed=29, n_contigs=2)
    write_fasta(d / "g.fa", g)
    return FMIndex.load(index_build(str(d / "g.fa"))), g


def _tree(fm, occ_r, coords):
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex

    tt = DeviceFMIndex(fm, device="cpu", occ_r=occ_r).tree()
    if coords == "int64":  # the 2*l_pac+2 >= 2^31 code path
        tt = dict(tt, cdt=torch.int64, L2=tt["L2"].long())
    return tt


def _ends(tt, rng, n):
    """(k1, k2) pairs: k at -1, 0, around primary and seq_len, at row and
    word edges and at random, each with a partner a few positions on (one
    row), one row on, or at random; and the first interval (-1, seq_len)."""
    seq_len, primary = int(tt["seq_len"]), int(tt["primary"])
    per_row = 16 * (tt["occtab"].shape[1] - 4)
    ks = {-1, 0, 1, primary - 2, primary - 1, primary, primary + 1,
          seq_len - 1, seq_len}
    for r in range(0, seq_len, per_row * 5):
        ks |= {r - 1, r, r + 1, r + 15, r + 16, r + 63, r + 64,
               r + per_row - 1}
    ks = sorted(k for k in ks if -1 <= k <= seq_len)
    ks += rng.integers(-1, seq_len + 1, n).tolist()
    k1 = np.array(ks * 4, np.int64)
    gap = np.concatenate([
        np.zeros(len(ks), np.int64), rng.integers(1, 17, len(ks)),
        np.full(len(ks), per_row), rng.integers(0, seq_len, len(ks))])
    k2 = np.minimum(k1 + gap, seq_len)
    k1 = np.append(k1, -1)
    k2 = np.append(k2, seq_len)
    return torch.from_numpy(k1), torch.from_numpy(k2)


@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("above", [True, False])
def test_group_lookup_matches_occ4(genome, occ_r, coords, above):
    tt = _tree(genome[0], occ_r, coords)
    rng = np.random.default_rng(occ_r + 7 * above)
    k1, k2 = _ends(tt, rng, 400)
    c = torch.from_numpy(rng.integers(0, 4, len(k1)))
    o1, o2, ab, loads = fm_ops.group_lookup(tt, k1, k2, c, above)
    w1 = _occ4(tt, k1).to(torch.int64)
    w2 = _occ4(tt, k2).to(torch.int64)
    rows = torch.arange(len(k1))
    assert torch.equal(o1, w1[rows, c])
    assert torch.equal(o2, w2[rows, c])
    if above:
        col = torch.arange(4)[None, :] > c[:, None]
        assert torch.equal(ab, ((w2 - w1) * col).sum(dim=1))
    # only the words at or below an end are loaded, and all of them: a row
    # end at position p of its row loads ceil((p + 1) / 64) thread words
    seq_len, primary = int(tt["seq_len"]), int(tt["primary"])
    per_row = 128 * occ_r

    def live_threads(k):
        kk = (k - (k >= primary).long()).clamp(0, seq_len - 1)
        return ((kk % per_row) // 64 + 1, kk // per_row)

    n1, r1 = live_threads(k1)
    n2, r2 = live_threads(k2)
    z1 = (k1 == -1) | (k1 == seq_len)
    z2 = (k2 == -1) | (k2 == seq_len)
    same = (r1 == r2) & ~z1 & ~z2
    want1 = torch.where(z1, 0, torch.where(same, torch.maximum(n1, n2), n1))
    want2 = torch.where(z2 | same, 0, n2)
    assert torch.equal(loads[:, :, 0].sum(dim=1), want1)
    assert torch.equal(loads[:, :, 1].sum(dim=1), want2)
    assert bool(same.any()) and bool((~same & ~z1 & ~z2).any())


@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_group_lookup_narrow_matches_occ4(genome, occ_r, coords):
    """K8's narrow lookup (ends k1, k1 + 1 of one row) against _occ4, at
    the positions narrow_ends admits among _ends' (row and word edges,
    around primary) and at random; the ones it refuses are the $ row,
    seq_len and a row's first position."""
    tt = _tree(genome[0], occ_r, coords)
    rng = np.random.default_rng(5 + occ_r)
    seq_len, primary = int(tt["seq_len"]), int(tt["primary"])
    k1, _ = _ends(tt, rng, 800)
    x1 = (k1 + 1).clamp(1, seq_len)  # an interval's start
    ok = fm_ops.narrow_ends(tt, x1, torch.ones_like(x1))
    per_row = 128 * occ_r
    kk2 = x1 - (x1 > primary).long()
    assert torch.equal(~ok, (x1 == primary) | (x1 == seq_len)
                       | (kk2 % per_row == 0))
    k1 = x1[ok] - 1
    c = torch.from_numpy(rng.integers(0, 4, len(k1)))
    o1, sz = fm_ops.group_lookup_narrow(tt, k1, c)
    rows = torch.arange(len(k1))
    w1 = _occ4(tt, k1).to(torch.int64)[rows, c]
    w2 = _occ4(tt, k1 + 1).to(torch.int64)[rows, c]
    assert torch.equal(o1, w1)
    assert torch.equal(sz, w2 - w1)
    assert int(sz.sum()) > 0 and bool((~ok).any())


def _probe_rows(g, L, seed):
    """Simulated reads padded to L columns (qlen < L), every fourth with
    an N run, an empty row, an all-N row and a row of pads only."""
    from bwa_tpu_torch.index.pack import NT4_TABLE

    rng = np.random.default_rng(seed)
    reads = simulate_reads(g, 24, read_len=min(L - 10, 150), seed=seed,
                           err_rate=0.02)
    rows = [NT4_TABLE[np.frombuffer(s, np.uint8)].copy() for _, s, _ in reads]
    for r in rows[::4]:
        p = int(rng.integers(0, len(r) - 3))
        r[p:p + int(rng.integers(1, 4))] = 4
    rows += [np.zeros(0, np.uint8), np.full(L - 5, 4, np.uint8)]
    q = np.full((len(rows) + 1, L), 4, np.uint8)
    ql = np.zeros(len(rows) + 1, np.int32)
    for i, r in enumerate(rows):
        q[i, :len(r)] = r
        ql[i] = len(r)
    return q, ql


@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("L", [70, 192])
def test_probe_breaks_group_matches_plain(genome, occ_r, coords, L):
    tt = _tree(genome[0], occ_r, coords)
    q, _ = _probe_rows(genome[1], L, L + occ_r)
    qt = torch.from_numpy(q)
    want = fm_ops.probe_breaks_plain(tt, qt)
    assert torch.equal(fm_ops.probe_breaks_group(tt, qt), want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("L", [64, 192])
def test_probe_breaks_plain_with_qlen_matches_jax(genome, L, monkeypatch):
    """probe_breaks (the plain version on a CPU q) given each row's qlen,
    against bwa_tpu's probe_breaks on JAX CPU: rows shorter than L, N runs,
    an empty row, an all-N row and a row of pads only."""
    from bwa_tpu.engine import make_engine as jax_make_engine
    from bwa_tpu.index.fmindex import FMIndex as JaxFMIndex
    from bwa_tpu.ops.fm import probe_breaks as jax_probe_breaks
    from test_torch_jax_native import jax_native

    fm, g = genome
    q, ql = _probe_rows(g, L, 3 * L)
    assert (ql < L).all()
    jax_native()
    monkeypatch.setenv("BWA_TPU_MESH", "off")  # one JAX CPU device
    jidx = jax_make_engine(JaxFMIndex.load(fm.prefix), "tpu").idx
    want = np.asarray(jax_probe_breaks(jidx, jnp.asarray(q),
                                       jnp.asarray(ql)))
    got = fm_ops.probe_breaks(_tree(fm, None, "int32"), torch.from_numpy(q),
                              torch.from_numpy(ql))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want.sum()) > 0


class RefillLanes:
    """K1's refill mode as csrc/seed_machine.cu's seed_refill_kernel runs
    it, its lanes taken in lane order each step (the order in which the
    plain version's same-step finishers draw): per lane one plain step an
    iteration, at most one group lookup (group_lookup), a backward row one
    entry a step."""

    P_NEXT, P_FWD, P_BWD, P_DONE = fmm.P_NEXT, fmm.P_FWD, fmm.P_BWD, \
        fmm.P_DONE

    def __init__(self, idx, table, lanes, min_seed_len, split_len,
                 split_width, max_intv3, cap, cap_s, use_p3, cap_r):
        self.idx, self.cap, self.cap_s = idx, cap, cap_s
        self.table = table.to(torch.int64)
        self.N = table.shape[0]
        self.L = (table.shape[1] - 2) // 2
        self.opt = (min_seed_len, split_len, split_width, max_intv3, use_p3,
                    cap_r)
        self.L2 = [int(v) for v in idx["L2"]]
        self.primary = int(idx["primary"])
        self.qctr = min(lanes, self.N)
        self.seeds = torch.zeros((lanes, cap_s, 6), dtype=torch.int64)
        self.qmask = torch.zeros((lanes, cap_s), dtype=torch.bool)
        self.lanes = []
        for b in range(lanes):
            s = dict(phase=self.P_NEXT, stage=fmm.S_P1, old_n=0, job=0, x=0,
                     i=0, j=0, minv=1, ik=[0, 0, 0], last_x2=0, info_end=0,
                     an=0, bn=0, stk=([[0] * 4 for _ in range(cap)],
                                      [[0] * 4 for _ in range(cap)]),
                     cls=0, cmn=0, ret=0, seed_n=0, seed_base=0, steps=0,
                     done_step=0, cur_is_a=True, rev=True, ovf=False, rid=b)
            if b < self.N:
                self._take(s, b)
            else:
                s["phase"], s["done_step"] = self.P_DONE, 1
            self.lanes.append(s)

    def _take(self, s, r):
        row = self.table[r]
        s["rid"], s["qlen"] = r, int(row[0])
        s["q"] = [int(v) for v in row[1:self.L + 1]]

    def _push_seed(self, b, s, r0, r1, r2, r3, r4):
        slot = min(s["seed_n"], self.cap_s - 1)
        self.seeds[b, slot] = torch.tensor([r0, r1, r2, r3, r4, s["rid"]])
        self.qmask[b, slot] = (r4 - r3) >= self.opt[1] and r2 <= self.opt[2]
        s["seed_n"] += 1

    def _next(self, b, s):
        """P_NEXT of the kernel: the next job, a draw, a start."""
        min_seed_len, split_len, split_width, max_intv3, use_p3, cap_r = \
            self.opt
        L, cap_s = self.L, self.cap_s
        st1m = s["stage"] == fmm.S_P2
        if st1m:
            lim = min(s["old_n"], cap_s)
            hits = [t for t in range(s["job"], lim) if self.qmask[b, t]]
            jj = hits[0] if hits else s["old_n"]
            have = jj < s["old_n"]
            if have:
                row = self.seeds[b, jj]
                s["x"] = (int(row[3]) + int(row[4])) >> 1
                s["minv"] = int(row[2]) + 1
            s["job"] = jj + int(have)
        else:  # the first base at or after the cursor, below qlen
            p = [t for t in range(max(s["job"], 0), s["qlen"])
                 if s["q"][t] < 4]
            have = bool(p)
            if have:
                s["x"] = p[0]
            s["minv"] = 1
        done_now = False
        if not have:
            if s["stage"] == fmm.S_P1:
                s["old_n"], s["stage"], s["job"] = s["seed_n"], fmm.S_P2, \
                    s["seed_base"]
            elif st1m and use_p3:
                s["stage"], s["job"] = fmm.S_P3, 0
            else:
                done_now = True
                if s["seed_n"] <= cap_s - cap_r:
                    r = self.qctr
                    self.qctr += 1
                    if r < self.N:
                        self._take(s, r)
                        s["seed_base"], s["stage"], s["job"] = \
                            s["seed_n"], fmm.S_P1, 0
                        done_now = False
        s["minv"] = max(s["minv"], 1)
        s["phase"] = self.P_DONE if done_now else self.P_NEXT
        if have:
            qx = s["q"][min(max(s["x"], 0), L - 1)]
            if qx < 4:
                L2 = self.L2
                s["ik"] = [L2[qx] + 1, L2[3 - qx] + 1, L2[qx + 1] - L2[qx]]
                s["info_end"] = s["i"] = s["x"] + 1
                s["an"] = 0
                s["phase"] = self.P_FWD

    def _lookup_args(self, s):
        """(k, size, base, need, entry) of the step's one lookup."""
        L, cap = self.L, self.cap
        if s["phase"] == self.P_FWD:
            qi = s["q"][min(max(s["i"], 0), L - 1)]
            s["qi"] = qi
            return (s["ik"][1], s["ik"][2], min(max(3 - qi, 0), 3),
                    s["i"] < s["qlen"] and qi < 4, None)
        if s["phase"] == self.P_BWD:
            pn = s["an"] if s["cur_is_a"] else s["bn"]
            s["pn"] = pn
            if s["j"] < pn:
                stk = s["stk"][0 if s["cur_is_a"] else 1]
                jr = pn - 1 - s["j"] if s["rev"] else s["j"]
                p = list(stk[min(max(jr, 0), cap - 1)])
                qb = s["q"][min(max(s["i"], 0), L - 1)] if s["i"] >= 0 else 4
                cb = qb if qb < 4 else -1
                return p[0], p[2], cb, cb >= 0, p
        return 0, 0, -1, False, None

    def _forward(self, b, s, o1, o2, ab, span):
        min_seed_len, _, _, max_intv3, _, _ = self.opt
        cap = self.cap
        ik, qi, i = s["ik"], s["qi"], s["i"]
        cf = min(max(3 - qi, 0), 3)
        of = [ik[0] + span + ab, self.L2[cf] + 1 + o1, o2 - o1]
        run_f = i < s["qlen"]
        amb = run_f and qi >= 4
        if s["stage"] != fmm.S_P3:
            ext_m = run_f and not amb
            changed = ext_m and of[2] != ik[2]
            if amb or changed or not run_f:
                s["stk"][0][min(s["an"], cap - 1)] = [*ik, s["info_end"]]
                s["ovf"] |= s["an"] >= cap
                s["an"] += 1
            stop_f = amb or (changed and of[2] < s["minv"]) or not run_f
            if ext_m and not stop_f:
                s["ik"], s["info_end"], s["i"] = of, i + 1, i + 1
            if stop_f:
                s.update(ret=s["info_end"], cur_is_a=True, rev=True, bn=0,
                         j=0, i=s["x"] - 1, cmn=0, last_x2=0,
                         phase=self.P_BWD)
        else:
            ext3 = run_f and not amb
            hit3 = ext3 and of[2] < max_intv3 and (i - s["x"]) >= min_seed_len
            if hit3 and of[2] > 0:
                self._push_seed(b, s, *of, s["x"], i + 1)
            if ext3 and not hit3:
                s["ik"], s["i"] = of, i + 1
            if amb or hit3:
                s["job"] = s["i"] + 1
            elif not run_f:
                s["job"] = s["qlen"]
            if amb or hit3 or not run_f:
                s["phase"] = self.P_NEXT

    def _backward(self, b, s, o1, o2, ab, span, cb, p):
        cap = self.cap
        if p is not None:
            ob = [self.L2[max(cb, 0)] + 1 + o1, p[1] + span + ab, o2 - o1]
            keep = cb < 0 or ob[2] < s["minv"]
            curr = s["bn"] if s["cur_is_a"] else s["an"]
            i = s["i"]
            if keep:
                if curr == 0 and (s["cmn"] == 0 or i + 1 < s["cls"]):
                    if p[3] - (i + 1) >= self.opt[0]:
                        self._push_seed(b, s, p[0], p[1], p[2], i + 1, p[3])
                    s["cls"], s["cmn"] = i + 1, s["cmn"] + 1
            elif curr == 0 or ob[2] != s["last_x2"]:
                tgt = s["stk"][1 if s["cur_is_a"] else 0]
                tgt[min(curr, cap - 1)] = [*ob, p[3]]
                s["ovf"] |= curr >= cap
                s["bn" if s["cur_is_a"] else "an"] += 1
                s["last_x2"] = ob[2]
            s["j"] += 1
        if s["j"] >= s["pn"]:
            if (s["bn"] if s["cur_is_a"] else s["an"]) == 0 or s["i"] < 0:
                if s["stage"] == fmm.S_P1:
                    s["job"] = s["ret"]
                s["phase"] = self.P_NEXT
            else:
                s["cur_is_a"] = not s["cur_is_a"]
                s["rev"] = False
                s["bn" if s["cur_is_a"] else "an"] = 0
                s["i"] -= 1
                s["j"] = 0
                s["last_x2"] = 0

    def run(self):
        live = [b for b, s in enumerate(self.lanes)
                if s["phase"] != self.P_DONE]
        while live:
            for b in live:
                if self.lanes[b]["phase"] == self.P_NEXT:
                    self._next(b, self.lanes[b])
            args = {b: self._lookup_args(self.lanes[b]) for b in live}
            need = [b for b in live if args[b][3]]
            res = {}
            if need:
                k = torch.tensor([args[b][0] for b in need])
                sz = torch.tensor([args[b][1] for b in need])
                c = torch.tensor([args[b][2] for b in need])
                o1, o2, ab, _ = fm_ops.group_lookup(self.idx, k - 1,
                                                    k - 1 + sz, c)
                res = {b: (int(o1[n]), int(o2[n]), int(ab[n]))
                       for n, b in enumerate(need)}
            for b in live:
                s = self.lanes[b]
                lk, lsz, cb, _, p = args[b]
                o1, o2, ab = res.get(b, (0, 0, 0))
                span = int(lk <= self.primary and lk + lsz - 1 >= self.primary)
                if s["phase"] == self.P_FWD:
                    self._forward(b, s, o1, o2, ab, span)
                elif s["phase"] == self.P_BWD:
                    self._backward(b, s, o1, o2, ab, span, cb, p)
                s["steps"] += 1
                if s["phase"] == self.P_DONE and s["done_step"] == 0:
                    s["done_step"] = s["steps"]
            live = [b for b in live if self.lanes[b]["phase"] != self.P_DONE]
        filled = [min(s["seed_n"], self.cap_s) for s in self.lanes]
        for b, f in enumerate(filled):
            self.seeds[b, f:] = 0
        return (self.seeds, torch.tensor([s["seed_n"] for s in self.lanes]),
                max(s["steps"] for s in self.lanes),
                torch.tensor([s["ovf"] for s in self.lanes]),
                torch.tensor([s["done_step"] for s in self.lanes]),
                self.qctr)


@pytest.mark.parametrize("lanes,cap,cap_s", [(4, 16, 240), (16, 16, 96),
                                             (3, 2, 40), (2, 16, 26)])
@pytest.mark.parametrize("occ_r", [1, 4])
def test_refill_group_form_matches_plain(genome, lanes, cap, cap_s, occ_r):
    """4 lanes recycle through 11 reads, 16 lanes start with every read
    (5 start done), cap 2 overflows the stack, and at cap_s 26 the lanes
    fill and stop drawing: lane for lane, the seeds, seed_n, ovf,
    done_step, the longest lane's steps and the reads drawn equal the
    plain version's."""
    from bwa_tpu_torch.mem.batch_seed import _pad_reads
    from bwa_tpu_torch.index.pack import NT4_TABLE

    fm, g = genome
    reads = simulate_reads(g, 10, read_len=150, seed=lanes + cap,
                           err_rate=0.02)
    codes = [NT4_TABLE[np.frombuffer(s, np.uint8)] for _, s, _ in reads]
    q, ql, _ = _pad_reads(codes + [np.zeros(0, np.uint8)])
    tt = _tree(fm, occ_r, "int32")
    table = fm_ops._refill_table(torch.from_numpy(q), torch.from_numpy(ql))
    args = (tt, table, lanes, 19, 28, 10, 20)
    kw = dict(cap=cap, cap_s=cap_s, use_p3=True, cap_r=24)
    want = fmm.seed_machine_refill_plain(*args, **kw)
    got = RefillLanes(*args, **kw).run()
    # the kernel's cursor also counts the draws that found the queue empty
    got = (*got[:5], min(got[5], table.shape[0]))
    assert torch.equal(got[0], want[0].to(torch.int64))
    for g_, w_ in zip(got[1:], want[1:]):
        assert torch.equal(torch.as_tensor(g_).to(torch.int64).reshape(-1),
                           torch.as_tensor(w_).to(torch.int64).reshape(-1))
    if cap == 2:
        assert bool(want[3].any())
    if cap_s == 26:
        assert int(want[5]) < len(codes) + 1
