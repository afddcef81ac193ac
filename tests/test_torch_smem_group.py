"""The forms of K10a and K10b (csrc/smem_batch.cu) in plain PyTorch, held
to the plain versions:

- the ballot form of a bwt_smem1a backward row (ops/fm_machine.py::
  smem1a_row_resolve: a round of entries, the rules by ballot) against
  the one-entry-at-a-time rule of smem1a_batch_plain, on seeded random
  rows, in rounds of 1, 2, 4, 16 or all entries, taken whole or from an
  entry part way along the row;
- the kernels' walks as they run them (SmemWarps below: in the group form
  a group of 2R threads a read, 32 / 2R reads a warp, in the warp form a
  read a warp; one group lookup a forward step, the steps that need none
  taken between lookups, a backward row one entry a round in the group
  form, 32 / 2R in the warp form) against smem1a_batch_plain and
  seed_strategy1_batch_plain, output for output and, for K10b, lookup for
  extension, at R = 1 and 4 and int32 and int64 coordinates.

The kernels run only on a card; these models are what they do, step by
step.  Inputs are made from a seed with numpy; equality is exact."""

import numpy as np
import pytest
import torch

from datagen import random_genome, write_fasta

from bwa_tpu_torch.ops import fm as fm_ops
from bwa_tpu_torch.ops.fm_machine import smem1a_row_resolve

# tandem arrays of the genome: (start, unit, copies)
ARRAYS = ((6_000, b"AC", 60), (14_000, b"AGT", 45), (22_000, b"A", 40))


def serial_row(p2, e2, keep_all, n0, last_x2, ik_x2, max_intv, minv, cap,
               emit_ok, j0=0, j1=None):
    """smem1a_batch_plain's backward row, entries j0..j1-1 one at a time:
    the target list's final slots (slot -> entry), and what the row did."""
    n, lx, x2, ok = n0, last_x2, ik_x2, emit_ok
    push = np.zeros(len(e2), bool)
    stack, emit = {}, -1
    for j in range(j0, len(e2) if j1 is None else j1):
        if keep_all or x2 < max_intv or e2[j] < minv:
            if n == 0 and ok:  # then i + 1 == the last mem's start
                emit, ok, x2 = j, False, int(p2[j])
        elif n == 0 or e2[j] != lx:
            stack[min(n, cap - 1)] = j
            push[j] = True
            n, lx = n + 1, int(e2[j])
    return dict(push=push, stack=stack, emit=emit, n=n, last_x2=lx,
                ik_x2=x2, emit_ok=ok)


def random_rows(seed, n_rows, pn_hi, caps, alphabet, max_intvs, keep_alls,
                handoff):
    """Rows of sizes from a small alphabet (runs of equal sizes), ik below
    or above max_intv, minv in the alphabet's range; with handoff, an
    entry j0 from which the rounds start (the entries before it taken one
    at a time, as walk_prepare takes those kept without extension)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_rows):
        pn = int(rng.integers(1, pn_hi + 1))
        p2 = rng.integers(1, alphabet + 3, pn).astype(np.int64)
        e2 = np.minimum(p2, rng.integers(0, alphabet + 1, pn))
        max_intv = int(rng.choice(max_intvs))
        yield dict(p2=p2, e2=e2, keep_all=bool(rng.choice(keep_alls)),
                   n0=0, last_x2=0, ik_x2=int(rng.integers(0, alphabet + 3)),
                   max_intv=max_intv, minv=int(rng.integers(1, alphabet + 1)),
                   cap=int(rng.choice(caps)),
                   emit_ok=bool(rng.random() < 0.8),
                   first=bool(rng.random() < 0.5),
                   j0=int(rng.integers(0, pn)) if handoff else 0)


# (seed, rows, longest row, list caps, size alphabet, max_intv choices,
# keep_all choices, hand-off)
CASES = {
    "emit_first": (1, 300, 12, (16, 64), 3, (0,), (False,), False),
    "ik_rewrite": (2, 300, 20, (16, 64), 4, (2, 3, 5), (False,), False),
    "over_cap": (3, 300, 60, (1, 2, 3), 6, (0, 3), (False,), False),
    "equal_runs": (4, 300, 40, (16, 64), 1, (0,), (False,), False),
    "keep_all": (5, 100, 30, (2, 16), 3, (0, 3), (True,), False),
    "handoff": (6, 300, 50, (2, 16, 64), 3, (0, 3), (False, True), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounds", [None, 2, 4, 16])
def test_smem1a_row_resolve_matches_serial(case, rounds):
    """A row in rounds of 4 (the warp form at R = 4) or 16 (R = 1)
    entries, or 2, or all at once, equals the one-entry rule: pushes,
    slots, the final list, the emit, the count, the last size pushed and
    ik's size after it; with a hand-off, the entries before j0 one at a
    time, then the rounds from the state they left."""
    seen = dict(push=0, emit=0, over=0, rewrite=0)
    for r in random_rows(*CASES[case]):
        args = (r["p2"], r["e2"], r["keep_all"])
        want = serial_row(*args, r["n0"], r["last_x2"], r["ik_x2"],
                          r["max_intv"], r["minv"], r["cap"], r["emit_ok"])
        # the entries before j0 one at a time, then the rounds
        head = serial_row(*args, r["n0"], r["last_x2"], r["ik_x2"],
                          r["max_intv"], r["minv"], r["cap"], r["emit_ok"],
                          0, r["j0"])
        if r["keep_all"] and r["j0"]:
            continue  # a row that keeps all is resolved at its start
        got = smem1a_row_resolve(
            torch.from_numpy(r["p2"]), torch.from_numpy(r["e2"]),
            r["keep_all"], head["n"], head["last_x2"], head["ik_x2"],
            r["max_intv"], r["minv"], r["cap"], head["emit_ok"], r["first"],
            len(r["e2"]), r["j0"], rounds)
        push = got["push"].numpy()
        push[:r["j0"]] = head["push"][:r["j0"]]
        np.testing.assert_array_equal(push, want["push"])
        stack = dict(head["stack"])
        stack.update(got["stack"])
        assert stack == want["stack"]
        emit = got["emit"] if got["emit"] >= 0 else head["emit"]
        assert emit == want["emit"]
        for k in ("n", "last_x2", "ik_x2"):
            assert got[k] == want[k], k
        # a round's writers never share a slot
        w = got["writes"].numpy()
        slots = got["slot"].numpy()
        step = rounds or len(push)
        for lo in range(r["j0"], len(push), step):
            s = slots[lo:lo + step][w[lo:lo + step]]
            assert len(set(s.tolist())) == len(s)
        seen["push"] += int(want["push"].sum())
        seen["emit"] += want["emit"] >= 0
        seen["over"] += want["n"] > r["cap"]
        seen["rewrite"] += want["emit"] == 0 and r["p2"][0] >= r["max_intv"] \
            > r["ik_x2"]
    if case == "emit_first":
        assert seen["emit"] > 0 and seen["push"] > 0
    if case == "over_cap":
        assert seen["over"] > 0
    if case == "ik_rewrite":
        assert seen["rewrite"] > 0
    if case == "keep_all":
        assert seen["push"] == 0 and seen["emit"] > 0


def test_smem1a_row_resolve_read_slots():
    """The first row reads the forward list of cn rows reversed, clamped as
    smem1a_batch_plain gathers it (entries past cap - 1 read slot
    cn - cap); later rows read min(j, cap - 1)."""
    z = torch.zeros(6, dtype=torch.int64)
    got = smem1a_row_resolve(z, z, False, 0, 0, 0, 0, 1, 3, True, True, 6)
    assert got["read_slot"].tolist() == [2, 2, 2, 2, 2, 2]
    got = smem1a_row_resolve(z[:4], z[:4], False, 0, 0, 0, 0, 1, 8, True,
                             True, 4)
    assert got["read_slot"].tolist() == [3, 2, 1, 0]
    got = smem1a_row_resolve(z, z, False, 0, 0, 0, 0, 1, 3, True, False, 6)
    assert got["read_slot"].tolist() == [0, 1, 2, 2, 2, 2]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 30 kb genome with three tandem arrays, and reads from it: random
    ones, reads through an array (a forward pass through an array changes
    the interval at almost every base: rows of tens of entries), reads with
    Ns, and the edges (all N, empty)."""
    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE

    name, seq = random_genome(30_000, seed=31, n_contigs=1,
                              with_ns=False)[0]
    seq = bytearray(seq)
    for s, unit, n in ARRAYS:
        seq[s:s + len(unit) * n] = unit * n
    d = tmp_path_factory.mktemp("smem_group")
    write_fasta(d / "g.fa", [(name, bytes(seq))])
    fm = FMIndex.load(index_build(str(d / "g.fa")))
    codes = NT4_TABLE[np.frombuffer(bytes(seq), np.uint8)]
    rng = np.random.default_rng(7)
    rows = [np.full(90, 4, np.uint8), np.zeros(0, np.uint8)]
    for s, unit, n in ARRAYS:
        for f in (0, 20):
            rows.append(codes[s - f:s + min(70, len(unit) * n) + 20])
    for _ in range(14):
        p = int(rng.integers(0, 29_800))
        r = codes[p:p + int(rng.integers(30, 121))].copy()
        if rng.random() < 0.3:
            r[rng.integers(0, r.size)] = 4
        if rng.random() < 0.3:  # a substitution: a shorter SMEM
            k = int(rng.integers(0, r.size))
            r[k] = (r[k] + 1) % 4
        rows.append(r)
    L = max(len(r) for r in rows)
    q = np.full((len(rows), L), 4, np.uint8)
    ql = np.array([len(r) for r in rows], np.int32)
    for k, r in enumerate(rows):
        q[k, :len(r)] = r
    return fm, q, ql


def _tree(fm, occ_r, coords):
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex

    tt = DeviceFMIndex(fm, device="cpu", occ_r=occ_r).tree()
    if coords == "int64":  # the 2*l_pac+2 >= 2^31 code path
        tt = dict(tt, cdt=torch.int64, L2=tt["L2"].long())
    return tt


FWD, BWD, END = 0, 1, 2


class SmemWarps:
    """K10a or K10b as csrc/smem_batch.cu runs them (warp_run): reads in
    warps, a team of T groups a read (the group form: T = 1, E = 32 / 2R
    reads a warp; the warp form: T = E, a read a warp), each read's call a
    walk (walk_smem1a, walk_strategy1); every round of the warp loop, each
    read first takes the steps that need no lookup (walk_prepare), then, if
    it still runs, one forward step on one group lookup (fm.group_lookup,
    walk_forward) or a round of T backward entries looked up together and
    resolved by ballot (smem1a_row_resolve, one round).  The warps step in
    lockstep here; each is independent of the others."""

    def __init__(self, idx, q, qlen, cap, form="group"):
        self.idx, self.cap = idx, cap
        self.q = q.numpy().astype(np.int64)
        self.qlen = qlen.numpy().astype(np.int64)
        self.L = self.q.shape[1]
        E = 32 // ((idx["occtab"].shape[1] - 4) // 4)
        self.T, self.E = (1, E) if form == "group" else (E, 1)
        self.L2 = [int(v) for v in idx["L2"]]
        self.primary = int(idx["primary"])
        B = self.q.shape[0]
        self.la = [[[0] * 4 for _ in range(cap)] for _ in range(B)]
        self.lb = [[[0] * 4 for _ in range(cap)] for _ in range(B)]
        self.mems = [[[0] * 5 for _ in range(cap)] for _ in range(B)]
        self.lookups = [0] * B
        self.wide_rounds = 0  # backward rounds of more than one entry

    def code(self, b, i):
        return int(self.q[b, min(max(i, 0), self.L - 1)]) if self.L else 4

    def start(self, b, x, minv, max_intv, active, s1=False, min_len=0):
        qx = self.code(b, x)
        w = dict(s1=s1, x=x, mem_n=0, ret=x + 1, phase=END, found=False,
                 r=(0, 0, 0))
        if active and qx < 4 and x < self.qlen[b]:
            L2 = self.L2
            w.update(phase=FWD, i=x + 1, info_end=x + 1, cn=0,
                     minv=max(minv, 1), max_intv=max_intv, min_len=min_len,
                     ik=[L2[qx] + 1, L2[3 - qx] + 1, L2[qx + 1] - L2[qx]])
        return w

    def bwd_start(self, b, w):
        w.update(phase=BWD, i=w["x"] - 1, first=True, on_b=False, pn=w["cn"],
                 j=0, n0=0, last_x2=0, ik_x2=w["ik"][2], m_last=0, mem_n=0)
        self.row_start(b, w)

    def row_start(self, b, w):
        qi = self.code(b, w["i"]) if w["i"] >= 0 else 4
        w["c"] = qi if qi < 4 else -1

    def slot(self, w, j):
        jj = min(j, self.cap - 1)
        return min(max(w["cn"] - 1 - jj, 0), self.cap - 1) if w["first"] \
            else jj

    def put4(self, lst, n, row):
        lst[min(n, self.cap - 1)] = list(row)

    def emit(self, b, w, p):
        self.mems[b][min(w["mem_n"], self.cap - 1)] = [
            p[0], p[1], p[2], w["i"] + 1, p[3]]
        w["mem_n"] += 1
        w["m_last"] = w["i"] + 1
        w["ik_x2"] = p[2]

    def emit_rule(self, b, w, p):
        if w["n0"] == 0 and (w["mem_n"] == 0 or w["i"] + 1 < w["m_last"]):
            self.emit(b, w, p)

    def prepare(self, b, w):
        """walk_prepare: (k1, k2, cb) of the next forward lookup, "bwd"
        for a backward round, or None when the call is over."""
        qlen = int(self.qlen[b])
        while True:
            if w["phase"] == END:
                return None
            if w["phase"] == FWD:
                run = w["i"] < qlen
                qi = self.code(b, w["i"]) if run else 4
                if w["s1"]:
                    if not run or qi >= 4:
                        w["ret"] = w["i"] + 1 if run else qlen
                        w["phase"] = END
                        return None
                elif not run or qi >= 4 or w["ik"][2] < w["max_intv"]:
                    self.put4(self.la[b], w["cn"], [*w["ik"], w["info_end"]])
                    w["cn"] += 1
                    w["ret"] = w["info_end"]
                    self.bwd_start(b, w)
                    continue
                ik = w["ik"]
                return ik[1] - 1, ik[1] - 1 + ik[2], 3 - qi
            if w["j"] >= w["pn"]:
                if w["n0"] == 0:
                    w["phase"] = END
                    return None
                w.update(on_b=not w["on_b"], first=False, pn=w["n0"], j=0,
                         n0=0, last_x2=0, i=w["i"] - 1)
                self.row_start(b, w)
                continue
            prev = self.lb[b] if w["on_b"] else self.la[b]
            p = list(prev[self.slot(w, w["j"])])
            if w["c"] < 0:
                self.emit_rule(b, w, p)
                w["j"] = w["pn"]
                continue
            if w["ik_x2"] < w["max_intv"]:
                self.emit_rule(b, w, p)
                w["j"] += 1
                continue
            return "bwd"

    def forward(self, b, w, k1, k2, cb, o1, o2, ab):
        """walk_forward."""
        span = int(k1 < self.primary <= k2)
        e1, e2 = self.L2[cb] + 1 + o1, o2 - o1
        self.lookups[b] += 1
        ik = w["ik"]
        e0 = ik[0] + span + ab
        if w["s1"]:
            if e2 < w["max_intv"] and w["i"] - w["x"] >= w["min_len"]:
                w.update(found=True, r=(e0, e1, e2), ret=w["i"] + 1,
                         phase=END)
                return
        elif e2 != ik[2]:
            self.put4(self.la[b], w["cn"], [*ik, w["info_end"]])
            w["cn"] += 1
            w["ret"] = w["info_end"]
            if e2 < w["minv"]:
                self.bwd_start(b, w)
                return
        w.update(ik=[e0, e1, e2], info_end=w["i"] + 1, i=w["i"] + 1)

    def backward(self, b, w):
        """A backward round: entries j..j+T-1 of read b's row looked up
        together and resolved by smem1a_row_resolve in one round."""
        cap, T = self.cap, self.T
        j0, hi = w["j"], min(w["j"] + T, w["pn"])
        prev = self.lb[b] if w["on_b"] else self.la[b]
        ps = [list(prev[self.slot(w, j)]) for j in range(j0, hi)]
        k1 = torch.tensor([p[0] - 1 for p in ps])
        k2 = torch.tensor([p[0] - 1 + p[2] for p in ps])
        o1, o2, ab, _ = fm_ops.group_lookup(
            self.idx, k1, k2, torch.full_like(k1, w["c"]))
        e2 = [0] * j0 + (o2 - o1).tolist()
        p2 = [0] * j0 + [p[2] for p in ps]
        emit_ok = w["mem_n"] == 0 or w["i"] + 1 < w["m_last"]
        res = smem1a_row_resolve(torch.tensor(p2), torch.tensor(e2), False,
                                 w["n0"], w["last_x2"], w["ik_x2"],
                                 w["max_intv"], w["minv"], cap, emit_ok,
                                 w["first"], w["cn"], j0, T)
        cur = self.la[b] if w["on_b"] else self.lb[b]
        for n, p in enumerate(ps):
            if res["writes"][j0 + n]:
                span = int(p[0] <= self.primary <= p[0] + p[2] - 1)
                self.put4(cur, int(res["slot"][j0 + n]),
                          [self.L2[w["c"]] + 1 + int(o1[n]),
                           p[1] + span + int(ab[n]), e2[j0 + n], p[3]])
        if res["emit"] == 0:
            self.emit(b, w, ps[0])
        w.update(n0=res["n"], last_x2=res["last_x2"], ik_x2=res["ik_x2"],
                 j=hi)
        self.lookups[b] += hi - j0
        self.wide_rounds += hi - j0 > 1

    def run(self, walks):
        """Every warp's loop until its reads are done."""
        B, E = len(walks), self.E
        warps = [list(range(w0, min(w0 + E, B))) for w0 in range(0, B, E)]
        while warps:
            fwd, left = [], []
            for reads in warps:
                need = {b: self.prepare(b, walks[b]) for b in reads}
                if all(v is None for v in need.values()):
                    continue
                left.append(reads)
                for b in reads:
                    if need[b] == "bwd":
                        self.backward(b, walks[b])
                    elif need[b] is not None:
                        fwd.append((b, need[b]))
            if fwd:
                k1 = torch.tensor([r[1][0] for r in fwd])
                k2 = torch.tensor([r[1][1] for r in fwd])
                cb = torch.tensor([r[1][2] for r in fwd])
                o1, o2, ab, _ = fm_ops.group_lookup(self.idx, k1, k2, cb)
                for n, (b, (a1, a2, c)) in enumerate(fwd):
                    self.forward(b, walks[b], a1, a2, c, int(o1[n]),
                                 int(o2[n]), int(ab[n]))
            warps = left
        return walks


def _smem1a_inputs(q, ql, seed, max_intv):
    rng = np.random.default_rng(seed)
    B = q.shape[0]
    x = np.array([rng.integers(0, max(1, n)) for n in ql], np.int32)
    x[:B // 4] = 0
    minv = rng.integers(1, 4, B)
    return (torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(x),
            torch.from_numpy(minv), max_intv,
            torch.from_numpy(rng.random(B) < 0.9))


@pytest.mark.parametrize("occ_r,coords,max_intv,cap,form", [
    (4, "int32", 0, None, "group"), (4, "int64", 0, None, "warp"),
    (1, "int32", 0, None, "warp"), (1, "int64", 30, None, "group"),
    (4, "int32", 30, None, "warp"), (4, "int64", 0, 2, "warp"),
    (1, "int32", 0, 3, "group")])
def test_smem1a_walks_match_plain(genome, occ_r, coords, max_intv, cap,
                                  form):
    """K10a's walks in both forms against smem1a_batch_plain: ret, the mems
    as listed (overwritten past cap) and mem_n; cap 2 and 3 overflow the
    lists; the warp form takes the tandem reads' rows 32 / 2R entries a
    round."""
    fm, q, ql = genome
    tt = _tree(fm, occ_r, coords)
    args = _smem1a_inputs(q, ql, occ_r + len(coords) + max_intv, max_intv)
    cap = cap or q.shape[1] + 2
    want = fm_ops.smem1a_batch_plain(tt, *args, cap)
    sw = SmemWarps(tt, args[0], args[1], cap, form)
    walks = [sw.start(b, int(args[2][b]), int(args[3][b]), max_intv,
                      bool(args[5][b])) for b in range(q.shape[0])]
    sw.run(walks)
    assert [w["ret"] for w in walks] == want[0].tolist()
    assert [w["mem_n"] for w in walks] == want[6].tolist()
    for b, w in enumerate(walks):
        for j in range(min(w["mem_n"], cap)):
            got = sw.mems[b][j]
            assert got == [int(want[f][b, j]) for f in range(1, 6)], (b, j)
    assert sum(w["mem_n"] > 0 for w in walks) > q.shape[0] // 2
    if form == "warp" and cap > 3:
        assert sw.wide_rounds > 0


@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("min_len,max_intv", [(19, 20), (12, 5)])
def test_strategy1_walks_match_plain(genome, occ_r, coords, min_len,
                                     max_intv):
    """K10b's walks, 32 / 2R reads a warp, against
    seed_strategy1_batch_plain:
    ret, found and the interval equal, and each read makes one lookup for
    each extension the plain version takes."""
    fm, q, ql = genome
    tt = _tree(fm, occ_r, coords)
    rng = np.random.default_rng(occ_r + min_len)
    B = q.shape[0]
    x = np.array([rng.integers(0, max(1, n)) for n in ql], np.int32)
    active = rng.random(B) < 0.9
    want = fm_ops.seed_strategy1_batch_plain(
        tt, torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(x),
        min_len, max_intv, torch.from_numpy(active))
    sw = SmemWarps(tt, torch.from_numpy(q), torch.from_numpy(ql), 1)
    walks = [sw.start(b, int(x[b]), 1, max_intv, bool(active[b]), s1=True,
                      min_len=min_len) for b in range(B)]
    sw.run(walks)
    assert [w["ret"] for w in walks] == want[0].tolist()
    assert [w["found"] for w in walks] == want[1].tolist()
    for f in range(3):
        assert [w["r"][f] if w["found"] else 0 for w in walks] \
            == want[2 + f].tolist()
    # the plain version's extensions of each read, one a base from x + 1
    # up to the hit, an N or the read's end
    for b in range(B):
        n = 0
        if active[b] and x[b] < ql[b] and q[b, x[b]] < 4:
            i = x[b] + 1
            while i < ql[b] and q[b, i] < 4:
                n += 1
                if want[1][b] and i + 1 == want[0][b]:
                    break
                i += 1
        assert sw.lookups[b] == n, b
    assert bool(want[1].any())


@pytest.mark.parametrize("x,active,form", [
    ([0, 0, 0, 0], [True, True, True, False], "group"),
    ([0, 5, 0, 0], [True, False, True, True], "group"),
    ([0, 5, 0, 0], [True, True, True, True], "warp"),
    ([150, 0], [True, True], "warp")])
def test_smem1a_form_rule(x, active, form):
    """K10a's form: the group form when no active read starts past 0 (the
    backward pass then needs no lookup), else the warp form; from tensors
    or from the host's arrays, as BatchedFMEngine.smem_pass passes them."""
    assert fm_ops.smem1a_form(torch.tensor(x, dtype=torch.int32),
                              torch.tensor(active)) == form
    assert fm_ops.smem1a_form(np.array(x, np.int32), np.array(active)) \
        == form


@pytest.mark.parametrize("caller,form", [
    ("dryrun", "group"), ("mesh_from_0", "group"), ("mesh_inside", "warp")])
def test_callers_pick_the_form_on_the_host(monkeypatch, caller, form):
    """The dry run's entry() and sharded_seed_step pick K10a's form from
    the host's x and qlen before they upload them (smem1a_form) and hand
    it to smem1a_batch, whose own default never reads a card."""
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex
    from bwa_tpu_torch.parallel import dryrun, mesh

    seen, real = [], fm_ops.smem1a_batch

    def spy(*args, **kw):
        seen.append(kw.get("form"))
        return real(*args, **kw)

    monkeypatch.setattr(fm_ops, "smem1a_batch", spy)
    if caller == "dryrun":
        fn, args = dryrun.entry("cpu")
        fn(*args)
    else:
        tiny = dryrun._tiny_index()
        q = dryrun._tiny_reads(tiny)
        B, L = q.shape
        x = np.zeros(B, np.int32) if caller == "mesh_from_0" else \
            np.random.default_rng(5).integers(1, 90, B).astype(np.int32)
        m = mesh.make_mesh(devices=["cpu", "cpu"])
        trees = {m.devices[0]: DeviceFMIndex(tiny, device="cpu").tree()}
        mesh.sharded_seed_step(trees, m, L + 2)(
            q, np.full(B, L, np.int32), x)
    assert seen and set(seen) == {form}
