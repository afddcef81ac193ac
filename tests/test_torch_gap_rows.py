"""The parts of kernels K7 and K7w (csrc/gap_machine.cu) in plain PyTorch,
held to the plain version's own rules (bwa_tpu_torch/ops/gap_machine.py):

- the group lookup (group_occ4_pair: the row split over 2R threads, the
  packed 10-bit sums and the exchange between the halves) against _occ4;
- the stack's bookkeeping (StackModel: the score lists' bitmap and heads,
  the next pop kept in registers, the free-slot stack and the chunk list,
  the packed record) against the plain version's key array, pop for pop;
- the hit bookkeeping strided over a group (gap_shadow's ranks from a
  ballot, the duplicate vote) against their serial forms.

The kernels run only on a card; these models are what they do, step by
step.  Inputs are made from a seed with numpy; equality is exact."""

import numpy as np
import pytest
import torch

from datagen import random_genome, write_fasta

from bwa_tpu_torch.ops import gap_machine as gm
from bwa_tpu_torch.ops.fm import _occ4


@pytest.fixture(scope="module")
def fm_index(tmp_path_factory):
    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex

    d = tmp_path_factory.mktemp("gap_rows")
    write_fasta(d / "g.fa", random_genome(40_000, seed=23, n_contigs=2))
    return FMIndex.load(index_build(str(d / "g.fa")))


def _tree(fm, occ_r, coords):
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex

    tt = DeviceFMIndex(fm, device="cpu", occ_r=occ_r).tree()
    if coords == "int64":
        tt = dict(tt, cdt=torch.int64, L2=tt["L2"].long())
    return tt


def _edge_ks(tt, rng, n):
    """k at -1, 0, around primary and seq_len, at row and word edges,
    and at random."""
    seq_len, primary = int(tt["seq_len"]), int(tt["primary"])
    per_row = 16 * (tt["occtab"].shape[1] - 4)
    ks = {-1, 0, 1, primary - 1, primary, primary + 1, seq_len - 1, seq_len}
    for r in range(0, seq_len, per_row * 7):
        ks |= {r - 1, r, r + 1, r + 15, r + 16, r + per_row - 1}
    ks = [k for k in ks if -1 <= k <= seq_len]
    ks += rng.integers(-1, seq_len + 1, n).tolist()
    return torch.tensor(ks, dtype=torch.int64)


@pytest.mark.parametrize("occ_r", [1, 4])
@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_group_occ4_pair_matches_occ4(fm_index, occ_r, coords):
    tt = _tree(fm_index, occ_r, coords)
    rng = np.random.default_rng(occ_r)
    ka = _edge_ks(tt, rng, 600)
    kb = ka[torch.from_numpy(rng.permutation(len(ka)))]
    # the first interval of a read: (-1, seq_len)
    ka = torch.cat([ka, torch.tensor([-1])])
    kb = torch.cat([kb, torch.tensor([int(tt["seq_len"])])])
    G = 2 * occ_r
    oa, ob = gm.group_occ4_pair(tt, ka, kb, G)
    want_a = _occ4(tt, ka).to(torch.int64)
    want_b = _occ4(tt, kb).to(torch.int64)
    for g in range(G):  # every thread of the group holds both
        assert torch.equal(oa[:, g], want_a), g
        assert torch.equal(ob[:, g], want_b), g


def test_group_occ4_pair_rejects_a_wrong_group(fm_index):
    tt = _tree(fm_index, 4, "int32")
    k = torch.tensor([0, 5])
    with pytest.raises(ValueError):
        gm.group_occ4_pair(tt, k, k, 2)


# ------------------------------------------------------------ the stack

class KeyStack:
    """The plain version's stack (gap_machine_plain): a key array of cap
    slots, key = score * 2^18 + (2^18 - 1 - seqno), SENT when free; the
    pop takes the least key, a push of valid-rank r the (r + 1)-th free
    slot."""

    def __init__(self, cap):
        self.keys = [gm.SENT] * cap
        self.ent = [None] * cap
        self.seqc, self.n_stk = 1, 0

    def root(self, e):
        self.keys[0] = gm.SEQ_CAP - 1
        self.ent[0] = dict(e)
        self.n_stk = 1

    def pop(self):
        slot = min(range(len(self.keys)), key=lambda s: self.keys[s])
        self.keys[slot] = gm.SENT
        self.n_stk -= 1
        return self.ent[slot]

    def push(self, kids):
        free = [s for s, k in enumerate(self.keys) if k == gm.SENT]
        r = 0
        for v, sc, e in kids:
            if v:
                if r < len(free):
                    s = free[r]
                    self.keys[s] = sc * gm.SEQ_CAP + (gm.SEQ_CAP - 1
                                                     - (self.seqc + r))
                    self.ent[s] = dict(e)
                r += 1
        self.seqc += r
        self.n_stk += min(r, len(free))
        return r, len(free)


PEN = (3, 11, 4)       # s_mm, s_gapo, s_gape
BOUNDS = (6, 2, 6)     # mm (md + 1), go (mg), ge (max_gape)


def _score(e):
    return e["mm"] * PEN[0] + e["go"] * PEN[1] + e["ge"] * PEN[2]


def _kids(rng, e, p_valid, p_match, big):
    """Nine children of e in the reference's push order: each adds at most
    one to mm, go or ge (within BOUNDS), the last (the exact-match child)
    usually none; the other fields at random within the record's
    widths."""
    kids = []
    for c in range(9):
        inc = [0, 0, 0]
        if c < 8 or rng.random() > p_match:
            f = int(rng.integers(0, 3))
            inc[f] = 1
        k = dict(mm=min(e["mm"] + inc[0], BOUNDS[0]),
                 go=min(e["go"] + inc[1], BOUNDS[1]),
                 ge=min(e["ge"] + inc[2], BOUNDS[2]),
                 i=int(rng.integers(0, gm.PACK_L + 1)),
                 ldp=int(rng.integers(0, gm.PACK_L + 1)),
                 st=int(rng.integers(0, 3)),
                 ins=int(rng.integers(0, 1 << 16)),
                 k=int(rng.integers(0, big)), l=int(rng.integers(0, big)))
        k["del"] = int(rng.integers(0, 1 << 16))
        kids.append((bool(rng.random() < p_valid), _score(k), k))
    return kids


def _lists_of(model):
    """Every slot on the model's score lists (each once) and how many."""
    seen = []
    for b in range(model.nb):
        if model.bits >> b & 1:
            s = model.heads[b]
            while s >= 0:
                seen.append(s)
                _, s = gm.unpack_record(model.pool[s], model.cdt, model.wide)
    return seen


# (seed, cap, steps, p_valid, p_match, p_drop, coords, wide); p_drop None:
# runs of 30 steps that push and 30 that only pop, so the pool fills, the
# free-slot stack spills and its chunks come back
STACK_CASES = {
    "default": (1, 256, 3000, 0.5, 0.9, 0.2, "int32", False),
    "churn": (2, 48, 4000, 0.9, 0.5, None, "int32", False),
    "full_pool": (3, 12, 2000, 0.9, 0.9, 0.05, "int32", False),
    "tiny_pool": (4, 2, 500, 0.7, 0.5, 0.3, "int32", False),
    "int64": (5, 64, 3000, 0.5, 0.8, 0.4, "int64", False),
    "wide_int32": (6, 64, 2000, 0.5, 0.8, 0.4, "int32", True),
    "wide_int64": (7, 40, 2000, 0.6, 0.7, 0.4, "int64", True),
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stack_model_matches_key_array(case):
    seed, cap, n_steps, p_valid, p_match, p_drop, coords, wide = \
        STACK_CASES[case]
    cdt = torch.int64 if coords == "int64" else torch.int32
    big = 1 << (40 if coords == "int64" else 31)
    rng = np.random.default_rng(seed)
    nb = gm.score_lists(BOUNDS[0] - 1, BOUNDS[1],
                        (*PEN, BOUNDS[2]))
    model, ref = gm.StackModel(cap, nb, cdt, wide), KeyStack(cap)
    root = dict(k=0, l=big - 1, i=100, mm=0, go=0, ge=0, ins=0, st=0,
                ldp=0)
    root["del"] = 0
    model.root(root)
    ref.root(root)
    seen = dict(cached=0, overflow=0, drops=0)
    for step in range(n_steps):
        if ref.n_stk == 0:
            break
        drop = p_drop if p_drop is not None else float(step // 30 % 2)
        # each step pops: the model's entry is the key array's least
        cached = model.nx is not None
        e, fslot = model.pop()
        want = ref.pop()
        assert e == want
        seen["cached"] += cached
        if rng.random() < drop:
            seen["drops"] += 1
            model.free(fslot)
        else:
            kids = _kids(rng, e, p_valid, p_match, big)
            got = model.push(_score(e), kids, fslot)
            n_push, nfree = ref.push(kids)
            assert got[:2] == (n_push, nfree)
            seen["overflow"] += n_push > nfree
            model.free(got[2])
        assert model.n_stk == ref.n_stk
        slots = _lists_of(model)
        assert len(slots) == len(set(slots)) == \
            model.n_stk - (model.nx is not None)
        assert model.hw <= cap
        assert not set(slots) & (set(model.fs) | {model.gfree})
    assert seen["cached"] > 0 and seen["drops"] > 0
    if case in ("full_pool", "tiny_pool"):
        assert seen["overflow"] > 0
    if case == "churn":
        assert model.loads > 0  # slots came back from the chunk list


@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("wide", [False, True])
def test_record_pack_roundtrip(coords, wide):
    cdt = torch.int64 if coords == "int64" else torch.int32
    rng = np.random.default_rng(11)
    lo, hi = (-(1 << 62), 1 << 62) if coords == "int64" else \
        (-(1 << 31), (1 << 31) - 1)
    top = dict(i=gm.PACK_L, ldp=gm.PACK_L, st=2, mm=gm.PACK_D,
               go=gm.PACK_D, ge=gm.PACK_D, ins=(1 << 16) - 1)
    for n in range(300):
        e = {f: int(rng.integers(0, v + 1)) if n else v
             for f, v in top.items()}
        e["del"] = int(rng.integers(0, 1 << 16)) if n else (1 << 16) - 1
        e["k"], e["l"] = (int(x) for x in rng.integers(lo, hi, 2))
        nxt = int(rng.integers(-1, 1 << 20))
        w = gm.pack_record(e, nxt, cdt, wide)
        assert len(w) * 4 == gm.slot_bytes(cdt, wide)
        assert all(-(1 << 31) <= x < (1 << 31) for x in w)
        assert gm.unpack_record(w, cdt, wide) == (e, nxt)


def test_wide_records_at_the_packed_widths():
    scal = (3, 11, 4, 6) + (0,) * 6
    i32 = torch.int32
    base = dict(L=128, md_max=5, mg_max=1, scal=scal, n_lists=56)
    assert not gm.wide_records(**base)
    assert gm.slot_bytes(i32) == gm.slot_bytes(torch.int64) == 32
    assert (gm.slot_bytes(i32, True), gm.slot_bytes(torch.int64, True)) \
        == (48, 64)
    for k, edge in (("L", gm.PACK_L), ("md_max", gm.PACK_D - 1),
                    ("mg_max", gm.PACK_D), ("n_lists", gm.PACK_LISTS)):
        assert not gm.wide_records(**dict(base, **{k: edge})), k
        assert gm.wide_records(**dict(base, **{k: edge + 1})), k
    assert gm.wide_records(**dict(base, scal=(3, 11, 4, gm.PACK_D + 1)
                                  + (0,) * 6))


# ------------------------------------------------------------ the hits

def _shadow_serial(w, x, tn, seq_len):
    """gap_shadow as bwtgap.c:86-96 writes it, one position at a time."""
    jj = 0
    for t in range(tn):
        if w[t, 0] == x:
            jj += 1
            w[t, 0] = seq_len - jj
            w[t, 1] = 1
        elif w[t, 0] > x:
            w[t, 0] -= x
    return w


@pytest.mark.parametrize("G", [2, 8])
def test_shadow_strided_matches_serial(G):
    rng = np.random.default_rng(G)
    seq_len = 1 << 20
    for _ in range(200):
        L = int(rng.choice([32, 64, 100, 128]))
        w = torch.from_numpy(rng.integers(1, 6, (L, 2))).to(torch.int64)
        x = int(rng.integers(1, 6))
        tn = int(rng.integers(0, L + 1))
        want = _shadow_serial(w.clone(), x, tn, seq_len)
        got = gm.shadow_strided(w.clone(), x, tn, seq_len, G)
        assert torch.equal(got, want)


@pytest.mark.parametrize("G", [2, 8])
def test_dup_strided_matches_serial(G):
    rng = np.random.default_rng(100 + G)
    for _ in range(300):
        cap_a = int(rng.choice([1, 2, 32, 64]))
        akl = torch.from_numpy(rng.integers(0, 4, (cap_a, 2)))
        na = int(rng.integers(0, cap_a + 1))
        hk, hl = (int(v) for v in rng.integers(0, 4, 2))
        want = any(int(akl[s, 0]) == hk and int(akl[s, 1]) == hl
                   for s in range(na))
        assert gm.dup_strided(akl, na, hk, hl, G) == want
