"""The parallel form of a backward row (ops/fm_machine.py::bwd_row_resolve,
the way kernel K1 resolves a row's pushes, slots, emit and overflow for all
its entries at once) and the group form (bwd_row_serial, K1's refill mode:
one entry a step) against the plain machine's rule, one entry at a time
(the P_BWD micro-op of seed_machine_seg), and against each other.  Rows
are made from a seed with numpy; equality is exact."""

import numpy as np
import pytest
import torch

from bwa_tpu_torch.ops.fm_machine import bwd_row_resolve, bwd_row_serial


def sequential_row(ob2, keep, n0, last_x2, cap, emit_ok, rev):
    """seed_machine_seg's P_BWD micro-op, j = 0..pn-1: the target stack's
    final slots (slot -> entry), and what the row did."""
    pn = len(ob2)
    n, lx, ok = n0, last_x2, emit_ok
    push = np.zeros(pn, bool)
    slot = np.full(pn, -1)
    stack, emit, ovf = {}, -1, False
    read = [min(max(pn - 1 - j if rev else j, 0), cap - 1) for j in range(pn)]
    for j in range(pn):
        if keep[j]:
            if n == 0 and ok:  # can_emit; after it i + 1 == call_last_start
                emit, ok = j, False
        elif n == 0 or ob2[j] != lx:  # push_b
            s = min(n, cap - 1)
            ovf |= n >= cap
            stack[s] = j
            push[j], slot[j] = True, s
            n, lx = n + 1, ob2[j]
    return dict(read_slot=read, push=push, slot=slot, stack=stack, emit=emit,
                ovf=ovf, n=n, last_x2=lx)


def check_row(ob2, keep, n0, last_x2, cap, emit_ok, rev, rounds):
    want = sequential_row(ob2, keep, n0, last_x2, cap, emit_ok, rev)
    got = bwd_row_resolve(torch.from_numpy(ob2), torch.from_numpy(keep), n0,
                          last_x2, cap, emit_ok, rev, rounds)
    np.testing.assert_array_equal(got["read_slot"].numpy(), want["read_slot"])
    push = got["push"].numpy()
    np.testing.assert_array_equal(push, want["push"])
    np.testing.assert_array_equal(got["slot"].numpy()[push],
                                  want["slot"][push])
    wins = got["wins"].numpy()
    stack = {int(s): int(j) for j, s in
             zip(np.flatnonzero(wins), got["slot"].numpy()[wins])}
    assert stack == want["stack"]
    assert len(stack) == int(wins.sum())  # no two winners share a slot
    for k in ("emit", "ovf", "n", "last_x2"):
        assert got[k] == want[k], k
    return want


def random_rows(seed, n_rows, pn_hi, caps, p_keep, alphabet, n0s=(0,),
                emit_oks=(True, False), revs=(True, False)):
    rng = np.random.default_rng(seed)
    for _ in range(n_rows):
        pn = int(rng.integers(0, pn_hi + 1))
        yield (rng.integers(1, alphabet + 1, pn).astype(np.int64),
               rng.random(pn) < rng.choice(p_keep),
               int(rng.choice(n0s)), int(rng.integers(0, alphabet + 1)),
               int(rng.choice(caps)), bool(rng.choice(emit_oks)),
               bool(rng.choice(revs)))


# (seed, rows, longest row, stack caps, keep shares, size alphabet, n0
# choices, emit_ok choices, read order)
CASES = {
    "reversed": (1, 200, 20, (16, 64), (0.2, 0.5), 4, (0,), (True,), (True,)),
    "forward": (2, 200, 20, (16, 64), (0.2, 0.5), 4, (0,), (True,), (False,)),
    "pn_over_cap": (3, 200, 80, (1, 2, 3), (0.0, 0.2), 8, (0,), (True, False),
                    (True, False)),
    "ob2_ties": (4, 200, 40, (16, 64), (0.1, 0.3), 2, (0,), (True, False),
                 (True, False)),
    "all_kept": (5, 50, 40, (2, 16), (1.0,), 4, (0,), (True, False),
                 (True, False)),
    "emit_blocked": (6, 100, 20, (16,), (0.3, 0.8), 4, (0,), (False,),
                     (True, False)),
    "start_count": (7, 200, 40, (2, 16, 64), (0.0, 0.3), 3, (0, 1, 2, 5, 70),
                    (True, False), (True, False)),
    "longer_than_a_warp": (8, 40, 200, (64,), (0.0, 0.05), 6, (0,),
                           (True, False), (True, False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounds", [None, 1, 4, 16])
def test_bwd_row_resolve_matches_sequential(case, rounds):
    seen = dict(push=0, emit=0, ovf=0)
    for row in random_rows(*CASES[case]):
        want = check_row(*row, rounds)
        seen["push"] += int(want["push"].sum())
        seen["emit"] += want["emit"] >= 0
        seen["ovf"] += want["ovf"]
    if case == "all_kept":
        assert seen["push"] == 0 and seen["emit"] > 0
    if case == "emit_blocked":
        assert seen["emit"] == 0
    if case == "pn_over_cap":
        assert seen["ovf"] > 0
    if case in ("reversed", "forward"):
        assert seen["push"] > 0 and seen["emit"] > 0


def test_bwd_row_resolve_emits_only_at_the_first_entry():
    """With an empty target stack (every row of the machine) the emit can
    only be the row's first entry: any earlier unkept entry pushes."""
    for ob2, keep, _, lx, cap, ok, rev in random_rows(9, 300, 30, (4, 16),
                                                      (0.3, 0.7), 3):
        got = bwd_row_resolve(torch.from_numpy(ob2), torch.from_numpy(keep),
                              0, lx, cap, ok, rev, 4)
        first = bool(ok and len(keep) and keep[0])
        assert got["emit"] == (0 if first else -1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_row_serial_matches_sequential_and_resolve(case):
    """The group form's row, entry by entry, against the one-j-at-a-time
    rule and against the parallel form, field by field (rows longer than
    the stack cap among them: pn_over_cap, longer_than_a_warp)."""
    seen = dict(push=0, ovf=0)
    for ob2, keep, n0, lx, cap, ok, rev in random_rows(*CASES[case]):
        want = sequential_row(ob2, keep, n0, lx, cap, ok, rev)
        got = bwd_row_serial(torch.from_numpy(ob2), torch.from_numpy(keep),
                             n0, lx, cap, ok, rev)
        par = bwd_row_resolve(torch.from_numpy(ob2), torch.from_numpy(keep),
                              n0, lx, cap, ok, rev)
        np.testing.assert_array_equal(got["read_slot"].numpy(),
                                      want["read_slot"])
        push = got["push"].numpy()
        np.testing.assert_array_equal(push, want["push"])
        np.testing.assert_array_equal(got["slot"].numpy()[push],
                                      want["slot"][push])
        wins = got["wins"].numpy()
        assert {int(s_): int(j) for j, s_ in zip(np.flatnonzero(wins),
                                                 got["slot"].numpy()[wins])} \
            == want["stack"]
        for k in ("emit", "ovf", "n", "last_x2"):
            assert got[k] == want[k] == par[k], k
        for k in ("read_slot", "push", "wins"):
            assert torch.equal(got[k], par[k].cpu()), k
        assert torch.equal(got["slot"][got["push"]],
                           par["slot"][par["push"]].cpu())
        seen["push"] += int(push.sum())
        seen["ovf"] += want["ovf"]
    if case == "pn_over_cap":
        assert seen["ovf"] > 0
    if case in ("reversed", "forward"):
        assert seen["push"] > 0
