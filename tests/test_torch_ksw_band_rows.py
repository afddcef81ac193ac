"""The warp form of a band row (ops/ksw_band.py::warp_row, the way kernel
K2's warp path computes a target row: 32 lanes of S slots, a scan over a
lane's own slots plus an exclusive prefix of the lane totals, the row max
as two reductions, the next band's ends as two independent reductions)
against the plain row of the DP (sweep_row), one row at a time on random
and tie-heavy states, and as whole sweeps.  States are made from a seed
with numpy; equality is exact."""

import numpy as np
import pytest
import torch

from bwa_tpu_torch.ops.ksw_band import (NEG, band_rows, ksw_band_arrays_plain,
                                        sweep_row, warp_row, warp_slots)

torch.set_num_threads(1)

O_DEL, E_DEL, O_INS, E_INS = 6, 1, 6, 1
KEYS = ("beg_r", "end_r", "mrow", "mj", "h_last", "beg_n", "end_n", "H2",
        "E2")


def _mat(kind):
    if kind == "ties":  # one score for every pair: rows full of equal H
        return np.zeros((5, 5), np.int64)
    m = np.full((5, 5), -4, np.int64)
    np.fill_diagonal(m, 1)
    m[4, :] = m[:, 4] = -1
    return m


def random_states(seed, P, kind, N=48):
    """N row states of a band of P slots: H with zeros and stale NEG
    cells, E >= 0, query and target codes, the previous row's band
    (beg > end and empty bands included), qlen around and below W, and
    the row index i (one per call, so the batch shares it)."""
    rng = np.random.default_rng(seed)
    W = P // 2 - 1
    hi = 8 if kind == "ties" else 200
    H = rng.integers(0, hi, (N, P))
    H[rng.random((N, P)) < 0.3] = 0
    H[rng.random((N, P)) < 0.03] = NEG
    E = rng.integers(0, hi // 2, (N, P))
    E[rng.random((N, P)) < 0.5] = 0
    QB = rng.integers(0, 5, (N, P))
    if kind == "ties":  # a repetitive query
        QB = np.tile(np.arange(P) % 2, (N, 1))
    tc = rng.integers(0, 5, N)
    i = int(rng.choice([0, 1, W // 2, W, 3 * W + 7]))
    qlen = rng.integers(0, 3 * P, N)
    qlen[::5] = rng.integers(0, W + 1, len(qlen[::5]))
    lo = max(0, i - W - 8)
    beg = rng.integers(lo, i + W + 8, N)
    end = np.minimum(beg + rng.integers(-4, P + 8, N), qlen)
    end = np.maximum(end, 0)
    beg[::7] = 0
    w = rng.integers(1, W + 1, N)
    w[::3] = W
    h0 = rng.integers(0, 80, N)
    h0[::4] = 0
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
    return (t(H), t(E), t(QB), t(tc), i, t(beg), t(end), t(qlen), t(w),
            t(h0), t(_mat(kind).reshape(-1)), W)


# the warp path's bands: every multiple of 128 up to 1024, and widths
# that leave pad slots at the front of lane 0
PS = [32, 96, 128, 160, 256, 384, 512, 640, 768, 896, 1000, 1024]


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("P", PS)
def test_warp_row_matches_sweep_row(P, kind):
    for seed in range(6):
        st = random_states(1000 * P + seed, P, kind)
        want = sweep_row(*st, True, O_DEL, E_DEL, O_INS, E_INS)
        got = warp_row(*st, O_DEL, E_DEL, O_INS, E_INS)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), (seed, k)
    if kind == "ties":  # rows whose max several columns share
        assert int(want["mrow"].max()) > 0


def test_warp_slots_layout():
    """S slots a lane, a multiple of 4, and 32 lanes cover the band."""
    for P in range(32, 1025, 32):
        S = warp_slots(P)
        assert S % 4 == 0 and 32 * S >= P > 32 * (S - 4)


def _repeat_problems(seed, n, q, t, w):
    """Tandem-repeat targets and queries (row-max ties on most rows),
    ragged lengths, h0 = 0 on some problems and qlen < W on others."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 3)
    ref = np.tile(unit, max(q, t) // 3 + 2)
    qs = np.full((n, q), 4, np.uint8)
    ts = np.full((n, t), 4, np.uint8)
    ql = rng.integers(1, q + 1, n)
    tl = rng.integers(1, t + 1, n)
    for k in range(n):
        s = int(rng.integers(0, 3))
        qs[k, :ql[k]] = ref[s:s + ql[k]]
        ts[k, :tl[k]] = ref[:tl[k]]
    tl[0] = 0
    return (torch.as_tensor(qs), torch.as_tensor(ts), torch.as_tensor(ql),
            torch.as_tensor(tl), torch.full((n,), w), torch.as_tensor(
                np.where(np.arange(n) % 3 == 0, 0, rng.integers(1, 60, n))))


@pytest.mark.parametrize("zdrop", [100, -1])
@pytest.mark.parametrize("P", [128, 256, 512, 1024])
def test_warp_sweep_matches_band_rows(P, zdrop):
    """Whole sweeps through warp_row equal the plain DP's outputs, on
    ragged near-matching rows and on tandem repeats, z-drop on and off."""
    from bwa_tpu_torch.bench_kernel import ragged_problems

    W = P // 2 - 1
    qs, ql, ts, tl, mat, ws, h0 = ragged_problems(P, 12, P // 2 + 40, 300,
                                                  w_hi=W)
    cases = [(torch.as_tensor(qs), torch.as_tensor(ts), torch.as_tensor(ql),
              torch.as_tensor(tl), torch.as_tensor(np.minimum(ws, W)),
              torch.as_tensor(h0), mat),
             (*_repeat_problems(P + 1, 10, P // 2 + 40, 260, W), mat)]
    for qs, ts, ql, tl, w, h0, mat in cases:
        N, Q = qs.shape
        T = ts.shape[1]
        qpad = torch.full((N, W + Q + P + T), 4, dtype=torch.int64)
        qpad[:, W:W + Q] = qs.to(torch.int64)
        args = (qpad[:, :P], qpad[:, P - 1:P - 1 + T], ts.to(torch.int64),
                ql, tl, w, h0, mat, P, W, O_DEL, E_DEL, O_INS, E_INS, zdrop)
        want = band_rows(*args)
        got = band_rows(*args, row=warp_row)
        assert torch.equal(got, want)
        assert int(want[:, 6].max()) > 32  # rows past one 32-row chunk
    # the host-array plain version is the same DP
    assert torch.equal(ksw_band_arrays_plain(qs, ts, ql, tl, w, h0, mat,
                                             O_DEL, E_DEL, O_INS, E_INS,
                                             zdrop, P), want)


@pytest.mark.parametrize("P,ok", [(16, False), (32, True), (100, False),
                                  (1024, True), (1056, True), (1088, True),
                                  (2112, True), (4224, True), (4480, True),
                                  (26624, True), (0, False), (4100, False)])
def test_check_band(P, ok):
    """The bands K2 takes: every multiple of 32 from 32 on (the warp path
    up to 1024 slots, the wide path above, with no upper limit); anything
    else raises before a launch."""
    from bwa_tpu_torch.ops.ksw_band import check_band

    if ok:
        check_band(P)
    else:
        with pytest.raises(ValueError):
            check_band(P)
