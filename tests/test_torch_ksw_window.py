"""K5's window decomposition (ops/ksw_full.py::window_rows: each problem
swept by the band DP in a window of roundup_128(2w + 2) columns sliding one
column a row) against the full-width sweep it replaces (full_rows), on the
CPU, exactly; and the launch order K5's wrapper builds (window_classes)."""

import numpy as np
import pytest
import torch

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)

MAT = np.full((5, 5), -4, np.int64)
np.fill_diagonal(MAT, 1)
MAT[4, :] = MAT[:, 4] = -1


def _problems(seed, n, Q, T, w_lo, w_hi, h0_hi=60, qlens=None):
    """n problems over query rows of Q codes (QP = roundup_128(Q + 1)
    columns, code 4 past the query) and T target rows that hold a mutated
    copy of the query from their third base on; bands from [w_lo, w_hi)."""
    rng = np.random.default_rng(seed)
    QP = -(-(Q + 1) // 128) * 128
    qs = np.full((n, QP), 4, np.uint8)
    qs[:, :Q] = rng.integers(0, 4, (n, Q))
    ts = rng.integers(0, 4, (n, T)).astype(np.uint8)
    lim = min(Q, T - 2)
    ts[:, 2:2 + lim] = np.where(rng.random((n, lim)) < 0.9, qs[:, :lim],
                                ts[:, 2:2 + lim])
    ql = rng.integers(Q // 2, Q + 1, n) if qlens is None else np.asarray(qlens)
    tl = rng.integers(T // 2, T + 1, n)
    w = rng.integers(w_lo, w_hi, n)
    h0 = rng.integers(0, h0_hi, n)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
    return (torch.as_tensor(qs), torch.as_tensor(ts), t(ql), t(tl), t(w),
            t(h0))


# (name, problems, zdrop): every case mixes several windows
CASES = {
    "ragged": (dict(seed=1, n=24, Q=300, T=260, w_lo=1, w_hi=200), 100),
    "w_past_qlen": (dict(seed=2, n=12, Q=90, T=200, w_lo=90, w_hi=700), 100),
    "qlen_0_1_2": (dict(seed=3, n=9, Q=40, T=60, w_lo=1, w_hi=80,
                        qlens=[0, 1, 2, 0, 1, 2, 0, 1, 2]), 100),
    "h0_past_window": (dict(seed=4, n=10, Q=700, T=150, w_lo=2, w_hi=200,
                            h0_hi=600), 100),
    "zdrop_off": (dict(seed=5, n=16, Q=400, T=400, w_lo=1, w_hi=600), -1),
    "zdrop_tight": (dict(seed=6, n=16, Q=400, T=400, w_lo=1, w_hi=600), 5),
    "q_past_4096": (dict(seed=7, n=4, Q=4300, T=120, w_lo=20, w_hi=2300),
                    100),
}


@pytest.mark.parametrize("name", list(CASES))
def test_window_rows_match_full_rows(name):
    from bwa_tpu_torch.ops.ksw_band import _band_for
    from bwa_tpu_torch.ops.ksw_full import full_rows, window_rows

    kw, zdrop = CASES[name]
    qs, ts, ql, tl, w, h0 = _problems(**kw)
    rest = (MAT, 6, 1, 6, 1, zdrop)
    want = full_rows(qs, ts, ql, tl, w, h0, *rest)
    got = window_rows(qs, ts, ql, tl, w, h0, *rest)
    assert torch.equal(got, want)
    assert len(set(_band_for(w).tolist())) >= 2  # several window classes
    assert int(want[:, 6].max()) > 1


def test_window_classes_order():
    """Problems ordered by window class (128 to 1024 slots, then wider),
    longest target first inside a class; counts per class and the widest
    window of the last class."""
    from bwa_tpu_torch.ops.ksw_full import K5_CLASSES, window_classes

    rng = np.random.default_rng(8)
    w = rng.integers(1, 1500, 200)
    tlen = rng.integers(0, 900, 200)
    P, perm, counts, p_wide = window_classes(w, tlen)
    assert np.array_equal(P, (2 * w + 2 + 127) // 128 * 128)
    assert sorted(perm.tolist()) == list(range(200))
    cls = np.minimum(P // 128 - 1, K5_CLASSES - 1)[perm]
    assert (cls[1:] >= cls[:-1]).all()
    assert counts == np.bincount(cls, minlength=K5_CLASSES).tolist()
    t = tlen[perm]
    same = cls[1:] == cls[:-1]
    assert (t[1:][same] <= t[:-1][same]).all()
    assert p_wide == int(P[P > 1024].max())
