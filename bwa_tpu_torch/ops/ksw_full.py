"""ksw_extend2 over host-built query rows in absolute columns: the plain
PyTorch version and its kernel (K5, csrc/ksw_full.cu).

Semantics are those of the JAX package's Pallas kernel
bwa_tpu/ops/ksw_pallas.py::_mk_kernel: every target row scans all QP query
columns in absolute coordinates (nothing slides), QP = roundup_128(Q + 1)
so column qlen exists for the eh[qlen] end-slot write.  Exact ksw_extend2
behaviour is kept (ksw.c:416-515), with the first-row init of _mk_kernel
(eh[1] = max(h0 - o_ins - e_ins, 0) whatever qlen).  full_rows is that
full-width sweep, the plain version.

K5 sweeps each problem in a window of P = roundup_128(2w + 2) columns
that slides one column a row (K2's band DP, csrc/ksw_band.cuh), which
gives the same outputs: row i writes only columns i - w .. i + w + 1.
window_rows is that decomposition in plain PyTorch (tests only).

ksw_full takes host-built code rows: a CUDA tensor launches K5, a CPU
tensor runs the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from bwa_tpu_torch.ops.ksw_band import (_band_for, _q_gather, _sweep,
                                        band_rows, wide_scratch)

# launches of the K5 kernel (the CUDA wrapper below adds one per launch;
# a launch runs one grid per window class that has problems)
launches = 0

# window classes: P = 128 * (c + 1) for c < 8 (K2's warp path), then every
# wider window (K2's wide path, each problem at its own P)
K5_CLASSES = 9


def full_rows(qs, ts, qlen, tlen, w, h0, mat, o_del: int, e_del: int,
              o_ins: int, e_ins: int, zdrop: int):
    """The plain full-width DP.  qs [N, QP] query codes (4 past the query),
    ts [N, T] target codes (tlen <= T); qlen, tlen, w, h0 [N].  Returns
    [N, 7] int32: score, qle, tle, gtle, gscore, max_off, rows swept."""
    dev = qs.device
    i64 = torch.int64
    N, QP = qs.shape
    qlen, tlen, w, h0 = (a.to(i64) for a in (qlen, tlen, w, h0))
    col = torch.arange(QP, dtype=i64, device=dev)[None, :]
    e1 = (h0 - (o_ins + e_ins)).clamp(min=0)[:, None]
    keep = (col >= 2) & (e1 - (col - 2) * e_ins > e_ins) \
        & (col <= qlen[:, None])
    H = torch.where(col == 0, h0[:, None],
                    torch.where(col == 1, e1,
                                torch.where(keep, e1 - (col - 1) * e_ins,
                                            torch.zeros_like(col))))
    return _sweep(H, torch.zeros((N, QP), dtype=i64, device=dev),
                  qs.to(i64), ts.to(i64), qlen, tlen, w, h0, mat, 0, o_del,
                  e_del, o_ins, e_ins, zdrop)


def window_rows(qs, ts, qlen, tlen, w, h0, mat, o_del: int, e_del: int,
                o_ins: int, e_ins: int, zdrop: int):
    """K5's decomposition in plain PyTorch, full_rows's signature: the
    problems grouped by window (_band_for(w)), each group swept by the band
    DP (ksw_band.band_rows) at its window P, the query column j at slot
    p = j - (i - W), W = P/2 - 1, with K5's column-1 rule."""
    dev = qs.device
    i64 = torch.int64
    N = qs.shape[0]
    T = ts.shape[1]
    P_all = _band_for(w.to(i64))
    out = torch.zeros((N, 7), dtype=torch.int32, device=dev)
    for P in sorted(set(P_all.tolist())):
        r = (P_all == P).nonzero().flatten()
        W = P // 2 - 1
        q = qs[r]
        n = r.shape[0]
        base = torch.arange(n, dtype=i64, device=dev) * q.shape[1]
        one = torch.ones(n, dtype=i64, device=dev)
        qf = q.reshape(-1)
        ql = qlen[r].to(i64)
        qb0 = _q_gather(qf, base, one, ql, torch.arange(
            P, dtype=i64, device=dev)[None, :] - W)
        qn = _q_gather(qf, base, one, ql, torch.arange(
            T, dtype=i64, device=dev)[None, :] - W + P - 1)
        out[r] = band_rows(qb0, qn, ts[r], ql, tlen[r], w[r], h0[r], mat, P,
                           W, o_del, e_del, o_ins, e_ins, zdrop, col1=True)
    return out


def window_classes(w, tlen):
    """K5's launch plan from host arrays w and tlen [N]: each problem's
    window P, the problems in class order with the longest target first
    inside a class (both int32 numpy), the count of each of the K5_CLASSES
    classes and the widest window of the last class (ints)."""
    P = _band_for(np.asarray(w, np.int64))
    cls = np.minimum(P // 128 - 1, K5_CLASSES - 1)
    perm = np.lexsort((-np.asarray(tlen, np.int64), cls)).astype(np.int32)
    counts = np.bincount(cls, minlength=K5_CLASSES).tolist()
    p_wide = int(P[cls == K5_CLASSES - 1].max(initial=0))
    return P.astype(np.int32), perm, counts, p_wide


def ksw_full(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del, o_ins, e_ins,
             zdrop):
    """Extension over host-built rows: qs [N, QP] uint8 with QP >= Q + 1
    (roundup_128(Q + 1) from the entry point), ts [N, T] uint8, tlen <= T,
    w band-clamped.  Returns [N, 7] int32.  A CUDA qs launches K5; a CPU
    qs runs the plain version."""
    if not qs.is_cuda:
        return full_rows(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del,
                         o_ins, e_ins, zdrop)
    global launches
    from bwa_tpu_torch.ops import cuda_kernels

    n = qs.shape[0]
    for t in (qs, ts):
        if not (t.is_cuda and t.dtype == torch.uint8 and t.is_contiguous()
                and t.dim() == 2 and t.shape[0] == n):
            raise ValueError("K5 needs contiguous uint8 CUDA qs/ts rows")
    dev = qs.device
    i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    out = torch.empty((n, 7), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    w, tlen = i32(w), i32(tlen)
    # the plan on the host: one copy of w and tlen (the grids' sizes)
    wt = torch.stack([w, tlen]).cpu().numpy()
    pw, perm, counts, p_wide = window_classes(wt[0], wt[1])
    pw, perm = (torch.from_numpy(a).to(dev) for a in (pw, perm))
    cuda_kernels.ksw_full(
        qs, ts, i32(qlen), tlen, w, i32(h0),
        [int(v) for v in np.asarray(mat, np.int64).reshape(-1)], o_del,
        e_del, o_ins, e_ins, zdrop, perm, pw, counts, p_wide, out,
        wide_scratch(counts[-1], p_wide, dev))
    launches += 1
    return out
