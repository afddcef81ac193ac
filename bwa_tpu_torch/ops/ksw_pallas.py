"""The extension kernel entry point over host arrays: drop-in equivalents
of ops/ksw_batch.py::extend_batch that take numpy code rows.

extend_batch_pallas runs the full-width DP (K5, ops/ksw_full.py) and
extend_band_pallas the band DP (K2 in host-array mode, ops/ksw_band.py),
as the JAX package's functions of the same names (bwa_tpu/ops/
ksw_pallas.py:296 and :648) run its two Pallas kernels.  Both clamp the
band on the host (ksw.c:435-443), pad the query and target rows with code
4 (targets to a multiple of 128 rows, as the TPU grid does) and return the
six ksw_extend2 outputs (score, qle, tle, gtle, gscore, max_off) as numpy
arrays.  device "cuda" (the default) launches the kernel; "cpu" runs its
plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from bwa_tpu_torch.ops.ext_gather import band_clamp
from bwa_tpu_torch.ops.ksw_band import _band_for, ksw_band_arrays
from bwa_tpu_torch.ops.ksw_full import ksw_full

TB = 128  # target rows are padded to a multiple of this


def device_rows(qs, qlens, ts, tlens, mat, o_del, e_del, o_ins, e_ins, ws,
                end_bonus, h0s, QP: int, device):
    """Device tensors: query rows padded to QP columns, target rows padded
    to Tp rows with code 4, the clamped band, and tlen capped at Tp (the
    TPU kernel sweeps Tp rows at most).  Returns (q, t, qlen, tlen, w, h0)."""
    qs = np.asarray(qs, np.uint8)
    ts = np.asarray(ts, np.uint8)
    N, Q = qs.shape
    T = ts.shape[1]
    Tp = max(TB, -(-T // TB) * TB)
    qsp = np.full((N, QP), 4, np.uint8)
    qsp[:, :Q] = qs
    tsp = np.full((N, Tp), 4, np.uint8)
    tsp[:, :T] = ts
    qlens = np.asarray(qlens, np.int64)
    mmax = int(np.asarray(mat).max())
    w = band_clamp(qlens, ws, mmax, o_del, e_del, o_ins, e_ins, end_bonus)
    tl = np.minimum(np.asarray(tlens, np.int64), Tp)
    dev = torch.device(device)

    def t(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

    return (t(qsp), t(tsp), t(qlens, np.int32), t(tl, np.int32),
            t(w, np.int32), t(np.asarray(h0s, np.int64), np.int32))


def _split(out):
    out = out.cpu().numpy()
    return tuple(out[:, k] for k in range(6))


def extend_batch_pallas(qs, qlens, ts, tlens, mat, o_del, e_del, o_ins,
                        e_ins, ws, end_bonus, zdrop, h0s, device="cuda"):
    """Full-width ksw_extend2 over qs [N, Q] and ts [N, T] code rows
    (K5 on a CUDA device)."""
    Q = np.asarray(qs).shape[1]
    QP = -(-(Q + 1) // 128) * 128  # room for the eh end slot
    mat = np.asarray(mat, np.int32).reshape(5, 5)
    q, t, ql, tl, w, h0 = device_rows(qs, qlens, ts, tlens, mat, o_del,
                                      e_del, o_ins, e_ins, ws, end_bonus,
                                      h0s, QP, device)
    return _split(ksw_full(q, t, ql, tl, w, h0, mat, int(o_del), int(e_del),
                           int(o_ins), int(e_ins), int(zdrop)))


def extend_band_pallas(qs, qlens, ts, tlens, mat, o_del, e_del, o_ins,
                       e_ins, ws, end_bonus, zdrop, h0s, device="cuda"):
    """Banded ksw_extend2 over qs [N, Q] and ts [N, T] code rows (K2 in
    host-array mode on a CUDA device); one band P for the batch, from the
    largest clamped w."""
    Q = max(1, np.asarray(qs).shape[1])
    mat = np.asarray(mat, np.int32).reshape(5, 5)
    q, t, ql, tl, w, h0 = device_rows(qs, qlens, ts, tlens, mat, o_del,
                                      e_del, o_ins, e_ins, ws, end_bonus,
                                      h0s, Q, device)
    P = _band_for(max(1, int(w.max()) if w.numel() else 1))
    return _split(ksw_band_arrays(q, t, ql, tl, w, h0, mat, int(o_del),
                                  int(e_del), int(o_ins), int(e_ins),
                                  int(zdrop), P))
