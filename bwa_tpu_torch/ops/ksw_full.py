"""Full-width ksw_extend2: the plain PyTorch version and its kernel (K5,
csrc/ksw_full.cu).

Semantics are those of the JAX package's Pallas kernel
bwa_tpu/ops/ksw_pallas.py::_mk_kernel: every target row scans all QP query
columns in absolute coordinates (nothing slides), QP = roundup_128(Q + 1)
so column qlen exists for the eh[qlen] end-slot write.  Exact ksw_extend2
behaviour is kept (ksw.c:416-515), with the first-row init of _mk_kernel
(eh[1] = max(h0 - o_ins - e_ins, 0) whatever qlen).

ksw_full takes host-built code rows: a CUDA tensor launches K5, a CPU
tensor runs the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from bwa_tpu_torch.ops.ksw_band import _sweep

# launches of the K5 kernel (the CUDA wrapper below adds one per launch)
launches = 0

# widest query row K5 takes: up to 4 columns per thread, 1024 threads a block
K5_MAX_QP = 4096


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


def ksw_full(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del, o_ins, e_ins,
             zdrop):
    """Full-width extension over host-built rows: qs [N, QP] uint8 with
    QP = roundup_128(Q + 1), ts [N, T] uint8, tlen <= T, w band-clamped.
    Returns [N, 7] int32.  A CUDA qs launches K5; a CPU qs runs the plain
    version."""
    if not qs.is_cuda:
        return full_rows(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del,
                         o_ins, e_ins, zdrop)
    global launches
    from bwa_tpu_torch.ops import cuda_kernels

    n, QP = qs.shape
    if QP > K5_MAX_QP or QP % 128:
        raise ValueError(f"K5 takes query rows of a multiple of 128 up to "
                         f"QP = {K5_MAX_QP} columns (got QP = {QP})")
    for t in (qs, ts):
        if not (t.is_cuda and t.dtype == torch.uint8 and t.is_contiguous()
                and t.dim() == 2 and t.shape[0] == n):
            raise ValueError("K5 needs contiguous uint8 CUDA qs/ts rows")
    dev = qs.device
    i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    out = torch.empty((n, 7), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    cuda_kernels.ksw_full(
        qs, ts, i32(qlen), i32(tlen), i32(w), i32(h0),
        [int(v) for v in np.asarray(mat, np.int64).reshape(-1)], o_del,
        e_del, o_ins, e_ins, zdrop, out)
    launches += 1
    return out
