"""Banded ksw_extend2 in band-relative coordinates: the plain PyTorch
version and its kernel (K2, csrc/ksw_band.cu).

Semantics are those of the JAX package's Pallas kernel
bwa_tpu/ops/ksw_pallas.py::_mk_band_kernel: the band is P columns wide,
p = j - (i - W) with W = P/2 - 1, so the diagonal dependency stays in
place, the band slides one slot per target row, and F is an in-row
prefix max.  Exact ksw_extend2 behaviour is kept (ksw.c:416-515): the
adaptive beg/end band with stale cells, the first-row eh init, z-drop, h0
seeding, gscore/max_ie/max_off bookkeeping and every tie rule.

ksw_band_side runs one extension pass over per-job coordinates (query
windows from the flat read codes, target rows from the 2-bit .pac);
ksw_band_arrays runs it over host-built query and target code rows (K2's
host-array mode, the JAX package's extend_band_pallas).  A CUDA tensor
launches K2, a CPU tensor runs the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 30)

# launches of the K2 kernel: gather mode (ksw_band_side) and host-array
# mode (ksw_band_arrays); each CUDA wrapper below adds one per launch
launches = 0
array_launches = 0

# widest band K2 takes: up to 4 band slots per thread, 1024 threads a block
K2_MAX_BAND = 4096


def _band_for(w_max: int) -> int:
    """Band width P for a largest post-clamp w: roundup_128(2w + 2)."""
    return -(-(2 * w_max + 2) // 128) * 128


def _sweep(H, E, QB, ts, qlen, tlen, w, h0, mat, W: int, o_del: int,
           e_del: int, o_ins: int, e_ins: int, zdrop: int, slide=None):
    """The ksw_extend2 row recurrence shared by the band DP (band_rows) and
    the full-width DP (ops/ksw_full.py::full_rows).  H, E, QB [N, P] int64
    hold the row-0 state.  slide(i, H, E, QB), when given, moves the band
    one column right before every row i > 0, and slot p is query column
    j = p + i - W at row i; without it slot p is column p (the full
    width).  ts [N, T]
    target codes; qlen, tlen, w, h0 [N] int64.  Returns [N, 7] int32:
    score, qle, tle, gtle, gscore, max_off, and the number of target rows
    swept (a work diagnostic)."""
    dev = H.device
    i64 = torch.int64
    N, P = H.shape
    mat = torch.as_tensor(np.asarray(mat, np.int64).reshape(-1), device=dev)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    colp = torch.arange(P, dtype=i64, device=dev)[None, :]
    W_ = torch.where
    z = torch.zeros(N, dtype=i64, device=dev)
    beg, end, mx = z.clone(), qlen.clone(), h0.clone()
    mx_i, mx_j, mx_ie, gsc = (torch.full((N,), -1, dtype=i64, device=dev)
                              for _ in range(4))
    mx_off = z.clone()
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    rows = z.clone()
    negs = torch.full((N, P), NEG, dtype=i64, device=dev)
    for i in range(ts.shape[1]):
        act = ~done & (i < tlen)
        if not bool(act.any()):
            break  # no later row can change an output
        rows = torch.where(act, torch.full_like(rows, i + 1), rows)
        if slide is not None and i > 0:
            H, E, QB = slide(i, H, E, QB)
        colj = colp + (i - W) if slide is not None else colp
        beg_r = torch.maximum(beg, torch.full_like(beg, i) - w)
        end_r = torch.minimum(torch.minimum(end, i + w + 1), qlen)
        h1 = (h0 - (o_del + e_del * (i + 1))).clamp(min=0)
        h1_init = W_(beg_r == 0, h1, z)
        S = mat[ts[:, i:i + 1] * 5 + QB]
        inband = (colj >= beg_r[:, None]) & (colj < end_r[:, None])
        M = W_(H != 0, H + S, torch.zeros_like(H))
        M = W_(inband, M, negs)
        e_cur = W_(inband, E, negs)
        g = W_(inband, (M - oe_ins).clamp(min=0), negs)
        run = torch.cummax(g + colj * e_ins, dim=1).values
        F = torch.cat([negs[:, :1], run[:, :-1]], dim=1) - (colj - 1) * e_ins
        F = W_(colp >= 1, F, negs)
        F = W_(colj == beg_r[:, None], torch.zeros_like(F), F)
        F = W_(inband, F, negs)
        Hrow = torch.maximum(torch.maximum(M, e_cur), F)
        Hrow = W_(inband, Hrow, negs)
        mrow = Hrow.max(dim=1).values.clamp(min=0)
        is_max = (Hrow == mrow[:, None]) & inband & (mrow[:, None] > 0)
        mj = W_(is_max, colj, torch.full_like(colj, -1)).max(dim=1).values
        mj = W_(mrow > 0, mj, torch.full_like(mj, -1))
        at = colj == (end_r - 1).clamp(min=0)[:, None]
        h_last = W_(at, Hrow, torch.zeros_like(Hrow)).sum(dim=1)
        h_last = W_(end_r > beg_r, h_last, h1_init)
        better = act & (end_r == qlen) & (h_last >= gsc)
        mx_ie = W_(better, torch.full_like(mx_ie, i), mx_ie)
        gsc = W_(better, torch.maximum(h_last, gsc), gsc)
        t_del = (M - oe_del).clamp(min=0)
        Enew = torch.maximum(e_cur - e_del, t_del)
        Hsh = W_(colj >= 1, torch.roll(Hrow, 1, dims=1), h1_init[:, None])
        wr = inband & act[:, None]
        H2 = W_(wr, Hsh, H)
        E2 = W_(wr, Enew, E)
        endw = (colj == end_r[:, None]) & act[:, None]
        H2 = W_(endw, h_last[:, None].expand_as(H2), H2)
        E2 = W_(endw, torch.zeros_like(E2), E2)

        brk0 = act & (mrow == 0)
        imp = act & ~brk0 & (mrow > mx)
        mx_i = W_(imp, torch.full_like(mx_i, i), mx_i)
        mx_off = W_(imp, torch.maximum(mx_off, (mj - i).abs()), mx_off)
        mx_j = W_(imp, mj, mx_j)
        zd = act & ~brk0 & ~imp & (zdrop > 0)
        d_i = i - mx_i
        d_j = mj - mx_j
        zcond = W_(d_i > d_j, mx - mrow - (d_i - d_j) * e_del > zdrop,
                   mx - mrow - (d_j - d_i) * e_ins > zdrop)
        brkz = zd & zcond
        mx = W_(imp, mrow, mx)

        nz = ~((H2 == 0) & (E2 == 0))
        in_lo = (colj >= beg_r[:, None]) & (colj < end_r[:, None])
        first_nz = W_(nz & in_lo, colj, torch.full_like(colj, 0x3fffffff)
                      ).min(dim=1).values
        beg_n = torch.minimum(first_nz, end_r)
        in_hi = (colj >= beg_n[:, None]) & (colj <= end_r[:, None])
        last_nz = W_(nz & in_hi, colj.expand(N, P), (beg_n - 1)[:, None]
                     .expand(N, P)).max(dim=1).values
        end_n = torch.minimum(last_nz + 2, qlen)
        upd = act & ~brk0 & ~brkz
        beg = W_(upd, beg_n, beg)
        end = W_(upd, end_n, end)
        done = done | brk0 | brkz
        H, E = H2, E2
    return torch.stack([mx, mx_j + 1, mx_i + 1, mx_ie + 1, gsc, mx_off,
                        rows], dim=1).to(torch.int32)


def band_rows(qb0, qn, ts, qlen, tlen, w, h0, mat, P: int, W: int,
              o_del: int, e_del: int, o_ins: int, e_ins: int, zdrop: int):
    """The plain band DP.  qb0 [N, P] query codes of the row-0 window
    (q[p - W]); qn [N, T] the code entering slot P-1 at row i
    (q[i - W + P - 1]); ts [N, T] target codes; qlen, tlen, w, h0 [N].
    Returns [N, 7] int32: score, qle, tle, gtle, gscore, max_off, and
    the number of target rows swept (a work diagnostic)."""
    dev = qb0.device
    i64 = torch.int64
    N = qb0.shape[0]
    qb0, qn, ts = qb0.to(i64), qn.to(i64), ts.to(i64)
    qlen, tlen, w, h0 = (a.to(i64) for a in (qlen, tlen, w, h0))
    e1 = (h0 - (o_ins + e_ins)).clamp(min=0)[:, None]
    ql2 = qlen[:, None]
    h02 = h0[:, None]
    W_ = torch.where

    def eh_init(j):
        fill = e1 - (j - 1) * e_ins
        prev = e1 - (j - 2) * e_ins
        keep = (j >= 2) & (prev > e_ins) & (j <= ql2)
        v = W_(j == 0, h02, W_(j == 1, e1, W_(keep, fill,
                                              torch.zeros_like(fill))))
        return W_((j >= 0) & (j <= ql2), v, torch.zeros_like(v))

    zc = torch.zeros((N, 1), dtype=i64, device=dev)

    def slide(i, H, E, QB):
        """Slot p takes slot p+1; slot P-1 takes q[i-W+P-1] with its
        first-row eh init (stale cells keep their init)."""
        h_ent = eh_init(torch.full((N, 1), i - W + P - 1, dtype=i64,
                                   device=dev))
        return (torch.cat([H[:, 1:], h_ent], dim=1),
                torch.cat([E[:, 1:], zc], dim=1),
                torch.cat([QB[:, 1:], qn[:, i:i + 1]], dim=1))

    colp = torch.arange(P, dtype=i64, device=dev)[None, :]
    return _sweep(eh_init(colp - W), torch.zeros((N, P), dtype=i64,
                                                 device=dev),
                  qb0.clone(), ts, qlen, tlen, w, h0, mat, W, o_del, e_del,
                  o_ins, e_ins, zdrop, slide)


def _q_gather(qflat, qbase, qdir, qlen, j):
    """Read codes at query offsets j [N, K] (band space); 4 outside
    [0, qlen)."""
    valid = (j >= 0) & (j < qlen[:, None])
    idx = (qbase[:, None] + qdir[:, None] * j).clamp(0, qflat.shape[0] - 1)
    code = qflat[idx].to(torch.int64)
    return torch.where(valid, code, torch.full_like(code, 4))


def _pac_gather(pac, l_pac: int, pos, valid):
    """Codes at doubled-genome positions (0..3; 4 where ~valid), reverse
    complement on the reverse half (bns_get_seq)."""
    two_l = 2 * l_pac
    pc = pos.clamp(0, two_l - 1)
    fwd = pc < l_pac
    f = torch.where(fwd, pc, two_l - 1 - pc)
    code = (pac[f >> 2].to(torch.int64) >> (((~f) & 3) << 1)) & 3
    code = torch.where(fwd, code, 3 - code)
    return torch.where(valid, code, torch.full_like(code, 4))


def ksw_band_side_plain(pac, l_pac, qflat, qbase, qdir, qlen, tbase, tdir,
                        tlen, w, h0, mat, o_del, e_del, o_ins, e_ins, zdrop,
                        P: int):
    """The plain version of K2: gather the band-space inputs, run the DP."""
    dev = qbase.device
    i64 = torch.int64
    W = P // 2 - 1
    qbase, qdir, qlen, tbase, tdir, tlen = (
        a.to(i64) for a in (qbase, qdir, qlen, tbase, tdir, tlen))
    T = max(1, int(tlen.max()) if tlen.numel() else 1)
    colp = torch.arange(P, dtype=i64, device=dev)[None, :]
    coli = torch.arange(T, dtype=i64, device=dev)[None, :]
    qb0 = _q_gather(qflat, qbase, qdir, qlen, colp - W)
    qn = _q_gather(qflat, qbase, qdir, qlen, coli - W + P - 1)
    ts = _pac_gather(pac, l_pac, tbase[:, None] + tdir[:, None] * coli,
                     coli < tlen[:, None])
    return band_rows(qb0, qn, ts, qlen, tlen, w, h0, mat, P, W, o_del,
                     e_del, o_ins, e_ins, zdrop)


def ksw_band_side(pac, l_pac, qflat, qbase, qdir, qlen, tbase, tdir, tlen,
                  w, h0, mat, o_del, e_del, o_ins, e_ins, zdrop, P: int):
    """One extension pass over n jobs; returns [n, 7] int32 (score, qle,
    tle, gtle, gscore, max_off, rows swept).  ws must be band-clamped and <= P/2 - 1.
    A CUDA qbase launches kernel K2; a CPU qbase runs the plain version."""
    if not qbase.is_cuda:
        return ksw_band_side_plain(pac, l_pac, qflat, qbase, qdir, qlen,
                                   tbase, tdir, tlen, w, h0, mat, o_del,
                                   e_del, o_ins, e_ins, zdrop, P)
    global launches
    from bwa_tpu_torch.ops import cuda_kernels

    dev = qbase.device
    n = qbase.shape[0]
    if P > K2_MAX_BAND:
        raise ValueError(f"K2 takes bands up to P = {K2_MAX_BAND} "
                         f"(got P = {P})")
    for t in (pac, qflat):
        if not (t.is_cuda and t.dtype == torch.uint8 and t.is_contiguous()):
            raise ValueError("K2 needs contiguous uint8 CUDA pac/qflat")
    i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    i64 = lambda a: a.to(device=dev, dtype=torch.int64).contiguous()  # noqa: E731
    out = torch.empty((n, 7), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    cuda_kernels.ksw_band(
        pac, l_pac, qflat, i64(qbase), i32(qdir), i32(qlen), i64(tbase),
        i32(tdir), i32(tlen), i32(w), i32(h0),
        [int(v) for v in np.asarray(mat, np.int64).reshape(-1)], o_del,
        e_del, o_ins, e_ins, zdrop, P, out)
    launches += 1
    return out


def ksw_band_arrays_plain(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del,
                          o_ins, e_ins, zdrop, P: int):
    """The plain version of K2's host-array mode: the query windows come
    from the rows of qs [N, Q] (q[j] for j in [0, qlen), code 4 elsewhere),
    the target codes from the rows of ts [N, T] (tlen <= T)."""
    dev = qs.device
    i64 = torch.int64
    N, Q = qs.shape
    W = P // 2 - 1
    T = ts.shape[1]
    qlen = qlen.to(i64)
    qflat = qs.reshape(-1) if N * Q else torch.full((1,), 4, dtype=qs.dtype,
                                                    device=dev)
    qbase = torch.arange(N, dtype=i64, device=dev) * Q
    one = torch.ones(N, dtype=i64, device=dev)
    colp = torch.arange(P, dtype=i64, device=dev)[None, :]
    coli = torch.arange(T, dtype=i64, device=dev)[None, :]
    qb0 = _q_gather(qflat, qbase, one, qlen, colp - W)
    qn = _q_gather(qflat, qbase, one, qlen, coli - W + P - 1)
    return band_rows(qb0, qn, ts, qlen, tlen, w, h0, mat, P, W, o_del,
                     e_del, o_ins, e_ins, zdrop)


def ksw_band_arrays(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del, o_ins,
                    e_ins, zdrop, P: int):
    """One band pass over host-built rows: qs [N, Q] and ts [N, T] uint8
    codes, qlen <= Q, tlen <= T, w band-clamped and <= P/2 - 1.  Returns
    [N, 7] int32 (score, qle, tle, gtle, gscore, max_off, rows swept).  A
    CUDA qs launches K2 in host-array mode; a CPU qs runs the plain
    version."""
    if not qs.is_cuda:
        return ksw_band_arrays_plain(qs, ts, qlen, tlen, w, h0, mat, o_del,
                                     e_del, o_ins, e_ins, zdrop, P)
    global array_launches
    from bwa_tpu_torch.ops import cuda_kernels

    if P > K2_MAX_BAND:
        raise ValueError(f"K2 takes bands up to P = {K2_MAX_BAND} "
                         f"(got P = {P})")
    for t in (qs, ts):
        if not (t.is_cuda and t.dtype == torch.uint8 and t.is_contiguous()
                and t.dim() == 2 and t.shape[0] == qs.shape[0]):
            raise ValueError("K2 needs contiguous uint8 CUDA qs/ts rows")
    dev = qs.device
    i32 = lambda a: a.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    n = qs.shape[0]
    out = torch.empty((n, 7), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    cuda_kernels.ksw_band_arrays(
        qs, ts, i32(qlen), i32(tlen), i32(w), i32(h0),
        [int(v) for v in np.asarray(mat, np.int64).reshape(-1)], o_del,
        e_del, o_ins, e_ins, zdrop, P, out)
    array_launches += 1
    return out
