"""Banded ksw_extend2 in band-relative coordinates: the plain PyTorch
version and its kernel (K2, csrc/ksw_band.cu; device code in
csrc/ksw_band.cuh).

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
launches K2, a CPU tensor runs the plain version.  K2 takes any band P
that is a multiple of 32: a warp per problem for P <= 1024 (warp_row is
that decomposition of a row in plain PyTorch) and a block per problem
above, its band in a ring in shared memory or, past WIDE_SMEM_BYTES, in a
global scratch band (wide_scratch); either way a launch that the card
refuses raises, and nothing falls back to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 30)

# launches of the K2 kernel: gather mode (ksw_band_side; wide_launches
# counts those at P > 1024, the wide path, again) and host-array mode
# (ksw_band_arrays); each CUDA wrapper below adds one per launch
launches = 0
wide_launches = 0
array_launches = 0

# shared memory the wide path's ring (9 bytes a slot) may take; a wider
# band runs from a global scratch band (csrc/ksw_band.cuh, the same value)
WIDE_SMEM_BYTES = 224 * 1024


def check_band(P: int) -> None:
    """Raise ValueError unless K2 takes a band of P slots: any multiple of
    32 from 32 on (the warp path up to 1024, the wide path above)."""
    if P < 32 or P % 32:
        raise ValueError(f"K2 takes bands of a multiple of 32 slots, from "
                         f"32 on (got P = {P})")


def wide_scratch(n: int, P: int, device):
    """The global ring band of n problems for K2's wide path at a band of P
    slots, when the ring passes WIDE_SMEM_BYTES: (uint8 buffer, bytes a
    problem); None when the ring fits in shared memory (or P <= 1024)."""
    stride = -(-9 * P // 16) * 16
    if P <= 1024 or stride <= WIDE_SMEM_BYTES:
        return None
    return torch.empty(n * stride, dtype=torch.uint8, device=device), stride


def _band_for(w_max):
    """Band width P for a largest post-clamp w: roundup_128(2w + 2) (an
    int, or elementwise on an int64 array or tensor: K5's windows)."""
    return -(-(2 * w_max + 2) // 128) * 128


def sweep_row(H, E, QB, tc, i: int, beg, end, qlen, w, h0, mat, W: int,
              banded: bool, o_del: int, e_del: int, o_ins: int, e_ins: int):
    """One target row i of the ksw_extend2 recurrence (ksw.c:454-495) over
    [N, P] slots, the row's slide already applied.  H, E, QB [N, P] int64:
    H(i-1, j-1), E(i-1, j) and the query code at each slot, where slot p
    is query column j = p + i - W when banded, p otherwise.  tc [N] the
    row's target codes; beg, end the band of the previous row; qlen, w, h0
    [N]; mat a 25-entry int64 tensor.  Returns a dict of [N] tensors
    (beg_r, end_r: the row's band; mrow, mj: the row max, clamped at 0,
    and its largest column, -1 when mrow is 0; h_last: H(i, end_r - 1), or
    the column-0 value when the band is empty; beg_n, end_n: the next
    row's band) and the state after the row, H2 and E2 [N, P] (slot p
    holding H(i, j - 1) and E(i+1, j) in band, its old values outside,
    and the eh[end_r] end cell)."""
    dev = H.device
    i64 = torch.int64
    N, P = H.shape
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    colp = torch.arange(P, dtype=i64, device=dev)[None, :]
    W_ = torch.where
    z = torch.zeros(N, dtype=i64, device=dev)
    negs = torch.full((N, P), NEG, dtype=i64, device=dev)
    colj = colp + (i - W) if banded else colp
    beg_r = torch.maximum(beg, torch.full_like(beg, i) - w)
    end_r = torch.minimum(torch.minimum(end, i + w + 1), qlen)
    h1 = (h0 - (o_del + e_del * (i + 1))).clamp(min=0)
    h1_init = W_(beg_r == 0, h1, z)
    S = mat[tc[:, None] * 5 + QB]
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
    t_del = (M - oe_del).clamp(min=0)
    Enew = torch.maximum(e_cur - e_del, t_del)
    Hsh = W_(colj >= 1, torch.roll(Hrow, 1, dims=1), h1_init[:, None])
    H2 = W_(inband, Hsh, H)
    E2 = W_(inband, Enew, E)
    endw = colj == end_r[:, None]
    H2 = W_(endw, h_last[:, None].expand_as(H2), H2)
    E2 = W_(endw, torch.zeros_like(E2), E2)
    nz = ~((H2 == 0) & (E2 == 0))
    first_nz = W_(nz & inband, colj, torch.full_like(colj, 0x3fffffff)
                  ).min(dim=1).values
    beg_n = torch.minimum(first_nz, end_r)
    in_hi = (colj >= beg_n[:, None]) & (colj <= end_r[:, None])
    last_nz = W_(nz & in_hi, colj.expand(N, P), (beg_n - 1)[:, None]
                 .expand(N, P)).max(dim=1).values
    end_n = torch.minimum(last_nz + 2, qlen)
    return dict(beg_r=beg_r, end_r=end_r, mrow=mrow, mj=mj, h_last=h_last,
                beg_n=beg_n, end_n=end_n, H2=H2, E2=E2)


def warp_slots(P: int) -> int:
    """Band slots per lane of K2's warp path (P <= 1024): P/32 rounded up
    to a multiple of 4 (four query codes a 32-bit register)."""
    return -(-P // 128) * 4


def _lane_scan_excl(tot):
    """Exclusive prefix max over the 32 lanes of tot [N, 32] as the warp
    computes it: five __shfl_up_sync steps, then one more shift; NEG for
    lane 0."""
    v = tot
    for o in (1, 2, 4, 8, 16):
        u = torch.cat([v[:, :o], v[:, :-o]], dim=1)  # lane l reads l - o
        v = torch.maximum(v, u)  # lanes below o read themselves
    return torch.cat([torch.full_like(v[:, :1], NEG), v[:, :-1]], dim=1)


def warp_row(H, E, QB, tc, i: int, beg, end, qlen, w, h0, mat, W: int,
             o_del: int, e_del: int, o_ins: int, e_ins: int):
    """sweep_row for a band (banded=True) computed the way K2's warp path
    computes it, in plain PyTorch.  The P slots are padded at the front to
    32 * S (S = warp_slots(P); a pad slot's column lies left of every
    band, so it is never in band) and cut into 32 lanes of S consecutive
    slots.  F is a scan over the lane's own slots plus an exclusive prefix
    max of the lane totals; the row max is two reductions (the max H, then
    the largest column holding it, each lane offering its largest column
    that holds its own max); the next band's first and last
    non-zero columns are two independent reductions over the in-band
    cells, with the eh[end_r] end cell added after them.  Returns
    sweep_row's dict."""
    dev = H.device
    i64 = torch.int64
    N, P = H.shape
    S = warp_slots(P)
    pad = 32 * S - P
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    W_ = torch.where

    def lanes(x, fill):
        x = torch.cat([torch.full((N, pad), fill, dtype=i64, device=dev), x],
                      dim=1)
        return x.reshape(N, 32, S)

    Hl, El, Ql = lanes(H, 0), lanes(E, 0), lanes(QB, 4)
    # column of slot k of lane l: l*S + k - pad + i - W
    col = (torch.arange(32 * S, dtype=i64, device=dev) - pad + i - W
           ).reshape(1, 32, S)
    b = lambda x: x[:, None, None]  # noqa: E731  a row scalar, per lane
    beg_r = torch.maximum(beg, torch.full_like(beg, i) - w)
    end_r = torch.minimum(torch.minimum(end, i + w + 1), qlen)
    h1 = (h0 - (o_del + e_del * (i + 1))).clamp(min=0)
    h1_init = W_(beg_r == 0, h1, torch.zeros_like(h1))
    inb = (col >= b(beg_r)) & (col < b(end_r))
    neg = torch.full_like(Hl, NEG)
    sc = mat[b(tc) * 5 + Ql]
    M = W_(inb, W_(Hl != 0, Hl + sc, torch.zeros_like(Hl)), neg)
    # no masks on g and E: outside the band g is 0 (M is NEG there), which
    # yields F <= 0 only, and a cell in band has H >= E >= 0, so F <= 0
    # never sets it; E outside the band is kept, not computed
    v = (M - oe_ins).clamp(min=0) + col * e_ins
    # F: the lane's inclusive scan shifted by one slot, the lanes below
    # as the prefix of slot 0
    run = torch.cummax(v, dim=2).values
    pre = _lane_scan_excl(run[:, :, -1])
    before = torch.cat([pre[:, :, None], torch.maximum(pre[:, :, None],
                                                       run[:, :, :-1])],
                       dim=2)
    F = before - (col - 1) * e_ins
    F = W_(col == b(beg_r), torch.zeros_like(F), F)
    Hrow = W_(inb, torch.maximum(torch.maximum(M, El), F), neg)
    En = torch.maximum(El - e_del, (M - oe_del).clamp(min=0))
    # the row max, then the largest column holding it: each lane's largest
    # column holding the lane's own max, offered where that max is the
    # row's
    lmax = Hrow.amax(dim=2)
    lcol = W_(Hrow == lmax[:, :, None], col.expand_as(Hrow),
              torch.full_like(Hrow, -1)).amax(dim=2)
    mrow = lmax.amax(dim=1).clamp(min=0)
    offer = W_(lmax == mrow[:, None], lcol, torch.full_like(lcol, -1))
    mj = W_(mrow > 0, offer.amax(dim=1), torch.full_like(mrow, -1))
    hl = W_(col == b(end_r) - 1, Hrow, torch.zeros_like(Hrow))
    h_last = W_(end_r > beg_r, hl.amax(dim=2).amax(dim=1), h1_init)
    # H(i, j - 1) from the slot below, across lanes by one shuffle; below
    # slot 0 of lane 0 lies slot P-1's column, never in band
    top = torch.cat([torch.full_like(Hrow[:, :1, -1:], NEG),
                     Hrow[:, :-1, -1:]], dim=1)
    below = torch.cat([top, Hrow[:, :, :-1]], dim=2)
    Hs = W_(col >= 1, below, b(h1_init))
    H2 = W_(inb, Hs, Hl)
    E2 = W_(inb, En, El)
    nz = inb & ~((H2 == 0) & (E2 == 0))
    big = torch.full_like(Hrow, 0x3fffffff)
    first = W_(nz, col.expand_as(Hrow), big).amin(dim=2).amin(dim=1)
    last = W_(nz, col.expand_as(Hrow), -big).amax(dim=2).amax(dim=1)
    endw = col == b(end_r)
    H2 = W_(endw, b(h_last).expand_as(H2), H2)
    E2 = W_(endw, torch.zeros_like(E2), E2)
    beg_n = torch.minimum(first, end_r)
    # the end cell counts when its column is a slot and h_last is not 0
    end_in = (h_last != 0) & (end_r >= i - W)
    last = W_(end_in, torch.maximum(last, end_r), last)
    end_n = torch.minimum(torch.maximum(last, beg_n - 1) + 2, qlen)
    cut = lambda x: x.reshape(N, 32 * S)[:, pad:]  # noqa: E731
    return dict(beg_r=beg_r, end_r=end_r, mrow=mrow, mj=mj, h_last=h_last,
                beg_n=beg_n, end_n=end_n, H2=cut(H2), E2=cut(E2))


def _sweep(H, E, QB, ts, qlen, tlen, w, h0, mat, W: int, o_del: int,
           e_del: int, o_ins: int, e_ins: int, zdrop: int, slide=None,
           row=None):
    """The ksw_extend2 row loop shared by the band DP (band_rows) and the
    full-width DP (ops/ksw_full.py::full_rows).  H, E, QB [N, P] int64
    hold the row-0 state.  slide(i, H, E, QB), when given, moves the band
    one column right before every row i > 0, and slot p is query column
    j = p + i - W at row i; without it slot p is column p (the full
    width).  row computes one row (sweep_row's signature minus banded;
    sweep_row by default): a test seam only, which no caller of the
    port sets, so that tests/test_torch_ksw_band_rows.py can sweep with
    warp_row.  ts [N, T] target codes; qlen, tlen, w, h0 [N]
    int64.  Returns [N, 7] int32: score, qle, tle, gtle, gscore, max_off,
    and the number of target rows swept (a work diagnostic)."""
    dev = H.device
    i64 = torch.int64
    N, P = H.shape
    mat = torch.as_tensor(np.asarray(mat, np.int64).reshape(-1), device=dev)
    if row is None:
        banded = slide is not None
        row = lambda *a: sweep_row(*a[:12], banded, *a[12:])  # noqa: E731
    W_ = torch.where
    z = torch.zeros(N, dtype=i64, device=dev)
    beg, end, mx = z.clone(), qlen.clone(), h0.clone()
    mx_i, mx_j, mx_ie, gsc = (torch.full((N,), -1, dtype=i64, device=dev)
                              for _ in range(4))
    mx_off = z.clone()
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    rows = z.clone()
    for i in range(ts.shape[1]):
        act = ~done & (i < tlen)
        if not bool(act.any()):
            break  # no later row can change an output
        rows = torch.where(act, torch.full_like(rows, i + 1), rows)
        if slide is not None and i > 0:
            H, E, QB = slide(i, H, E, QB)
        r = row(H, E, QB, ts[:, i], i, beg, end, qlen, w, h0, mat, W, o_del,
                e_del, o_ins, e_ins)
        mrow, mj, h_last = r["mrow"], r["mj"], r["h_last"]
        better = act & (r["end_r"] == qlen) & (h_last >= gsc)
        mx_ie = W_(better, torch.full_like(mx_ie, i), mx_ie)
        gsc = W_(better, torch.maximum(h_last, gsc), gsc)

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
        upd = act & ~brk0 & ~brkz
        beg = W_(upd, r["beg_n"], beg)
        end = W_(upd, r["end_n"], end)
        done = done | brk0 | brkz
        H = W_(act[:, None], r["H2"], H)
        E = W_(act[:, None], r["E2"], E)
    return torch.stack([mx, mx_j + 1, mx_i + 1, mx_ie + 1, gsc, mx_off,
                        rows], dim=1).to(torch.int32)


def band_rows(qb0, qn, ts, qlen, tlen, w, h0, mat, P: int, W: int,
              o_del: int, e_del: int, o_ins: int, e_ins: int, zdrop: int,
              row=None, col1: bool = False):
    """The plain band DP.  qb0 [N, P] query codes of the row-0 window
    (q[p - W]); qn [N, T] the code entering slot P-1 at row i
    (q[i - W + P - 1]); ts [N, T] target codes; qlen, tlen, w, h0 [N].
    row: _sweep's test seam (tests pass warp_row, which computes each
    row the way K2's warp path does; the port never sets it).  col1:
    column 1 starts at e1 whatever qlen (K5's rule, ops/ksw_full.py).
    Returns
    [N, 7] int32: score, qle, tle, gtle, gscore, max_off, and the number
    of target rows swept (a work diagnostic)."""
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
        keep = (j >= 0) & (j <= ql2)
        return W_(keep | ((j == 1) & col1), v, torch.zeros_like(v))

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
                  o_ins, e_ins, zdrop, slide, row)


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
    tle, gtle, gscore, max_off, rows swept).  ws must be band-clamped and
    <= P/2 - 1.  A CUDA qbase launches kernel K2 (a warp per job for
    P <= 1024, a block per job above) or raises; a CPU qbase runs the
    plain version."""
    if not qbase.is_cuda:
        return ksw_band_side_plain(pac, l_pac, qflat, qbase, qdir, qlen,
                                   tbase, tdir, tlen, w, h0, mat, o_del,
                                   e_del, o_ins, e_ins, zdrop, P)
    global launches, wide_launches
    from bwa_tpu_torch.ops import cuda_kernels

    dev = qbase.device
    n = qbase.shape[0]
    check_band(P)
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
        e_del, o_ins, e_ins, zdrop, P, out, wide_scratch(n, P, dev))
    launches += 1
    wide_launches += int(P > 1024)
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
    CUDA qs launches K2 in host-array mode (a warp per problem for
    P <= 1024, a block per problem above) or raises; a CPU qs runs the
    plain version."""
    if not qs.is_cuda:
        return ksw_band_arrays_plain(qs, ts, qlen, tlen, w, h0, mat, o_del,
                                     e_del, o_ins, e_ins, zdrop, P)
    global array_launches
    from bwa_tpu_torch.ops import cuda_kernels

    check_band(P)
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
        e_del, o_ins, e_ins, zdrop, P, out, wide_scratch(n, P, dev))
    array_launches += 1
    return out
