"""Batched full-width extension DP (exact ksw_extend2 semantics), plain
PyTorch: the executable spec the band kernel (ops/ksw_band.py, K2) is
tested against.  A port of the JAX package's ops/ksw_batch.py::extend_batch.

N independent problems run lock-step as a row scan over [N, Q+1] eh
state: F is a running max (torch.cummax), the H/E arrays persist across
rows and are written only inside each lane's band (+ the end cell), so
stale cells are read exactly as the reference does; a lane freezes on row
max 0 or z-drop.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 30)


def extend_batch(qs, qlens, ts, tlens, mat, o_del, e_del, o_ins, e_ins,
                 ws, end_bonus, zdrop, h0s):
    """qs: [N, Q] query codes; ts: [N, T] target codes; qlens, tlens, ws,
    h0s: [N]; mat: [5, 5].  Returns (score, qle, tle, gtle, gscore,
    max_off), each [N] int32."""
    i64 = torch.int64
    qs = torch.as_tensor(np.asarray(qs)).to(i64)
    ts = torch.as_tensor(np.asarray(ts)).to(i64)
    qlens, tlens, ws, h0 = (torch.as_tensor(np.asarray(a, np.int64))
                            for a in (qlens, tlens, ws, h0s))
    mat = torch.as_tensor(np.asarray(mat, np.int64)).reshape(5, 5)
    N, Q = qs.shape
    Tn = ts.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    W = torch.where
    cols = torch.arange(Q + 1, dtype=i64)[None, :]
    lane = torch.arange(N)

    # first eh row: eh[0]=h0, eh[1]=max(h0-oe_ins,0), then -e_ins while > e_ins
    e1 = (h0 - oe_ins).clamp(min=0)
    j_idx = cols[:, 1:]
    fill = e1[:, None] - (j_idx - 1) * e_ins
    prev_fill = torch.cat([e1[:, None], fill[:, :-1]], dim=1)
    keep = (prev_fill > e_ins) & (j_idx <= qlens[:, None]) & (j_idx >= 1)
    row1 = W(j_idx == 1, e1[:, None], W(keep, fill, torch.zeros_like(fill)))
    H = torch.cat([h0[:, None], row1], dim=1)
    chain_ok = torch.cat([torch.ones((N, 2), dtype=torch.bool),
                          torch.cumprod(keep[:, 1:].to(i64), dim=1).bool()],
                         dim=1)
    H = W(chain_ok, H, torch.zeros_like(H))
    E = torch.zeros((N, Q + 1), dtype=i64)

    # band clamp (ksw.c:435-443)
    mmax = int(mat.max())
    num_ins = qlens * mmax + end_bonus - o_ins
    max_ins = W(num_ins >= 0, num_ins // e_ins + 1, -((-num_ins) // e_ins) + 1)
    w = torch.minimum(ws, max_ins.clamp(min=1))
    num_del = qlens * mmax + end_bonus - o_del
    max_del = W(num_del >= 0, num_del // e_del + 1, -((-num_del) // e_del) + 1)
    w = torch.minimum(w, max_del.clamp(min=1))

    beg = torch.zeros(N, dtype=i64)
    end = qlens.clone()
    mx = h0.clone()
    mx_i, mx_j, mx_ie, gsc = (torch.full((N,), -1, dtype=i64)
                              for _ in range(4))
    mx_off = torch.zeros(N, dtype=i64)
    done = torch.zeros(N, dtype=torch.bool)
    c = cols[:, :Q]
    for i in range(Tn):
        act = ~done & (i < tlens)
        if not bool(act.any()):
            break
        tci = ts[:, i]
        beg_r = torch.maximum(beg, i - w)
        end_r = torch.minimum(torch.minimum(end, i + w + 1), qlens)
        h1_init = W(beg_r == 0, (h0 - (o_del + e_del * (i + 1))).clamp(min=0),
                    torch.zeros_like(h0))
        S = mat[tci[:, None], qs]
        inband = (c >= beg_r[:, None]) & (c < end_r[:, None])
        diag = H[:, :Q]
        M = W(diag != 0, diag + S, torch.zeros_like(diag))
        M = W(inband, M, torch.full_like(M, NEG))
        e_cur = W(inband, E[:, :Q], torch.full_like(M, NEG))
        g = W(inband, (M - oe_ins).clamp(min=0), torch.full_like(M, NEG))
        run = torch.cummax(g + c * e_ins, dim=1).values
        F = torch.cat([torch.full((N, 1), NEG, dtype=i64), run[:, :-1]],
                      dim=1) - (c - 1) * e_ins
        F = W(c == beg_r[:, None], torch.zeros_like(F), F)
        F = W(inband, F, torch.full_like(F, NEG))
        Hrow = torch.maximum(torch.maximum(M, e_cur), F)
        Hrow = W(inband, Hrow, torch.full_like(Hrow, NEG))
        mrow = Hrow.max(dim=1).values.clamp(min=0)
        is_max = (Hrow == mrow[:, None]) & inband & (mrow[:, None] > 0)
        mj = W(is_max, c, torch.full_like(c, -1)).max(dim=1).values
        mj = W(mrow > 0, mj, torch.full_like(mj, -1))
        h_last = W(end_r > beg_r, Hrow[lane, (end_r - 1).clamp(min=0)],
                   h1_init)
        better = act & (end_r == qlens) & (h_last >= gsc)
        mx_ie = W(better, torch.full_like(mx_ie, i), mx_ie)
        gsc = W(better, torch.maximum(h_last, gsc), gsc)
        Enew = torch.maximum(e_cur - e_del, (M - oe_del).clamp(min=0))
        Hsh = torch.cat([h1_init[:, None], Hrow[:, :-1]], dim=1)
        wr = inband & act[:, None]
        H2 = torch.cat([W(wr, Hsh, H[:, :Q]), H[:, Q:]], dim=1)
        E2 = torch.cat([W(wr, Enew, E[:, :Q]), E[:, Q:]], dim=1)
        cur_h = H2[lane, end_r]
        cur_e = E2[lane, end_r]
        H2[lane, end_r] = W(act, h_last, cur_h)
        E2[lane, end_r] = W(act, torch.zeros_like(cur_e), cur_e)

        brk0 = act & (mrow == 0)
        imp = act & ~brk0 & (mrow > mx)
        mx_i = W(imp, torch.full_like(mx_i, i), mx_i)
        mx_j = W(imp, mj, mx_j)
        mx_off = W(imp, torch.maximum(mx_off, (mj - i).abs()), mx_off)
        zd = act & ~brk0 & ~imp & (zdrop > 0)
        d_i = i - mx_i
        d_j = mj - mx_j
        zcond = W(d_i > d_j, mx - mrow - (d_i - d_j) * e_del > zdrop,
                  mx - mrow - (d_j - d_i) * e_ins > zdrop)
        brkz = zd & zcond
        mx = W(imp, mrow, mx)

        nz = ~((H2 == 0) & (E2 == 0))
        in_lo = (cols >= beg_r[:, None]) & (cols < end_r[:, None])
        first_nz = W(nz & in_lo, cols, torch.full_like(cols, Q + 1)
                     ).min(dim=1).values
        beg_n = torch.minimum(first_nz, end_r)
        in_hi = (cols >= beg_n[:, None]) & (cols <= end_r[:, None])
        last_nz = W(nz & in_hi, cols, (beg_n - 1)[:, None].expand(N, Q + 1)
                    ).max(dim=1).values
        end_n = torch.minimum(last_nz + 2, qlens)
        upd = act & ~brk0 & ~brkz
        beg = W(upd, beg_n, beg)
        end = W(upd, end_n, end)
        done = done | brk0 | brkz
        H, E = H2, E2
    return tuple(a.to(torch.int32).numpy() for a in
                 (mx, mx_j + 1, mx_i + 1, mx_ie + 1, gsc, mx_off))
