"""Batched seed extension over device-resident reference and read arrays.

The 2-bit packed forward reference (.pac bytes) and the batch's flat read
codes live on the device; each extension problem is described only by
coordinates (query base/direction/length, target base/direction/length,
band, h0), and the band kernel (ops/ksw_band.py, K2) gathers its query
windows and target rows itself.  Coordinates follow bns_get_seq
(bntseq.c:403-424): position x in [0, 2*l_pac) reads pac[x] on the forward
half and 3 - pac[2*l_pac-1-x] on the reverse half; left extensions walk
query and target backwards (dir = -1), like the reversed copies
mem_chain2aln builds (bwamem.c:691-701).
"""

from __future__ import annotations

import numpy as np
import torch

from bwa_tpu_torch.index.fmindex import writable
from bwa_tpu_torch.ops.ksw_band import _band_for, ksw_band_side


def band_clamp(qlens, ws, mat_max, o_del, e_del, o_ins, e_ins, end_bonus):
    """The per-problem band clamp of ksw.c:435-443 (host numpy)."""
    qlens = np.asarray(qlens, np.int64)
    num_ins = qlens * mat_max + end_bonus - o_ins
    max_ins = np.where(num_ins >= 0, num_ins // e_ins + 1,
                       -((-num_ins) // e_ins) + 1)
    w = np.minimum(np.asarray(ws, np.int64), np.maximum(max_ins, 1))
    num_del = qlens * mat_max + end_bonus - o_del
    max_del = np.where(num_del >= 0, num_del // e_del + 1,
                       -((-num_del) // e_del) + 1)
    return np.minimum(w, np.maximum(max_del, 1)).astype(np.int64)


def _band_clamp_t(qlens, w: int, mat_max, o_del, e_del, o_ins, e_ins,
                  end_bonus):
    """band_clamp on a device tensor of query lengths, scalar band w."""
    qlens = qlens.to(torch.int64)

    def cap(num, e):
        m = torch.where(num >= 0, num // e + 1, -((-num) // e) + 1)
        return m.clamp(min=1)

    out = torch.minimum(torch.full_like(qlens, w),
                        cap(qlens * mat_max + end_bonus - o_ins, e_ins))
    return torch.minimum(out, cap(qlens * mat_max + end_bonus - o_del, e_del))


class ExtGatherEngine:
    """Resident-array extension runner on one device.

    Holds the device copies of the packed reference and the current read
    batch; run() executes one batch of extension problems of one pass,
    run_fused() a whole mem_chain2aln extension batch."""

    def __init__(self, pac: np.ndarray, l_pac: int, coord_dtype,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.pac = torch.from_numpy(writable(pac, np.uint8)).to(self.device)
        self.l_pac = int(l_pac)
        self.cdt = coord_dtype
        self._qflat = None

    def set_reads(self, qflat: np.ndarray) -> None:
        q = np.ascontiguousarray(qflat, np.uint8)
        if q.shape[0] == 0:
            q = np.full(1, 4, np.uint8)
        self._qflat = torch.from_numpy(q).to(self.device)

    def _side(self, P, qbase, qdir, qlen, tbase, tdir, tlen, ws, h0s, opt):
        return ksw_band_side(
            self.pac, self.l_pac, self._qflat, qbase, qdir, qlen, tbase,
            tdir, tlen, ws, h0s, opt["mat"], opt["o_del"], opt["e_del"],
            opt["o_ins"], opt["e_ins"], opt["zdrop"], P)[:, :6]

    def run_fused(self, meta: np.ndarray, opt) -> np.ndarray:
        """A whole mem_chain2aln extension batch (meta rows: q_base,
        l_query, qbeg, slen, rbeg, rmax0, rmax1, h0 -- the job table of
        memfin.cpp's callback): left pass at band w, left band-doubling
        retry (bwamem.c:706-712), right pass seeded from the left's final
        score (bwamem.c:719), right retry -- four K2 launches chained by
        tensor glue on the device.  Returns [n, 12] = (left 6 | right 6)
        with the applied band in column 5 of each half."""
        n = meta.shape[0]
        assert n > 0
        dev = self.device
        mat_max = int(np.asarray(opt.mat).max())
        w_raw = int(opt.w)
        P1 = _band_for(w_raw)
        P2 = _band_for(w_raw << 1)
        thr = (w_raw >> 1) + (w_raw >> 2)
        o = dict(mat=np.asarray(opt.mat), o_del=int(opt.o_del),
                 e_del=int(opt.e_del), o_ins=int(opt.o_ins),
                 e_ins=int(opt.e_ins), zdrop=int(opt.zdrop))
        clamp = lambda ql, w, bonus: _band_clamp_t(  # noqa: E731
            ql, w, mat_max, o["o_del"], o["e_del"], o["o_ins"], o["e_ins"],
            bonus)
        # longest problems first: K2 runs a warp per problem (four a
        # block), and a launch lasts as long as its longest problem
        tl = np.maximum(meta[:, 4] - meta[:, 5], meta[:, 6]
                        - (meta[:, 4] + meta[:, 3]))
        order = np.argsort(-tl, kind="stable")
        m = torch.from_numpy(np.ascontiguousarray(meta[order], np.int64)).to(
            dev)
        q_base, l_query, qbeg, slen, rbeg, rmax0, rmax1, h0 = m.unbind(1)
        zero = torch.zeros_like(q_base)
        minus = torch.full_like(q_base, -1)
        one = torch.ones_like(q_base)

        def run_compact(P, live, *args):
            """Retry pass: live rows permuted to the front by a stable
            argsort (the dead tail has tlen 0 and returns at once),
            results scattered back to job order."""
            perm = torch.sort((~live).to(torch.int8), stable=True).indices
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.shape[0], device=dev)
            a = [x[perm] for x in args]
            a[5] = torch.where(live[perm], a[5], torch.zeros_like(a[5]))
            return self._side(P, *a, o)[inv]

        # ---- left (dir -1), h0 from the seed ----
        lm = qbeg > 0
        qlen_l = torch.where(lm, qbeg, zero)
        qbase_l = q_base + qbeg - 1
        tlen_l = torch.where(lm, rbeg - rmax0, zero)
        args_l = (qbase_l, minus, qlen_l, rbeg - 1, minus, tlen_l)
        r1 = self._side(P1, *args_l, clamp(qlen_l, w_raw, opt.pen_clip5),
                        h0, o)
        retry_l = lm & (r1[:, 5] >= thr)
        r2 = run_compact(P2, retry_l, *args_l,
                         clamp(qlen_l, w_raw << 1, opt.pen_clip5), h0)
        lres = torch.where(retry_l[:, None], r2, r1)
        lres = torch.where(lm[:, None], lres, torch.zeros_like(lres))
        aw_l = torch.where(retry_l, w_raw << 1, w_raw).to(torch.int32)
        lres[:, 5] = torch.where(lm, aw_l, torch.zeros_like(aw_l))

        # ---- right (dir +1), h0 chains from the left's FINAL score ----
        sc0 = torch.where(lm, lres[:, 0].to(torch.int64), h0)
        qe = qbeg + slen
        rm = qe < l_query
        qlen_r = torch.where(rm, l_query - qe, zero)
        tbase_r = rbeg + slen
        tlen_r = torch.where(rm, rmax1 - tbase_r, zero)
        args_r = (q_base + qe, one, qlen_r, tbase_r, one, tlen_r)
        s1 = self._side(P1, *args_r, clamp(qlen_r, w_raw, opt.pen_clip3),
                        sc0, o)
        retry_r = rm & (s1[:, 5] >= thr) & (s1[:, 0].to(torch.int64) != sc0)
        s2 = run_compact(P2, retry_r, *args_r,
                         clamp(qlen_r, w_raw << 1, opt.pen_clip3), sc0)
        rres = torch.where(retry_r[:, None], s2, s1)
        rres = torch.where(rm[:, None], rres, torch.zeros_like(rres))
        aw_r = torch.where(retry_r, w_raw << 1, w_raw).to(torch.int32)
        rres[:, 5] = torch.where(rm, aw_r, torch.zeros_like(aw_r))
        out = torch.cat([lres, rres], dim=1).cpu().numpy()
        res = np.zeros((n, 12), np.int32)
        res[order] = out
        return res

    def run(self, qbase, qdir, qlen, tbase, tdir, tlen, ws, h0s, mat,
            o_del, e_del, o_ins, e_ins, zdrop):
        """One pass over n problems (ws already band-clamped); returns
        [n, 6] int32 (score, qle, tle, gtle, gscore, max_off)."""
        n = len(qbase)
        assert n > 0
        P = _band_for(int(np.max(ws, initial=1)))
        t = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.int64), device=self.device)
        o = dict(mat=np.asarray(mat), o_del=int(o_del), e_del=int(e_del),
                 o_ins=int(o_ins), e_ins=int(e_ins), zdrop=int(zdrop))
        out = self._side(P, t(qbase), t(qdir), t(qlen), t(tbase), t(tdir),
                         t(tlen), t(ws), t(h0s), o)
        return out.cpu().numpy()
