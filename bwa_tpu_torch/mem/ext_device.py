"""Batched seed extension on the device (the mem_chain2aln DP).

The native finalize (memfin.cpp) enumerates one extension job per
(chain, seed) before its serial per-read loop -- the left/right extends of
a seed are pure functions of seed/chain geometry (bwamem.c:691-742) -- and
hands the job table to a callback.  This module is that callback: it runs
the jobs through the band kernel over resident device arrays
(ops/ext_gather.py) and fills the per-job results, with the MAX_BAND_TRY
band-doubling retry of bwamem.c:706-712 (retry when max_off >= w/2 + w/4
and the score moved).  Every decision made on the results happens in the
same serial C++ code as the host path, so SAM output is unchanged.

Switches (environment): BWA_TPU_EXT_STAGE=first (default) extends only
the first-in-chain jobs on the device, the rare consumed miss falls back
to the inline scalar DP in memfin.cpp; =all extends every job.
BWA_TPU_EXT_FUSED=1 (default) runs one fused batch (ExtGatherEngine.
run_fused); =0 runs one pass per call (run), four calls per batch.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from bwa_tpu_torch.native.build import get_lib
from bwa_tpu_torch.ops.ext_gather import ExtGatherEngine, band_clamp

_CB_T = ctypes.CFUNCTYPE(None, ctypes.c_int64,
                         ctypes.POINTER(ctypes.c_int64),
                         ctypes.POINTER(ctypes.c_uint8),
                         ctypes.POINTER(ctypes.c_int32),
                         ctypes.POINTER(ctypes.c_int32))

def _engine_for(fm, device) -> ExtGatherEngine:
    """The index's extension engine on this device, kept on the index so
    its .pac upload serves every batch."""
    engines = fm.__dict__.setdefault("_ext_engines", {})
    key = str(torch.device(device))
    if key not in engines:
        engines[key] = ExtGatherEngine(fm.pac, fm.l_pac, fm.coord_dtype,
                                       device=device)
    return engines[key]


class DeviceExtContext:
    """Installs the batch-extension callback around a native finalize
    call.  Usage:

        with DeviceExtContext(opt, fm, codes_flat, "cuda"):
            lib.mem_finalize_se_batch(...)
    """

    def __init__(self, opt, fm, codes_flat: np.ndarray, device="cuda"):
        self.opt = opt
        self.eng = _engine_for(fm, device)
        self.eng.set_reads(codes_flat)
        self.err: BaseException | None = None
        self._cb = _CB_T(self._run)

    def __enter__(self):
        get_lib().mem_set_ext_cb(ctypes.cast(self._cb, ctypes.c_void_p))
        return self

    def __exit__(self, *exc):
        get_lib().mem_set_ext_cb(None)
        if exc[0] is None and self.err is not None:
            raise self.err
        return False

    # ---- the callback ----

    def _run(self, njobs, meta_p, first_p, lres_p, rres_p):
        try:
            meta = np.ctypeslib.as_array(meta_p, shape=(njobs, 8))
            first = np.ctypeslib.as_array(first_p, shape=(njobs,))
            lres = np.ctypeslib.as_array(lres_p, shape=(njobs, 6))
            rres = np.ctypeslib.as_array(rres_p, shape=(njobs, 6))
            self._extend_all(meta, first, lres, rres)
        except BaseException as e:  # ctypes swallows exceptions: stash
            self.err = e

    def _side(self, qbase, qdir, qlen, tbase, tdir, tlen, h0,
              end_bonus, prev_score):
        """One extension side with the band-doubling retry; returns the
        final [n,6] results (score,qle,tle,gtle,gscore,aw)."""
        o = self.opt
        mat_max = int(np.asarray(o.mat).max())
        n = len(qbase)
        out = np.zeros((n, 6), np.int32)
        if n == 0:
            return out
        w0 = band_clamp(qlen, np.full(n, o.w, np.int64), mat_max,
                        o.o_del, o.e_del, o.o_ins, o.e_ins, end_bonus)
        r1 = self.eng.run(qbase, qdir, qlen, tbase, tdir, tlen, w0, h0,
                          o.mat, o.o_del, o.e_del, o.o_ins, o.e_ins, o.zdrop)
        out[:, :5] = r1[:, :5]
        out[:, 5] = o.w
        # bwamem.c:711: break when score==prev or max_off small; the
        # threshold uses the UNCLAMPED band o.w << t
        thr = (o.w >> 1) + (o.w >> 2)
        retry = r1[:, 5] >= thr
        if prev_score is not None:
            retry &= r1[:, 0] != prev_score
        idx = np.nonzero(retry)[0]
        if len(idx):
            w1 = band_clamp(qlen[idx], np.full(len(idx), o.w << 1, np.int64),
                            mat_max, o.o_del, o.e_del, o.o_ins, o.e_ins,
                            end_bonus)
            r2 = self.eng.run(qbase[idx], qdir[idx], qlen[idx], tbase[idx],
                              tdir[idx], tlen[idx], w1, h0[idx], o.mat,
                              o.o_del, o.e_del, o.o_ins, o.e_ins, o.zdrop)
            out[idx, :5] = r2[:, :5]
            out[idx, 5] = o.w << 1
        return out

    def _extend_all(self, meta, first, lres, rres):
        stage = os.environ.get("BWA_TPU_EXT_STAGE", "first")
        sel = None
        if stage == "first" and first is not None:
            sel = np.nonzero(first)[0]
            if len(sel) == len(first):
                sel = None
        fused = os.environ.get("BWA_TPU_EXT_FUSED", "1") != "0"
        if sel is not None:
            if len(sel) == 0:
                return
            sub = np.ascontiguousarray(meta[sel])
            if fused:
                out = self.eng.run_fused(sub, self.opt)
                lres[sel] = out[:, :6]
                rres[sel] = out[:, 6:]
            else:
                sub_l = np.empty((len(sel), 6), np.int32)
                sub_r = np.empty((len(sel), 6), np.int32)
                self._extend_4call(sub, sub_l, sub_r)
                lres[sel] = sub_l
                rres[sel] = sub_r
            return
        if fused:
            out = self.eng.run_fused(meta, self.opt)
            lres[:] = out[:, :6]
            rres[:] = out[:, 6:]
        else:
            self._extend_4call(meta, lres, rres)

    def _extend_4call(self, meta, lres, rres):
        q_base = meta[:, 0]
        l_query = meta[:, 1]
        qbeg = meta[:, 2]
        slen = meta[:, 3]
        rbeg = meta[:, 4]
        rmax0 = meta[:, 5]
        rmax1 = meta[:, 6]
        h0 = meta[:, 7]

        lm = np.nonzero(qbeg > 0)[0]
        if len(lm):
            res = self._side(
                q_base[lm] + qbeg[lm] - 1, np.full(len(lm), -1, np.int32),
                qbeg[lm], rbeg[lm] - 1, np.full(len(lm), -1, np.int32),
                rbeg[lm] - rmax0[lm], h0[lm], self.opt.pen_clip5, None)
            lres[lm] = res
        # right extension h0 chains from the left's FINAL score
        # (bwamem.c:719: sc0 = a->score)
        sc0 = np.where(qbeg > 0, lres[:, 0], h0).astype(np.int64)
        qe = qbeg + slen
        rm = np.nonzero(qe < l_query)[0]
        if len(rm):
            res = self._side(
                q_base[rm] + qe[rm], np.full(len(rm), 1, np.int32),
                l_query[rm] - qe[rm], rbeg[rm] + slen[rm],
                np.full(len(rm), 1, np.int32),
                rmax1[rm] - (rbeg[rm] + slen[rm]), sc0[rm],
                self.opt.pen_clip3, sc0[rm])
            rres[rm] = res
