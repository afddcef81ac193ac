"""Native-core driver + hit resolution for BWA-SW.

bsw2_core (bwtsw2_core.c:449-619) runs in native/bsw2.cpp; this module
feeds it the genome FM-index arrays, converts raw hits back, and
implements bsw2_resolve_duphits (bwtsw2_core.c:273-347) and
bsw2_resolve_query_overlaps (349-398) with the reference's exact sort
permutations and float32 comparison semantics.
"""

from __future__ import annotations

import ctypes

import numpy as np

from bwa_tpu_torch.mem.ksort import ks_introsort
from bwa_tpu_torch.native.build import get_lib
from bwa_tpu_torch.sw2.types import Hit, HitSet, hitG_lt

MASK_LEVEL_F32 = np.float32(0.90)  # MASK_LEVEL (bwtsw2_core.c:27)

_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)

_sigs_done = False


def _lib():
    global _sigs_done
    lib = get_lib()
    if not _sigs_done:
        lib.bsw2_core_run.restype = ctypes.c_int64
        lib.bsw2_core_run.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, _i64p,
            _u8p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i64p, _i64p, ctypes.c_int64,
        ]
        lib.fm_sa_batch.restype = ctypes.c_int64  # the walk's steps
        lib.fm_sa_batch.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, _i64p,
            _i64p, ctypes.c_int32, _i64p, ctypes.c_int64, _i64p,
        ]
        lib.bsw2_resolve_duphits_rows.restype = ctypes.c_int64
        lib.bsw2_resolve_duphits_rows.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, _i64p,
            _i64p, ctypes.c_int32, _i64p, ctypes.c_int64, ctypes.c_int32,
            _i64p, ctypes.c_int64,
        ]
        _sigs_done = True
    return lib


class Sw2Index:
    """int64 views of an FMIndex for the native BWA-SW entry points."""

    def __init__(self, fm):
        self.fm = fm
        self.inter = fm.occ_inter  # 64B interleaved occ blocks
        self.L2 = np.ascontiguousarray(fm.L2, dtype=np.int64)
        self.ssa64 = np.ascontiguousarray(fm.ssa, dtype=np.int64)
        self._args = (self.inter.ctypes.data_as(_u8p),
                      ctypes.c_int64(fm.seq_len),
                      ctypes.c_int64(fm.primary),
                      self.L2.ctypes.data_as(_i64p))
        self._ssa_p = self.ssa64.ctypes.data_as(_i64p)
        self._sa_intv = np.int32(fm.sa_intv)

    def _fm_args(self):
        return self._args

    def core(self, read_codes: np.ndarray, opt) -> tuple[HitSet, HitSet]:
        """One DAG traversal; returns the raw (wide, narrow) hit sets
        exactly as bsw2_core leaves them before resolve_duphits."""
        lib = _lib()
        q = np.ascontiguousarray(read_codes, dtype=np.uint8)
        l = int(q.shape[0])
        out_b = np.zeros((2 * l, 10), dtype=np.int64)
        cap = max(4 * l, 256)
        while True:
            out_b1 = np.empty((cap, 10), dtype=np.int64)
            n1 = lib.bsw2_core_run(
                *self._fm_args(), q.ctypes.data_as(_u8p), l,
                opt.a, opt.b, opt.q, opt.r, opt.t, opt.z, opt.is_, opt.bw,
                out_b.ctypes.data_as(_i64p), out_b1.ctypes.data_as(_i64p),
                cap)
            if n1 == -1:
                out_b[:] = 0
                cap *= 4
                continue
            if n1 < 0:
                raise RuntimeError(f"bsw2_core_run failed rc={n1}")
            break
        # drop never-written slots vectorized: resolve_duphits skips
        # exactly the (G==0, k==0, l==0, len==0) rows (bwtsw2_core.c:289
        # continue + the G>0 branch guard) and every caller feeds b to
        # resolve_duphits first, so pre-filtering them is observationally
        # identical — and avoids ~2*l Hit objects per read
        live = ~((out_b[:, 5] == 0) & (out_b[:, 0] == 0)
                 & (out_b[:, 1] == 0) & (out_b[:, 4] == 0))
        b = HitSet([_hit_from_row(r) for r in out_b[live]])
        b1 = HitSet([_hit_from_row(out_b1[i]) for i in range(int(n1))])
        return b, b1

    def core_resolved(self, read_codes: np.ndarray, opt) -> tuple[HitSet,
                                                                  HitSet]:
        """core() + native bsw2_resolve_duphits on both hit sets (the
        SA expansion, exact introsort and float32/float64 overlap tests
        run in C++ — sw2/core.py resolve_duphits is the spec)."""
        lib = _lib()
        q = np.ascontiguousarray(read_codes, dtype=np.uint8)
        l = int(q.shape[0])
        out_b = np.zeros((2 * l, 10), dtype=np.int64)
        cap = max(4 * l, 256)
        while True:
            out_b1 = np.empty((cap, 10), dtype=np.int64)
            n1 = lib.bsw2_core_run(
                *self._fm_args(), q.ctypes.data_as(_u8p), l,
                opt.a, opt.b, opt.q, opt.r, opt.t, opt.z, opt.is_, opt.bw,
                out_b.ctypes.data_as(_i64p), out_b1.ctypes.data_as(_i64p),
                cap)
            if n1 == -1:
                out_b[:] = 0
                cap *= 4
                continue
            if n1 < 0:
                raise RuntimeError(f"bsw2_core_run failed rc={n1}")
            break
        return (self._resolve_rows(out_b, opt.is_),
                self._resolve_rows(out_b1[:int(n1)], opt.is_))

    def _resolve_rows(self, rows: np.ndarray, IS: int) -> HitSet:
        lib = _lib()
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        cap = 256  # resolved sets are tiny; the -1 retry covers the rest
        while True:
            out = np.empty((cap, 10), dtype=np.int64)
            n = lib.bsw2_resolve_duphits_rows(
                *self._fm_args(), self._ssa_p, self._sa_intv,
                rows.ctypes.data_as(_i64p), ctypes.c_int64(rows.shape[0]),
                ctypes.c_int32(IS), out.ctypes.data_as(_i64p),
                ctypes.c_int64(cap))
            if n == -1:
                cap *= 4
                continue
            return HitSet([_hit_from_row(out[i]) for i in range(int(n))])

    def sa_batch(self, ks) -> np.ndarray:
        ks = np.ascontiguousarray(ks, dtype=np.int64)
        out = np.empty(ks.shape[0], dtype=np.int64)
        if ks.shape[0]:
            _lib().fm_sa_batch(*self._args, self._ssa_p, self._sa_intv,
                               ks.ctypes.data_as(_i64p),
                               ctypes.c_int64(ks.shape[0]),
                               out.ctypes.data_as(_i64p))
        return out


def _hit_from_row(r) -> Hit:
    k, l, flag, n_seeds, ln, G, G2, beg, end, is_rev = r.tolist()
    return Hit(k=k, l=l, flag=flag, n_seeds=n_seeds, len=ln, G=G, G2=G2,
               beg=beg, end=end, is_rev=is_rev)


def resolve_duphits(bnt, idx: Sw2Index | None, b: HitSet, IS: int) -> int:
    """bsw2_resolve_duphits (bwtsw2_core.c:273-347).  With idx/bnt set,
    narrow SA intervals are expanded to chromosomal coordinates first."""
    if b.n == 0:
        return 0
    if idx is not None and bnt is not None:
        old = b.hits
        sa_ranks = []
        for p in old:
            if p.l - p.k + 1 <= IS:
                if p.G == 0 and p.k == 0 and p.l == 0 and p.len == 0:
                    continue
                sa_ranks.extend(range(p.k, p.l + 1))
            elif p.G > 0:
                sa_ranks.append(p.k)
        pos = idx.sa_batch(sa_ranks)
        l_pac = bnt.l_pac
        pi = 0
        new = []
        for p in old:
            if p.l - p.k + 1 <= IS:  # not so repetitive: expand
                if p.G == 0 and p.k == 0 and p.l == 0 and p.len == 0:
                    continue
                for _ in range(p.k, p.l + 1):
                    h = p.copy()
                    s = int(pos[pi])
                    pi += 1
                    is_rev = int(s >= l_pac)
                    if is_rev:
                        s = (l_pac << 1) - 1 - s
                    h.k = s - (p.len - 1 if is_rev else 0)
                    h.l = 0
                    h.is_rev = is_rev
                    new.append(h)
            elif p.G > 0:  # repetitive: keep one coordinate, flag it
                h = p.copy()
                s = int(pos[pi])
                pi += 1
                is_rev = int(s >= l_pac)
                if is_rev:
                    s = (l_pac << 1) - 1 - s
                h.k = s - (p.len - 1 if is_rev else 0)
                h.l = 0
                h.flag |= 1
                h.is_rev = is_rev
                new.append(h)
        b.hits = new
    b.hits = [h for h in b.hits if h.G]  # squeeze empties
    ks_introsort(b.hits, hitG_lt)
    hits = b.hits
    n = len(hits)
    for i in range(1, n):
        p = hits[i]
        for j in range(i):
            q = hits[j]
            compatible = True
            if p.is_rev != q.is_rev:
                continue  # opposite strands are never duplicates
            if p.l == 0 and q.l == 0:
                qol = min(p.end, q.end) - max(p.beg, q.beg)
                if qol < 0:
                    qol = 0
                # the qol ratios compare in float32 (bwtsw2_core.c:325)
                if (np.float32(qol) / np.float32(p.end - p.beg) > MASK_LEVEL_F32
                        or np.float32(qol) / np.float32(q.end - q.beg)
                        > MASK_LEVEL_F32):
                    tol = (min(p.k + p.len, q.k + q.len)
                           - max(p.k, q.k))
                    # ... but the tol ratios in float64 (line 328)
                    if (tol / p.len > float(MASK_LEVEL_F32)
                            or tol / q.len > float(MASK_LEVEL_F32)):
                        compatible = False
            if not compatible:
                p.G = 0
                if q.G2 < p.G2:
                    q.G2 = p.G2
                break
    b.hits = [h for h in hits if h.G]
    return len(b.hits)


def resolve_query_overlaps(b: HitSet, mask_level: float, rng) -> int:
    """bsw2_resolve_query_overlaps (bwtsw2_core.c:349-398); rng is the
    process-wide drand48 state."""
    if b.n == 0:
        return 0
    ks_introsort(b.hits, hitG_lt)
    hits = b.hits
    # randomly promote one of the tied-best hits (lines 354-363)
    G0 = hits[0].G
    i = 1
    while i < len(hits) and hits[i].G == G0:
        i += 1
    j = int(i * rng.drand48())
    if j:
        hits[0], hits[j] = hits[j], hits[0]
    mask_f = np.float32(mask_level)
    n = len(hits)
    stop = n
    for i in range(1, n):
        p = hits[i]
        if p.G == 0:
            # only reachable if an input hit had G==0 (callers squeeze
            # before calling, so in practice stop stays n)
            stop = i
            break
        all_compatible = True
        for j in range(i):
            q = hits[j]
            if q.G == 0:
                continue
            tol = 0
            qol = min(p.end, q.end) - max(p.beg, q.beg)
            if qol < 0:
                qol = 0
            if p.l == 0 and q.l == 0:
                tol = (min(p.k + p.len, q.k + q.len) - max(p.k, q.k))
                if tol < 0:
                    tol = 0
            fol = np.float32(qol) / np.float32(
                min(p.end - p.beg, q.end - q.beg))
            compatible = (fol < mask_f
                          or (tol > 0 and qol < p.end - p.beg
                              and qol < q.end - q.beg))
            if not compatible:
                if q.G2 < p.G:
                    q.G2 = p.G
                all_compatible = False
        if not all_compatible:
            p.G = 0
    b.hits = [h for h in hits[:stop] if h.G]
    return len(b.hits)
