"""BWA-SW alignment pipeline: chaining, extension, CIGAR, SAM.

Port of the observable behaviour of bwtsw2_aux.c and bwtsw2_chain.c on
top of the native DAG core (sw2/core.py).  Single host thread: the
reference's -t static partitioning shares one drand48 stream between
threads and is therefore nondeterministic; single-threaded output is the
deterministic (and tested) reference behaviour.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from bwa_tpu_torch.index.pack import NT4_TABLE
from bwa_tpu_torch.mem.cigar import gen_cigar2_full
from bwa_tpu_torch.mem.ksort import ks_introsort
from bwa_tpu_torch.ops.ksw_host import ksw_extend2
from bwa_tpu_torch.sw2.core import (_hit_from_row, _i64p, _u8p,
                              Sw2Index, resolve_duphits,
                              resolve_query_overlaps)
from bwa_tpu_torch.sw2.types import (Aux, Bsw2Opt, BSW2_FLAG_MATESW,
                               BSW2_FLAG_TANDEM, Hit, HitSet, NT_COMP_TABLE,
                               fill_scmat)


def idiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def update_opt(src: Bsw2Opt, qlen: int) -> Bsw2Opt:
    """Per-read threshold/band adaptation (bwtsw2_aux.c:545-557)."""
    dst = src.copy()
    ll = math.log(qlen)
    if dst.t < ll * dst.coef:
        dst.t = int(ll * dst.coef + 0.499)
    k = idiv(qlen * dst.a - 2 * dst.q, 2 * dst.r + dst.a)
    i = idiv(qlen * dst.a - dst.a - dst.t, dst.r)
    if k > i:
        k = i
    if k < 1:
        k = 1
    dst.bw = min(src.bw, k)
    return dst


# ---------------------------------------------------------------------
# Seed chaining filter (bwtsw2_chain.c)
# ---------------------------------------------------------------------

class _ChainEnt:
    __slots__ = ("tbeg", "tend", "qbeg", "qend", "flag", "idx", "chain")

    def __init__(self):
        self.tbeg = self.tend = self.qbeg = self.qend = 0
        self.flag = self.idx = 0
        self.chain = -1

    def copy(self):
        c = _ChainEnt()
        c.tbeg, c.tend, c.qbeg, c.qend = self.tbeg, self.tend, self.qbeg, self.qend
        c.flag, c.idx, c.chain = self.flag, self.idx, self.chain
        return c


def _chaining(opt: Bsw2Opt, shift: int, z: list) -> list:
    """bwtsw2_chain.c:20-46; z is sorted in place by qbeg."""
    ks_introsort(z, lambda a, b: a.qbeg < b.qbeg)
    chain: list[_ChainEnt] = []
    for p in z:
        k = len(chain) - 1
        while k >= 0:
            q = chain[k]
            x = p.qbeg - q.qbeg  # always >= 0 after the sort
            y = p.tbeg - q.tbeg
            if (y > 0 and x < opt.max_chain_gap and y < opt.max_chain_gap
                    and x - y <= opt.bw and y - x <= opt.bw):
                if p.qend > q.qend:
                    q.qend = p.qend
                if p.tend > q.tend:
                    q.tend = p.tend
                q.chain += 1
                p.chain = shift + k
                break
            elif q.chain > opt.t_seeds * 2:
                k = 0  # strong chain: stop scanning earlier chains
            k -= 1
        if k < 0:
            c = p.copy()
            c.chain = 1
            c.idx = p.chain = shift + len(chain)
            chain.append(c)
    return chain


def chain_filter(opt: Bsw2Opt, length: int, b: list[HitSet]) -> None:
    """bsw2_chain_filter (bwtsw2_chain.c:48-112): drop seeds in weak
    chains dominated by a strong chain covering the same query span."""
    thres = opt.t_seeds * 2
    z = [[], []]
    for k in range(2):
        for i, p in enumerate(b[k].hits):
            q = _ChainEnt()
            q.flag = k
            q.idx = i
            q.tbeg = p.k
            q.tend = p.k + p.len
            q.chain = -1
            q.qbeg = p.beg
            q.qend = p.end
            z[k].append(q)
    chain0 = _chaining(opt, 0, z[0])
    chain1 = _chaining(opt, len(chain0), z[1])
    for p in chain1:  # reverse strand: flip to the other read orientation
        tmp = p.qbeg
        p.qbeg = length - p.qend
        p.qend = length - tmp
    chains = chain0 + chain1
    flag = [0] * len(chains)
    ks_introsort(chains, lambda a, b: a.qbeg < b.qbeg)
    for k in range(1, len(chains)):
        p = chains[k]
        for j in range(k):
            q = chains[j]
            if flag[q.idx]:
                continue
            if (q.qend >= p.qend and q.chain > p.chain * thres
                    and p.chain < thres):
                flag[p.idx] = 1
                break
    for zz in z[0] + z[1]:
        if flag[zz.chain]:
            b[zz.flag].hits[zz.idx].G = 0
    for k in range(2):
        b[k].hits = [h for h in b[k].hits if h.G]


# ---------------------------------------------------------------------
# Seed extension (bwtsw2_aux.c:100-170)
# ---------------------------------------------------------------------

def extend_left(opt: Bsw2Opt, b: HitSet, query: np.ndarray, lq: int,
                fm) -> None:
    mat = fill_scmat(opt.a, opt.b)
    pac = fm.pac_codes
    rq = query[::-1]
    ks_introsort(b.hits, lambda a, c: a.end > c.end)  # descending query end
    for i, p in enumerate(b.hits):
        lt = idiv(idiv(p.beg + 1, 2) * opt.a + opt.r, opt.r) + lq
        p.n_seeds = 1
        if p.l or p.k == 0:
            continue
        score = 0
        for j in range(i):  # seeds containing p extend it implicitly
            q = b.hits[j]
            if (q.beg <= p.beg and q.k <= p.k
                    and q.k + q.len >= p.k + p.len):
                if q.n_seeds < (1 << 13) - 2:
                    q.n_seeds += 1
                score += 1
        if score:
            continue
        if lt > p.k:
            lt = p.k
        lo = max(p.k - lt, 1)  # reference never reaches pac position 0 here
        target = pac[lo:p.k][::-1]
        sc, qle, tle, _, _, _ = ksw_extend2(
            rq[lq - p.beg:], target, mat, opt.q, opt.r, opt.q, opt.r,
            opt.bw, 0, -1, p.G)
        if sc > p.G:  # extensible
            p.G = sc
            p.k -= tle
            p.len += tle
            p.beg -= qle


def extend_rght(opt: Bsw2Opt, b: HitSet, query: np.ndarray, lq: int,
                fm) -> None:
    mat = fill_scmat(opt.a, opt.b)
    pac = fm.pac_codes
    l_pac = fm.l_pac
    for p in b.hits:
        lt = idiv(idiv(lq - p.beg + 1, 2) * opt.a + opt.r, opt.r) + lq
        if p.l:
            continue
        target = pac[p.k:min(p.k + lt, l_pac)]
        sc, qle, tle, _, _, _ = ksw_extend2(
            query[p.beg:], target, mat, opt.q, opt.r, opt.q, opt.r,
            opt.bw, 0, -1, 1)
        sc -= 1
        if sc >= p.G:
            p.G = sc
            p.len = tle
            p.end = p.beg + qle


# ---------------------------------------------------------------------
# Per-read alignment (bwtsw2_aux.c:226-319)
# ---------------------------------------------------------------------

def merge_hits(dst: HitSet, src: HitSet, length: int, is_reverse: int) -> None:
    for h in src.hits:
        if is_reverse:
            x = h.beg
            h.beg = length - h.end
            h.end = length - x
            h.flag |= 0x10
        dst.hits.append(h)
    src.hits = []


def flag_fr(b0: HitSet, b1: HitSet) -> None:
    """Mark which BWT orientation produced each hit (bwtsw2_aux.c:298-319)."""
    for p in b0.hits:
        p.flag |= 0x10000
    for q in b1.hits:
        q.flag |= 0x20000
    for p in b0.hits:
        for q in b1.hits:
            if (q.beg == p.beg and q.end == p.end and q.k == p.k
                    and q.len == p.len and q.G == p.G):
                q.flag |= 0x30000
                p.flag |= 0x30000
                break


def aln1_native(opt: Bsw2Opt, fm, idx: Sw2Index, length: int, seq2,
                rng) -> HitSet:
    """Whole-per-read aln1 in C++ (native/bsw2.cpp bsw2_aln1_run): DAG
    core, SA expansion, strand split, chain filter, left/right extension,
    dedup rounds and query-overlap resolution (incl. the drand48 tie
    promotion).  The Python aln1_core below is the executable spec."""
    import ctypes

    from bwa_tpu_torch.native.build import get_lib

    lib = get_lib()
    if not getattr(lib, "_aln1_sig", False):
        c32 = ctypes.c_int32
        lib.bsw2_aln1_run.restype = ctypes.c_int64
        lib.bsw2_aln1_run.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, c32,
            _u8p, _u8p, _u8p, c32,
            c32, c32, c32, c32, c32, c32, c32, c32, c32, c32,
            ctypes.c_double, ctypes.POINTER(ctypes.c_uint64),
            _i64p, ctypes.c_int64]
        lib._aln1_sig = True
    pac = np.ascontiguousarray(fm.pac, np.uint8)
    q0 = np.ascontiguousarray(seq2[0], np.uint8)
    q1 = np.ascontiguousarray(seq2[1], np.uint8)
    rng_state = np.array([rng.x], np.uint64)
    cap = max(4 * length, 256)
    while True:
        # write-only output: the native side fills rows [0, r) completely
        rows = np.empty((cap, 10), np.int64)
        rng_state[0] = rng.x  # restore on capacity retry
        r = lib.bsw2_aln1_run(
            idx.inter.ctypes.data_as(_u8p), ctypes.c_int64(fm.seq_len),
            ctypes.c_int64(fm.primary), idx.L2.ctypes.data_as(_i64p),
            idx.ssa64.ctypes.data_as(_i64p), np.int32(fm.sa_intv),
            pac.ctypes.data_as(_u8p), q0.ctypes.data_as(_u8p),
            q1.ctypes.data_as(_u8p), np.int32(length),
            np.int32(opt.a), np.int32(opt.b), np.int32(opt.q),
            np.int32(opt.r), np.int32(opt.t), np.int32(opt.z),
            np.int32(opt.is_), np.int32(opt.bw), np.int32(opt.t_seeds),
            np.int32(opt.max_chain_gap), ctypes.c_double(opt.mask_level),
            rng_state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            rows.ctypes.data_as(_i64p), ctypes.c_int64(cap))
        if r >= 0:
            break
        if r == -2:
            raise RuntimeError("bsw2_aln1_run failed")
        cap = int(-r - 10) + 16
    rng.x = int(rng_state[0])
    out = HitSet([_hit_from_row(rows[i]) for i in range(int(r))])
    return out


def aln1_core(opt: Bsw2Opt, fm, idx: Sw2Index, length: int, seq2, rng) -> HitSet:
    """bsw2_aln1_core (bwtsw2_aux.c:248-295); seq2 = (codes, revcomp codes)."""
    if os.environ.get("BWA_TPU_SW2_ALN1", "native") == "native":
        return aln1_native(opt, fm, idx, length, seq2, rng)
    bnt = fm.bnt
    if os.environ.get("BWA_TPU_SW2_RESOLVE") == "python":
        braw, b1raw = idx.core(seq2[0], opt)
        resolve_duphits(bnt, idx, braw, opt.is_)
        resolve_duphits(bnt, idx, b1raw, opt.is_)
    else:  # native SA expansion + dedup (sw2/core.py resolve is the spec)
        braw, b1raw = idx.core_resolved(seq2[0], opt)
    # separate by strand; reverse-strand hits get read-space coordinates
    bb = [[HitSet(), HitSet()], [HitSet(), HitSet()]]
    for kk, src in enumerate((braw, b1raw)):
        for h in src.hits:
            dst = bb[h.is_rev][kk]
            if h.is_rev:
                x = h.beg
                h.beg = length - h.end
                h.end = length - x
            dst.hits.append(h)
    b = [bb[0][1], bb[1][1]]  # the narrow (seedable) hits
    chain_filter(opt, length, b)
    out = [None, None]
    for kk in range(2):
        extend_left(opt, bb[kk][1], seq2[kk], length, fm)
        merge_hits(bb[kk][0], bb[kk][1], length, 0)
        resolve_duphits(None, None, bb[kk][0], 0)
        extend_rght(opt, bb[kk][0], seq2[kk], length, fm)
        resolve_duphits(None, None, bb[kk][0], 0)
        out[kk] = bb[kk][0]
    merge_hits(out[0], out[1], length, 1)
    resolve_query_overlaps(out[0], opt.mask_level, rng)
    return out[0]


# ---------------------------------------------------------------------
# CIGAR + SAM (bwtsw2_aux.c:172-543)
# ---------------------------------------------------------------------

class _CigarOpt:
    """Adapter for mem.cigar's bwa_gen_cigar2 implementation."""

    def __init__(self, opt: Bsw2Opt):
        self.mat = fill_scmat(opt.a, opt.b)
        self.o_del = self.o_ins = opt.q
        self.e_del = self.e_ins = opt.r
        self.w = opt.bw


def gen_cigar(opt: Bsw2Opt, lq: int, seq2, fm, b: HitSet) -> None:
    """bwtsw2_aux.c:173-212: banded global alignment per hit + soft clips.
    Runs the whole per-hit pac-extract + banded-global + NM in one native
    call (memfin.cpp bt_gen_cigar2 == bwa_gen_cigar2, bwa.c:160-230); the
    Python gen_cigar2_full in mem/cigar.py is the executable spec."""
    import ctypes

    from bwa_tpu_torch.native.build import get_lib

    lib = get_lib()
    if not getattr(lib, "_gencig_sig", False):
        c32 = ctypes.c_int32
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bt_gen_cigar2.restype = ctypes.c_int
        lib.bt_gen_cigar2.argtypes = [
            _u8p, ctypes.c_int64, c32, c32, c32, c32, c32, c32, _u8p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), c32, i32p, i32p,
            ctypes.c_char_p, c32, i32p]
        lib._gencig_sig = True
    pac = np.ascontiguousarray(fm.pac, np.uint8)
    pac_p = pac.ctypes.data_as(_u8p)
    i32 = np.zeros(3, np.int32)  # n_cigar, nm, score
    i32p_t = ctypes.POINTER(ctypes.c_int32)
    n_cig_p = i32[0:].ctypes.data_as(i32p_t)
    nm_p = i32[1:].ctypes.data_as(i32p_t)
    sc_p = i32[2:].ctypes.data_as(i32p_t)
    # hoist per-hit-invariant ctypes marshaling (measurable at 512-read
    # batch scale: these wrappers were rebuilt per hit)
    l_pac_c = ctypes.c_int64(fm.l_pac)
    a_c, b_c = np.int32(opt.a), np.int32(opt.b)
    q_c, r_c, bw_c = np.int32(opt.q), np.int32(opt.r), np.int32(opt.bw)
    cap = 3 * lq + 16  # >= (end-beg) + p.len + 8 for every hit
    cig = np.empty(cap, np.uint32)
    cig_p = cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    cap_c = np.int32(cap)
    md = ctypes.create_string_buffer(6 * cap + 16)
    mdlen_c = np.int32(len(md))
    for p, q in zip(b.hits, b.aux):
        if p.l:
            continue
        beg = lq - p.end if (p.flag & 0x10) else p.beg
        end = lq - p.beg if (p.flag & 0x10) else p.end
        query = np.ascontiguousarray(seq2[1 if (p.flag & 0x10) else 0]
                                     [beg:end], np.uint8)
        rc = lib.bt_gen_cigar2(
            pac_p, l_pac_c, a_c, b_c, q_c, r_c, bw_c, np.int32(end - beg),
            query.ctypes.data_as(_u8p), ctypes.c_int64(p.k),
            ctypes.c_int64(p.k + p.len),
            cig_p, cap_c, n_cig_p, nm_p, md, mdlen_c, sc_p)
        cig_use = cig
        if rc < 0:  # shared buffer too small (odd -a/-r): retry exact
            cap2 = (end - beg) + p.len + 8
            cig_use = np.empty(cap2, np.uint32)
            md2 = ctypes.create_string_buffer(6 * cap2 + 16)
            rc = lib.bt_gen_cigar2(
                pac_p, l_pac_c, a_c, b_c, q_c, r_c, bw_c,
                np.int32(end - beg), query.ctypes.data_as(_u8p),
                ctypes.c_int64(p.k), ctypes.c_int64(p.k + p.len),
                cig_use.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                np.int32(cap2), n_cig_p, nm_p, md2, np.int32(len(md2)),
                sc_p)
            if rc < 0:
                raise RuntimeError("bt_gen_cigar2 buffer overflow")
        if rc == 0:
            q.cigar, q.n_cigar, q.nm = None, 0, -1
            continue
        nc = int(i32[0])
        q.cigar = [(int(v) & 0xF, int(v) >> 4) for v in cig_use[:nc]]
        q.nm = int(i32[1])
        if q.cigar and (beg != 0 or end < lq):  # write soft clipping
            if beg != 0:
                q.cigar.insert(0, (4, beg))
            if end < lq:
                q.cigar.append((4, lq - end))
        q.n_cigar = len(q.cigar) if q.cigar else 0


def fix_cigar(bnt, p: Hit, cigar):
    """Split an alignment crossing a contig boundary (bwtsw2_aux.c:326-397).
    Returns the (possibly truncated) cigar; may update p.k/p.len."""
    seqid = bnt.pos2rid(p.k)
    n_cigar = len(cigar) if cigar else 0
    coor = p.k - bnt.contigs[seqid].offset
    refl = bnt.contigs[seqid].length
    x, y = coor, 0
    for op, ln in (cigar or []):
        if op in (1, 4, 5):
            y += ln
        elif op == 2:
            x += ln
        else:
            x += ln
            y += ln
    lq = y
    if x <= refl:
        return cigar
    # the alignment runs off the end of the contig: split it
    nc = 0
    mq = [0, 0]
    nlen = [0, 0]
    kk = 0
    cn = []
    x, y = coor, 0
    for op, ln in cigar:
        if op in (4, 5, 1):  # ins or clipping
            y += ln
            cn.append((op, ln))
        elif op == 2:  # del
            if x + ln >= refl and nc == 0:
                cn.append((4, lq - y))
                nc = len(cn)
                cn.append((4, y))
                kk = p.k + (x + ln - refl)
                nlen[0] = x - coor
                nlen[1] = p.len - nlen[0] - ln
            else:
                cn.append((2, ln))
            x += ln
        elif op == 0:  # match
            if x + ln >= refl and nc == 0:
                cn.append((0, refl - x))
                cn.append((4, lq - y - (refl - x)))
                nc = len(cn)
                mq[0] += refl - x
                cn.append((4, y + (refl - x)))
                if x + ln - refl:
                    cn.append((0, x + ln - refl))
                mq[1] += x + ln - refl
                kk = bnt.contigs[seqid].offset + refl
                nlen[0] = refl - coor
                nlen[1] = p.len - nlen[0]
            else:
                cn.append((0, ln))
                mq[1 if nc else 0] += ln
            x += ln
            y += ln
    if mq[0] > mq[1]:  # take the first part
        p.len = nlen[0]
        return cn[:nc]
    p.k = kk
    p.len = nlen[1]
    return cn[nc:]


def write_aux(opt: Bsw2Opt, fm, qlen: int, seq2, b: HitSet) -> None:
    """bwtsw2_aux.c:399-436: CIGARs, boundary fixes, mapQ, coordinates."""
    bnt = fm.bnt
    b.aux = [Aux() for _ in range(b.n)]
    gen_cigar(opt, qlen, seq2, fm, b)
    for p, q in zip(b.hits, b.aux):
        q.flag = p.flag & 0xfe
        q.isize = 0
        if p.l == 0:  # unique hit
            q.cigar = fix_cigar(bnt, p, q.cigar) if q.cigar else q.cigar
            q.n_cigar = len(q.cigar) if q.cigar else 0
            # mapQ (bwtsw2_aux.c:423-429); c accumulates in float32
            subo = p.G2 if p.G2 > opt.t else opt.t
            c = np.float32(1.0)
            if (p.flag >> 16) in (1, 2):
                c = np.float32(float(c) * 0.5)
            if p.n_seeds < 2:
                c = np.float32(float(c) * 0.2)
            qual = int(float(c) * (p.G - subo)
                       * (250.0 / p.G + 0.03 / opt.a) + 0.499)
            if qual > 250:
                qual = 250
            if qual < 0:
                qual = 0
            if p.flag & 1:
                qual = 0  # a randomly-picked repetitive hit
            q.qual = qual
            q.pqual = qual
            q.chr = bnt.pos2rid(p.k)
            q.nn = bnt.cnt_ambi(p.k, p.len)
            q.pos = p.k - bnt.contigs[q.chr].offset
        else:
            q.qual, q.n_cigar, q.nn = 0, 0, 0
            q.chr = q.pos = -1


def update_mate_aux(b: HitSet, m: HitSet | None) -> None:
    """bwtsw2_aux.c:438-473: PE flags, mate coordinates, paired mapQ."""
    if m is None:
        return
    for i in range(b.n):
        q = b.aux[i]
        q.flag |= 1
        if m.n == 0:
            q.flag |= 8
        if m.n == 1:
            q.mchr = m.aux[0].chr
            q.mpos = m.aux[0].pos
            if m.aux[0].flag & 0x10:
                q.flag |= 0x20
            if q.chr == q.mchr:
                if q.mpos + m.hits[0].len > q.pos:
                    q.isize = q.mpos + m.hits[0].len - q.pos
                else:
                    q.isize = q.mpos - q.pos - b.hits[0].len
            else:
                q.isize = 0
        else:
            q.mchr = q.mpos = -1
    if b.n == 1 and m.n == 1:
        p = b.hits[0]
        if p.flag & BSW2_FLAG_MATESW:
            if not (p.flag & BSW2_FLAG_TANDEM) and b.aux[0].pqual < 20:
                b.aux[0].pqual = 20
            if b.aux[0].pqual >= m.aux[0].qual:
                b.aux[0].pqual = m.aux[0].qual
        elif (p.flag & 2) and not (m.hits[0].flag & BSW2_FLAG_MATESW):
            if not (p.flag & BSW2_FLAG_TANDEM):
                b.aux[0].pqual += 20
                if b.aux[0].pqual > m.aux[0].qual:
                    b.aux[0].pqual = m.aux[0].qual
                if b.aux[0].pqual < b.aux[0].qual:
                    b.aux[0].pqual = b.aux[0].qual


_CIGAR_SOFT = "MIDNSHP"
_CIGAR_HARD = "MIDNHHP"


def print_hits(bnt, opt: Bsw2Opt, read, b: HitSet | None,
               is_pe: bool) -> str:
    """bwtsw2_aux.c:477-543: SAM text for one read."""
    out = []
    name = read.name
    seq = read.seq  # raw bytes
    qual = read.qual
    lq = len(seq)
    if b is None or b.n == 0:
        line = [f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t", seq.decode("latin-1"),
                "\t" + (qual.decode("latin-1") if qual else "*"), "\n"]
        out.append("".join(line))
    for i in range(b.n if b else 0):
        p = b.hits[i]
        q = b.aux[i]
        hit_type = 0
        if q.cigar is None:
            q.flag |= 0x4
        flag = q.flag | (0x100 if (opt.multi_2nd and i) else 0)
        s = [f"{name}\t{flag}"]
        s.append("\t%s\t%d" % (bnt.contigs[q.chr].name if q.chr >= 0 else "*",
                               q.pos + 1))
        if p.l == 0 and q.cigar is not None:
            table = _CIGAR_HARD if opt.hard_clip else _CIGAR_SOFT
            s.append("\t%d\t" % q.pqual)
            s.append("".join("%d%c" % (ln, table[op]) for op, ln in q.cigar))
        else:
            s.append("\t0\t*")
        if not is_pe:
            s.append("\t*\t0\t0\t")
        else:
            mname = ("=" if q.mchr == q.chr
                     else ("*" if q.mchr < 0 else bnt.contigs[q.mchr].name))
            s.append("\t%s\t%d\t%d\t" % (mname, q.mpos + 1, q.isize))
        beg, end = 0, lq
        if opt.hard_clip and q.cigar:
            if q.cigar[0][0] == 4:
                beg += q.cigar[0][1]
            if q.cigar[-1][0] == 4:
                end -= q.cigar[-1][1]
        if p.flag & 0x10:
            # revcomp slice via one table lookup (the per-base generator
            # was a bwasw profile hotspot)
            arr = np.frombuffer(seq, np.uint8)[lq - end:lq - beg][::-1]
            s.append(np.frombuffer(NT_COMP_TABLE, np.uint8)[arr]
                     .tobytes().decode("latin-1"))
        else:
            s.append(seq[beg:end].decode("latin-1"))
        if qual:
            s.append("\t")
            if p.flag & 0x10:
                s.append(np.frombuffer(qual, np.uint8)[lq - end:lq - beg]
                         [::-1].tobytes().decode("latin-1"))
            else:
                s.append(qual[beg:end].decode("latin-1"))
        else:
            s.append("\t*")
        s.append("\tAS:i:%d\tXS:i:%d\tXF:i:%d\tXE:i:%d\tNM:i:%d"
                 % (p.G, p.G2, p.flag >> 16, p.n_seeds, q.nm))
        if q.nn:
            s.append("\tXN:i:%d" % q.nn)
        if p.l:
            s.append("\tXI:i:%d" % (p.l - p.k + 1))
        if p.flag & BSW2_FLAG_MATESW:
            hit_type |= 1
        if p.flag & BSW2_FLAG_TANDEM:
            hit_type |= 2
        if hit_type:
            s.append("\tXT:i:%d" % hit_type)
        if opt.cpy_cmt and read.comment:
            cmt = read.comment
            if len(cmt) >= 6 and cmt[2] == ":" and cmt[4] == ":":
                s.append("\t" + cmt)
        s.append("\n")
        out.append("".join(s))
    return "".join(out)


def finish_batch_native(_opt: Bsw2Opt, fm, reads, buf: list[HitSet],
                        is_pe: bool, rng) -> str:
    """write_aux + update_mate_aux + print_hits for the whole batch in one
    native call (bsw2.cpp bsw2_finish_batch; bwtsw2_aux.c:399-543).  The
    Python write_aux/print_hits above are the executable spec
    (BWA_TPU_SW2_FINISH=python).  The per-read N-resolution draws stay
    here so the shared drand48 stream advances identically."""
    import ctypes

    from bwa_tpu_torch.native.build import get_lib

    lib = get_lib()
    if not getattr(lib, "_fin_sig", False):
        c32 = ctypes.c_int32
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bsw2_finish_batch.restype = ctypes.c_int64
        lib.bsw2_finish_batch.argtypes = [
            _u8p, ctypes.c_int64,
            _i64p, _i64p, ctypes.c_char_p, _i64p, c32,
            _i64p, _i64p, c32,
            c32, c32, c32, c32,
            c32, c32, c32, c32,
            i32p, i32p,
            c32,
            _u8p, _i64p, _u8p, _u8p, _i64p,
            ctypes.c_char_p, _i64p, ctypes.c_char_p, _i64p,
            _i64p, _i64p,
            ctypes.c_char_p, ctypes.c_int64]
        lib._fin_sig = True
    bnt = fm.bnt
    pac = np.ascontiguousarray(fm.pac, np.uint8)
    ctg_off = np.ascontiguousarray(bnt.offsets(), np.int64)
    ctg_len = np.array([c.length for c in bnt.contigs], np.int64)
    names = b"".join(c.name.encode() + b"\0" for c in bnt.contigs)
    name_off = np.zeros(len(bnt.contigs) + 1, np.int64)
    np.cumsum([len(c.name.encode()) + 1 for c in bnt.contigs],
              out=name_off[1:])
    hole_off = np.array([h.offset for h in bnt.holes], np.int64)
    hole_len = np.array([h.length for h in bnt.holes], np.int64)

    n = len(reads)
    t_arr = np.empty(n, np.int32)
    bw_arr = np.empty(n, np.int32)
    seq_off = np.zeros(n + 1, np.int64)
    qual_off = np.zeros(n + 1, np.int64)
    name2_off = np.zeros(n + 1, np.int64)
    cmt_off = np.zeros(n + 1, np.int64)
    seqs, quals, names2, cmts, codes_parts = [], [], [], [], []
    hit_rows_l = []
    hit_off = np.zeros(n + 1, np.int64)
    for x, rd in enumerate(reads):
        length = len(rd.seq)
        codes = NT4_TABLE[np.frombuffer(rd.seq, dtype=np.uint8)].copy()
        for ii in np.nonzero(codes >= 4)[0]:
            codes[ii] = int(rng.drand48() * 4)
        o = update_opt(_opt, length)
        t_arr[x], bw_arr[x] = o.t, o.bw
        seqs.append(rd.seq)
        codes_parts.append(codes)
        quals.append(rd.qual or b"")
        names2.append(rd.name.encode())
        cmt = rd.comment if (_opt.cpy_cmt and rd.comment) else None
        cmts.append(cmt.encode() if isinstance(cmt, str) else (cmt or b""))
        seq_off[x + 1] = seq_off[x] + length
        qual_off[x + 1] = qual_off[x] + len(quals[-1])
        name2_off[x + 1] = name2_off[x] + len(names2[-1])
        cmt_off[x + 1] = cmt_off[x] + len(cmts[-1])
        b = buf[x]
        for h in b.hits:
            hit_rows_l.append((h.k, h.l, h.flag, h.n_seeds, h.len, h.G,
                               h.G2, h.beg, h.end, h.is_rev))
        hit_off[x + 1] = len(hit_rows_l)
    seq_blob = np.frombuffer(b"".join(seqs), np.uint8)
    codes_blob = np.ascontiguousarray(np.concatenate(codes_parts)
                                      if codes_parts else
                                      np.zeros(0, np.uint8), np.uint8)
    qual_blob = np.frombuffer(b"".join(quals) + b"\0", np.uint8)
    rows = (np.array(hit_rows_l, np.int64).reshape(-1, 10)
            if hit_rows_l else np.zeros((0, 10), np.int64))
    cap = int(sum((hit_off[x + 1] - hit_off[x] + 1)
                  * (2 * (seq_off[x + 1] - seq_off[x]) + 256)
                  for x in range(n)))
    i32p_t = ctypes.POINTER(ctypes.c_int32)
    while True:
        out = ctypes.create_string_buffer(cap)
        r = lib.bsw2_finish_batch(
            pac.ctypes.data_as(_u8p), ctypes.c_int64(fm.l_pac),
            ctg_off.ctypes.data_as(_i64p), ctg_len.ctypes.data_as(_i64p),
            names, name_off.ctypes.data_as(_i64p),
            np.int32(len(bnt.contigs)),
            hole_off.ctypes.data_as(_i64p), hole_len.ctypes.data_as(_i64p),
            np.int32(len(bnt.holes)),
            np.int32(_opt.a), np.int32(_opt.b), np.int32(_opt.q),
            np.int32(_opt.r),
            np.int32(_opt.hard_clip), np.int32(_opt.multi_2nd),
            np.int32(_opt.cpy_cmt), np.int32(1 if is_pe else 0),
            t_arr.ctypes.data_as(i32p_t), bw_arr.ctypes.data_as(i32p_t),
            np.int32(n),
            seq_blob.ctypes.data_as(_u8p), seq_off.ctypes.data_as(_i64p),
            codes_blob.ctypes.data_as(_u8p),
            qual_blob.ctypes.data_as(_u8p), qual_off.ctypes.data_as(_i64p),
            b"".join(names2), name2_off.ctypes.data_as(_i64p),
            b"".join(cmts), cmt_off.ctypes.data_as(_i64p),
            rows.ctypes.data_as(_i64p), hit_off.ctypes.data_as(_i64p),
            out, ctypes.c_int64(cap))
        if r >= 0:
            break
        cap = int(-r) + 16
    return out.raw[:int(r)].decode("latin-1")


# ---------------------------------------------------------------------
# Batch driver (bwtsw2_aux.c:561-644, 727-776)
# ---------------------------------------------------------------------

def aln_core(reads, _opt: Bsw2Opt, fm, idx: Sw2Index, is_pe: bool,
             rng) -> list[str]:
    """bsw2_aln_core: align one batch; returns the SAM text per read."""
    from bwa_tpu_torch.sw2.pair import bsw2_pair

    buf: list[HitSet] = []
    opt = _opt
    for rd in reads:
        length = len(rd.seq)
        opt = update_opt(_opt, length)
        codes = NT4_TABLE[np.frombuffer(rd.seq, dtype=np.uint8)].copy()
        n_amb = 0
        for ii in np.nonzero(codes >= 4)[0]:
            codes[ii] = int(rng.drand48() * 4)  # FIXME-compatible N handling
            n_amb += 1
        if length - n_amb < opt.t:  # too few unambiguous bases
            buf.append(HitSet())
            continue
        seq0 = codes
        seq1 = (3 - codes)[::-1].copy()
        b0 = aln1_core(opt, fm, idx, length, (seq0, seq1), rng)
        needs_rev = any(True for h in b0.hits if h.n_seeds < opt.t_seeds)
        if needs_rev:  # too few seeds: align the reverse complement too
            b1 = aln1_core(opt, fm, idx, length, (seq1, seq0), rng)
            for h in b1.hits:
                x = h.beg
                h.flag ^= 0x10
                h.is_rev ^= 1
                h.beg = length - h.end
                h.end = length - x
            flag_fr(b0, b1)
            merge_hits(b0, b1, length, 0)
            resolve_duphits(None, None, b0, 0)
            resolve_query_overlaps(b0, opt.mask_level, rng)
        buf.append(b0.dup_no_cigar())
    if is_pe:
        bsw2_pair(opt, fm, reads, buf)
    if os.environ.get("BWA_TPU_SW2_FINISH", "native") == "native":
        return [finish_batch_native(_opt, fm, reads, buf, is_pe, rng)]
    for x, rd in enumerate(reads):
        length = len(rd.seq)
        codes = NT4_TABLE[np.frombuffer(rd.seq, dtype=np.uint8)].copy()
        for ii in np.nonzero(codes >= 4)[0]:
            codes[ii] = int(rng.drand48() * 4)
        opt = update_opt(_opt, length)
        write_aux(opt, fm, length, (codes, (3 - codes)[::-1].copy()), buf[x])
    sams = []
    for x, rd in enumerate(reads):
        if is_pe:
            update_mate_aux(buf[x], buf[x ^ 1])
        sams.append(print_hits(fm.bnt, opt, rd, buf[x], is_pe))
    return sams


def bsw2_aln(opt: Bsw2Opt, fm, fn: str, fn2: str | None, out, rng) -> None:
    """bsw2_aln (bwtsw2_aux.c:727-776): stream batches, emit SAM."""
    from bwa_tpu_torch.io.fastq import SeqReader, read_batch

    bnt = fm.bnt
    for c in bnt.contigs:
        out.write(f"@SQ\tSN:{c.name}\tLN:{c.length}\n")
    idx = Sw2Index(fm)
    ks1 = SeqReader(fn)
    ks2 = SeqReader(fn2) if fn2 else None
    is_pe = fn2 is not None
    while True:
        reads = read_batch(ks1, ks2, opt.chunk_size * opt.n_threads,
                           copy_comment=True)
        if not reads:
            break
        size = sum(len(r.seq) for r in reads)
        print(f"[bsw2_aln] read {len(reads)} sequences/pairs ({size} bp) ...",
              file=sys.stderr)
        for s in aln_core(reads, opt, fm, idx, is_pe, rng):
            out.write(s)
    ks1.close()
    if ks2:
        ks2.close()
