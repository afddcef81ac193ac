"""CIGAR/MD/NM generation: bwa_gen_cigar2 (bwa.c:148-234) and
mem_reg2aln (bwamem.c:1119-1189)."""

from __future__ import annotations

import numpy as np

from bwa_tpu_torch.mem.types import MemAln, MemAlnReg
from bwa_tpu_torch.mem.primary import approx_mapq_se
from bwa_tpu_torch.ops.ksw_host import ksw_global2

_INT2BASE_F = "ACGTN"
_INT2BASE_R = "TGCAN"


def gen_cigar2(opt, fm, l_query: int, query: np.ndarray, rb: int, re: int,
               want_cigar: bool = True):
    """Returns (score, cigar [(op,len)] or None, NM, MD string or None).

    query: nt4 codes for the aligned query slice (length l_query); reversed
    internally for reverse-strand hits so indels left-align like the
    reference.
    """
    mat = opt.mat
    l_pac = fm.l_pac
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return None
    rseq = fm.get_seq(rb, re)
    rlen = len(rseq)
    if re - rb != rlen:
        return None
    if rb >= l_pac:  # reverse both so indels go leftmost
        query = query[::-1]
        rseq = rseq[::-1]
    if l_query == re - rb and opt.w == 0:
        # no-gap shortcut (bwa.c:168-176); w_==0 never happens from
        # mem_reg2aln but keep it for API parity
        cigar = [(0, l_query)] if want_cigar else None
        score = int(sum(int(mat[rseq[i], query[i]]) for i in range(l_query)))
    else:
        w_ = gen_cigar_w(opt, l_query, rlen, opt_w=None)
        score, cigar = _nw(opt, query, rseq, w_, want_cigar)
    NM, md = None, None
    if want_cigar and cigar is not None:
        NM, md = _md_nm(query, rseq, cigar, rb < l_pac)
    return score, cigar, NM, md


def gen_cigar_w(opt, l_query: int, rlen: int, opt_w=None) -> int:
    """Band width selection inside bwa_gen_cigar2 (bwa.c:178-187)."""
    w_cap = opt.w if opt_w is None else opt_w
    max_ins = int((((l_query + 1) >> 1) * int(opt.mat[0, 0]) - opt.o_ins) / opt.e_ins + 1.0)
    max_del = int((((l_query + 1) >> 1) * int(opt.mat[0, 0]) - opt.o_del) / opt.e_del + 1.0)
    max_gap = max(max_ins, max_del, 1)
    w = (max_gap + abs(rlen - l_query) + 1) >> 1
    w = min(w, w_cap)
    min_w = abs(rlen - l_query) + 3
    return max(w, min_w)


def _nw(opt, query, rseq, w, want_cigar):
    return ksw_global2(query, rseq, opt.mat, opt.o_del, opt.e_del,
                       opt.o_ins, opt.e_ins, w, want_cigar=want_cigar)


def gen_cigar2_full(opt, fm, l_query, query, rb, re, w_, want_cigar=True):
    """bwa_gen_cigar2 with an explicit band cap w_ (used by mem_reg2aln's
    band-doubling retry and by mem_patch_reg)."""
    l_pac = fm.l_pac
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return None
    rseq = fm.get_seq(rb, re)
    rlen = len(rseq)
    if re - rb != rlen:
        return None
    if rb >= l_pac:
        query = query[::-1]
        rseq = rseq[::-1]
    if l_query == re - rb and w_ == 0:
        cigar = [(0, l_query)] if want_cigar else None
        score = int(opt.mat[rseq, query].astype(np.int64).sum())
    else:
        w = gen_cigar_w(opt, l_query, rlen, opt_w=w_)
        score, cigar = _nw(opt, query, rseq, w, want_cigar)
    NM, md = None, None
    if want_cigar and cigar is not None:
        NM, md = _md_nm(query, rseq, cigar, rb < l_pac)
    return score, cigar, NM, md


def _md_nm(query, rseq, cigar, is_fwd: bool):
    """MD/NM computation (bwa.c:196-225)."""
    int2base = _INT2BASE_F if is_fwd else _INT2BASE_R
    md = []
    x = y = u = 0
    n_mm = n_gap = 0
    n_cigar = len(cigar)
    for ci, (op, ln) in enumerate(cigar):
        if op == 0:  # match run
            for i in range(ln):
                if query[x + i] != rseq[y + i]:
                    md.append(str(u))
                    md.append(int2base[rseq[y + i]])
                    n_mm += 1
                    u = 0
                else:
                    u += 1
            x += ln
            y += ln
        elif op == 2:  # deletion
            if 0 < ci < n_cigar - 1:
                md.append(str(u))
                md.append("^")
                for i in range(ln):
                    md.append(int2base[rseq[y + i]])
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:  # insertion
            x += ln
            n_gap += ln
    md.append(str(u))
    return n_mm + n_gap, "".join(md)


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """(bwamem.c:818-825)"""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def reg2aln(opt, fm, l_query: int, query_codes: np.ndarray,
            ar: MemAlnReg | None) -> MemAln:
    """mem_reg2aln (bwamem.c:1119-1189)."""
    a = MemAln()
    a.score = a.sub = 0  # the reference memsets mem_aln_t (bwamem.c:1126)
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins)
    w2 = max(w2, tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    i = 0
    cigar = None
    NM = -1
    md = ""
    score = 0
    while True:
        w2 = min(w2, opt.w << 2)
        res = gen_cigar2_full(opt, fm, qe - qb, query_codes[qb:qe], rb, re, w2)
        assert res is not None
        score, cigar, NM, md = res
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    a.NM = NM
    pos, is_rev = fm.bnt.depos(rb if rb < fm.l_pac else re - 1)
    a.is_rev = is_rev
    if cigar:
        # squeeze leading/trailing deletions (bwamem.c:1157-1166)
        if cigar[0][0] == 2:
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # soft-clip ends
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    a.cigar = cigar
    a.md = md
    a.rid = fm.bnt.pos2rid(pos)
    assert a.rid == ar.rid
    a.pos = pos - fm.bnt.contigs[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a
