"""samse: .sai -> SAM (bwase.c).

Hit sampling among equal-best via bit-exact drand48, SA->position
conversion, gapped refinement with ksw_global (match=1, mismatch=3,
gapo=5, gape=1), MD/NM, and the exact SAM text of bwa_print_sam1.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from bwa_tpu_torch.aln.opts import BWA_AVG_ERR, BWA_MODE_COMPREAD, GapOpt, cal_maxdiff
from bwa_tpu_torch.aln.seqio import BtSeq, seq_reverse
from bwa_tpu_torch.options import fill_scmat
from bwa_tpu_torch.ops.ksw_host import ksw_global2

BWA_TYPE_NO_MATCH = 0
BWA_TYPE_UNIQUE = 1
BWA_TYPE_REPEAT = 2
BWA_TYPE_MATESW = 3

SAM_FPD = 1
SAM_FPP = 2
SAM_FSU = 4
SAM_FMU = 8
SAM_FSR = 16
SAM_FMR = 32
SAM_FR1 = 64
SAM_FR2 = 128

SW_BW = 50

g_log_n = [0] * 256


def initialize():
    for i in range(1, 256):
        g_log_n[i] = int(4.343 * math.log(i) + 0.5)


class Multi:
    __slots__ = ("pos", "gap", "mm", "strand", "ref_shift", "cigar", "n_cigar")

    def __init__(self, pos, gap, mm, ref_shift):
        self.pos = pos
        self.gap = gap
        self.mm = mm
        self.strand = 0
        self.ref_shift = ref_shift
        self.cigar = None


def aln2seq_core(alns, s: BtSeq, rng, set_main: bool, n_multi: int) -> None:
    """bwa_aln2seq_core (bwase.c:22-94); rng is the shared drand48 state."""
    if not alns:
        s.type = BWA_TYPE_NO_MATCH
        s.c1 = s.c2 = 0
        return
    if set_main:
        best = alns[0].score
        cnt = 0
        i = 0
        for i, p in enumerate(alns):
            if p.score > best:
                break
            if rng.drand48() * (p.l - p.k + 1 + cnt) > float(cnt):
                s.n_mm = p.n_mm
                s.n_gapo = p.n_gapo
                s.n_gape = p.n_gape
                s.ref_shift = p.n_del - p.n_ins
                s.score = p.score
                s.sa = p.k + int((p.l - p.k + 1) * rng.drand48())
            cnt += p.l - p.k + 1
        else:
            i = len(alns)
        s.c1 = cnt
        for p in alns[i:]:
            cnt += p.l - p.k + 1
        s.c2 = cnt - s.c1
        s.type = BWA_TYPE_REPEAT if s.c1 > 1 else BWA_TYPE_UNIQUE

    if n_multi:
        n_occ = sum(q.l - q.k + 1 for q in alns)
        s.multi = []
        s.n_multi = 0
        if n_occ > n_multi + 1:
            return
        rest = min(n_occ, n_multi + 1)
        for q in alns:
            if q.l - q.k + 1 <= rest:
                for l in range(q.k, q.l + 1):
                    s.multi.append(Multi(l, q.n_gapo + q.n_gape, q.n_mm,
                                         q.n_del - q.n_ins))
                rest -= q.l - q.k + 1
            else:  # random sampling; "we never come here" in practice
                i = q.l - q.k + 1
                for j in range(rest, 0, -1):
                    p = 1.0
                    x = rng.drand48()
                    while x < p:
                        p -= p * j / i
                        i -= 1
                    s.multi.append(Multi(q.l - i, q.n_gapo + q.n_gape,
                                         q.n_mm, q.n_del - q.n_ins))
                rest = 0
                break
        s.n_multi = len(s.multi)


def approx_mapQ(p: BtSeq, mm: int) -> int:
    """bwa_approx_mapQ (bwase.c:101-110)."""
    if p.c1 == 0:
        return 23
    if p.c1 > 1:
        return 0
    if p.n_mm == mm:
        return 25
    if p.c2 == 0:
        return 37
    n = 255 if p.c2 >= 255 else p.c2
    return 0 if 23 < g_log_n[n] else 23 - g_log_n[n]


def sa2pos(fm, engine, sapos: int, ref_len: int):
    """bwa_sa2pos (bwase.c:112-123); returns (pos, strand) or (-1, 0)."""
    return pos2coord(fm, engine.sa(sapos), ref_len)


def pos2coord(fm, pos_f: int, ref_len: int):
    """The coordinate/strand step of bwa_sa2pos given the SA value."""
    if pos_f < fm.l_pac < pos_f + ref_len:
        return -1, 0
    pos_f, is_rev = fm.bnt.depos(pos_f)
    strand = int(not is_rev)
    if is_rev:
        pos_f = 0 if pos_f + 1 < ref_len else pos_f - ref_len + 1
    return pos_f, strand


_REFINE_MAT = fill_scmat(1, 3)


def refine_gapped_core(fm, length: int, seq: np.ndarray, ref_shift: int,
                       rb: int):
    """bwa_refine_gapped_core (bwase.c:169-199).
    Returns (cigar [(op,len)], new_rb) or None."""
    re_ = rb + length + ref_shift
    assert re_ <= fm.l_pac
    rseq = fm.get_seq(rb, re_)
    rlen = len(rseq)
    assert re_ - rb == rlen
    w = int(abs(rlen - length) * 1.5)
    _, cigar = ksw_global2(seq, rseq, _REFINE_MAT, 5, 1, 5, 1, max(SW_BW, w))
    assert cigar
    if cigar[-1][0] == 1:
        cigar[-1] = (3, cigar[-1][1])
    if cigar[0][0] == 1:
        cigar[0] = (3, cigar[0][1])
    if cigar and cigar[-1][0] == 2:
        cigar = cigar[:-1]
    if cigar and cigar[0][0] == 2:
        rb += cigar[0][1]
        cigar = cigar[1:]
    return cigar, rb


def cal_md1(n_cigar_cigar, length, pos, seq, fm):
    """bwa_cal_md1 (bwase.c:201-249); returns (md, nm).

    M segments are scanned vectorized (packed-pac bit extraction over
    the segment + one mismatch mask); only actual mismatches loop in
    Python.  Reference codes are always 0..3, so the original c > 3
    branch can never fire and the mask reduces to (ref != read) | (read
    > 3) — identical output."""
    pac = fm.pac
    l_pac = fm.l_pac
    sq = np.asarray(seq, dtype=np.uint8)

    md = []
    nm = 0
    x, y, u = pos, 0, 0
    cigar = n_cigar_cigar if n_cigar_cigar else [(0, length)]

    def pac_at(t):
        return (pac[t >> 2] >> ((~t & 3) << 1)) & 3

    for op, ln in cigar:
        if op == 0:  # M
            upto = max(0, min(ln, l_pac - x))
            if upto:
                idx = np.arange(x, x + upto, dtype=np.int64)
                refc = (pac[idx >> 2] >> (((~idx).astype(np.int64) & 3)
                                          << 1).astype(np.uint8)) & 3
                s = sq[y:y + upto]
                mism = np.flatnonzero((refc != s) | (s > 3))
                prev = -1
                for z in mism.tolist():
                    md.append(str(z - prev - 1 + (u if prev < 0 else 0)))
                    md.append("ACGTN"[int(refc[z])])
                    prev = z
                nm += len(mism)
                if len(mism):
                    u = upto - 1 - int(mism[-1])
                else:
                    u += upto
            x += ln
            y += ln
        elif op in (1, 3):  # I or S
            y += ln
            if op == 1:
                nm += ln
        elif op == 2:  # D
            md.append(str(u))
            md.append("^")
            upto = max(0, min(ln, l_pac - x))
            if upto:
                idx = np.arange(x, x + upto, dtype=np.int64)
                refc = (pac[idx >> 2] >> (((~idx).astype(np.int64) & 3)
                                          << 1).astype(np.uint8)) & 3
                md.append("".join("ACGT"[c] for c in refc.tolist()))
            u = 0
            x += ln
            nm += ln
    md.append(str(u))
    return "".join(md), nm


def correct_trimmed(s: BtSeq) -> None:
    """bwa_correct_trimmed (bwase.c:251-285)."""
    if s.len == s.full_len:
        return
    clip = s.full_len - s.len
    if s.strand == 0:
        if s.cigar and s.cigar[-1][0] == 3:
            s.cigar[-1] = (3, s.cigar[-1][1] + clip)
        else:
            if s.cigar is None:
                s.cigar = [(0, s.len)]
            s.cigar = s.cigar + [(3, clip)]
    else:
        if s.cigar and s.cigar[0][0] == 3:
            s.cigar[0] = (3, s.cigar[0][1] + clip)
        else:
            if s.cigar is None:
                s.cigar = [(0, s.len)]
            s.cigar = [(3, clip)] + s.cigar
    s.len = s.full_len


def refine_gapped(fm, seqs: list[BtSeq]) -> None:
    """bwa_refine_gapped (bwase.c:287-331).  seq arrays here are kept in
    original orientation already (BtSeq.seq is reversed; we reverse back
    like the reference does)."""
    for s in seqs:
        s.seq = seq_reverse(s.seq, False)  # now original orientation
        kept = []
        for q in s.multi:
            if q.gap:
                res = refine_gapped_core(
                    fm, s.len, s.rseq if q.strand else s.seq, q.ref_shift,
                    q.pos)
                if res is not None:
                    q.cigar, q.pos = res
                    kept.append(q)
            else:
                kept.append(q)
        s.multi = kept
        s.n_multi = len(kept)
        if s.type in (BWA_TYPE_NO_MATCH, BWA_TYPE_MATESW) or s.n_gapo == 0:
            continue
        res = refine_gapped_core(fm, s.len, s.rseq if s.strand else s.seq,
                                 s.ref_shift, s.pos)
        if res is None:
            s.type = BWA_TYPE_NO_MATCH
        else:
            s.cigar, s.pos = res
    for s in seqs:
        if s.type != BWA_TYPE_NO_MATCH:
            s.md, s.nm = cal_md1(s.cigar, s.len, s.pos,
                                 s.rseq if s.strand else s.seq, fm)
    for s in seqs:
        correct_trimmed(s)


def pos_end(p: BtSeq) -> int:
    if p.cigar:
        return p.pos + sum(ln for op, ln in p.cigar if op in (0, 2))
    return p.pos + p.len


def pos_end_multi(q, length: int) -> int:
    if q.cigar:
        return q.pos + sum(ln for op, ln in q.cigar if op in (0, 2))
    return q.pos + length


def _pos_5(p: BtSeq) -> int:
    if p.type != BWA_TYPE_NO_MATCH:
        return pos_end(p) if p.strand else p.pos
    return -1


_FWD_TAB = np.frombuffer(b"ACGTN", dtype=np.uint8)
_REV_TAB = np.frombuffer(b"TGCAN", dtype=np.uint8)


def print_seq_txt(p: BtSeq) -> str:
    """bwa_print_seq (bwase.c:366-384): full_len bases of the ORIGINAL
    read (the reference's in-place reversals restore the full array by
    print time, including the trimmed tail).  One numpy table lookup —
    the per-base join was the hottest line of the samse profile."""
    codes = np.asarray(p.full_codes[:p.full_len], dtype=np.uint8)
    codes = np.minimum(codes, 4)
    if p.strand == 0:
        return _FWD_TAB[codes].tobytes().decode()
    return _REV_TAB[codes[::-1]].tobytes().decode()


def print_sam1(fm, p: BtSeq, mate: BtSeq | None, mode: int, max_top2: int,
               rg_id: str | None, out) -> None:
    """bwa_print_sam1 (bwase.c:386-499).  Text parts accumulate in a list
    and flush as ONE stream write (the profile showed 100k+ tiny writes)."""
    bns = fm.bnt
    parts = []
    _w = parts.append
    if p.type != BWA_TYPE_NO_MATCH or (mate and mate.type != BWA_TYPE_NO_MATCH):
        flag = p.extra_flag
        if p.type == BWA_TYPE_NO_MATCH:
            p.pos = mate.pos
            p.strand = mate.strand
            flag |= SAM_FSU
            j = 1
        else:
            j = pos_end(p) - p.pos
        nn = bns.cnt_ambi(p.pos, j)
        seqid = bns.pos2rid(p.pos)
        if (p.type != BWA_TYPE_NO_MATCH
                and p.pos + j - bns.contigs[seqid].offset > bns.contigs[seqid].length):
            flag |= SAM_FSU
        if p.strand:
            flag |= SAM_FSR
        if mate:
            if mate.type != BWA_TYPE_NO_MATCH:
                if mate.strand:
                    flag |= SAM_FMR
            else:
                flag |= SAM_FMU
        _w(f"{p.name}\t{flag}\t{bns.contigs[seqid].name}\t")
        _w(f"{p.pos - bns.contigs[seqid].offset + 1}\t{p.mapQ}\t")
        if p.cigar:
            _w("".join(f"{ln}{'MIDS'[op]}" for op, ln in p.cigar))
        elif p.type == BWA_TYPE_NO_MATCH:
            _w("*")
        else:
            _w(f"{p.len}M")
        am = 0
        if mate and mate.type != BWA_TYPE_NO_MATCH:
            am = min(mate.seQ, p.seQ)
            m_seqid = bns.pos2rid(mate.pos)
            _w("\t=\t" if seqid == m_seqid
                      else f"\t{bns.contigs[m_seqid].name}\t")
            isize = _pos_5(mate) - _pos_5(p) if seqid == m_seqid else 0
            if p.type == BWA_TYPE_NO_MATCH:
                isize = 0
            _w(f"{mate.pos - bns.contigs[m_seqid].offset + 1}\t{isize}\t")
        elif mate:
            _w(f"\t=\t{p.pos - bns.contigs[seqid].offset + 1}\t0\t")
        else:
            _w("\t*\t0\t0\t")
        _w(print_seq_txt(p))
        _w("\t")
        if p.qual is not None:
            if p.strand:
                q = p.qual[:p.len][::-1] + p.qual[p.len:]
                p.qual = bytearray(q)
            _w(p.qual.decode())
        else:
            _w("*")
        if rg_id:
            _w(f"\tRG:Z:{rg_id}")
        if p.bc:
            _w(f"\tBC:Z:{p.bc}")
        if p.clip_len < p.full_len:
            _w(f"\tXC:i:{p.clip_len}")
        if p.type != BWA_TYPE_NO_MATCH:
            XT = "NURM"[p.type]
            if nn > 10:
                XT = "N"
            nm_tag = "NM" if mode & BWA_MODE_COMPREAD else "CM"
            _w(f"\tXT:A:{XT}\t{nm_tag}:i:{p.nm}")
            if nn:
                _w(f"\tXN:i:{nn}")
            if mate:
                _w(f"\tSM:i:{p.seQ}\tAM:i:{am}")
            if p.type != BWA_TYPE_MATESW:
                _w(f"\tX0:i:{p.c1}")
                if p.c1 <= max_top2:
                    _w(f"\tX1:i:{p.c2}")
            _w(f"\tXM:i:{p.n_mm}\tXO:i:{p.n_gapo}\tXG:i:{p.n_gapo + p.n_gape}")
            if p.md:
                _w(f"\tMD:Z:{p.md}")
            if p.n_multi:
                _w("\tXA:Z:")
                for q in p.multi:
                    j = pos_end_multi(q, p.len) - q.pos
                    sq = bns.pos2rid(q.pos)
                    _w(f"{bns.contigs[sq].name},"
                              f"{'-' if q.strand else '+'}"
                              f"{q.pos - bns.contigs[sq].offset + 1},")
                    if q.cigar:
                        _w("".join(f"{ln}{'MIDS'[op]}"
                                          for op, ln in q.cigar))
                    else:
                        _w(f"{p.len}M")
                    _w(f",{q.gap + q.mm};")
        _w("\n")
        out.write("".join(parts))
        return
    else:
        flag = p.extra_flag | SAM_FSU
        if mate and mate.type == BWA_TYPE_NO_MATCH:
            flag |= SAM_FMU
        _w(f"{p.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t")
        _w(print_seq_txt(p))
        _w("\t")
        if p.qual is not None:
            if p.strand:
                p.qual = bytearray(p.qual[:p.len][::-1] + p.qual[p.len:])
            _w(p.qual.decode())
        else:
            _w("*")
        if rg_id:
            _w(f"\tRG:Z:{rg_id}")
        if p.bc:
            _w(f"\tBC:Z:{p.bc}")
        if p.clip_len < p.full_len:
            _w(f"\tXC:i:{p.clip_len}")
        _w("\n")
    out.write("".join(parts))


def cal_pac_pos(fm, engine, seqs: list[BtSeq], max_mm: int, fnr: float) -> None:
    """bwa_cal_pac_pos (bwase.c:131-165); SA lookups batched through the
    native walker (one call per read batch)."""
    import numpy as np

    ranks = []
    for p in seqs:
        if p.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            ranks.append(p.sa)
        for q in p.multi:
            ranks.append(q.pos)
    pos_f = engine.sa_many(np.asarray(ranks, dtype=np.int64))
    pi = 0
    for p in seqs:
        if p.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            max_diff = (cal_maxdiff(p.len, BWA_AVG_ERR, fnr)
                        if fnr > 0.0 else max_mm)
            p.seQ = p.mapQ = approx_mapQ(p, max_diff)
            p.pos, p.strand = pos2coord(fm, int(pos_f[pi]),
                                        p.len + p.ref_shift)
            pi += 1
            p.seQ = p.mapQ = approx_mapQ(p, max_diff)
            if p.pos == -1:
                p.type = BWA_TYPE_NO_MATCH
        kept = []
        for q in p.multi:
            q.pos, q.strand = pos2coord(fm, int(pos_f[pi]),
                                        p.len + q.ref_shift)
            pi += 1
            if q.pos != p.pos and q.pos != -1:
                kept.append(q)
        p.multi = kept
        p.n_multi = len(kept)
