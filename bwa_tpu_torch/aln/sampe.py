"""sampe: paired-end backtrack finalization (bwape.c).

Insert-size inference, O(n)-scan pairing with hash_64 tie-breaks, SW
rescue of unmapped/discordant mates, and PE SAM output — bit-exact with
the reference including its numeric quirks (the std accumulator that
starts at -1.0, bwape.c:87+124; the stray +.499 inside a log,
bwape.c:578; int truncations of double expressions).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np

from bwa_tpu_torch.aln import samse as se
from bwa_tpu_torch.aln.opts import BWA_AVG_ERR, GapOpt, PEOpt, cal_maxdiff
from bwa_tpu_torch.aln.sai import SaiReader
from bwa_tpu_torch.aln.samse import (BWA_TYPE_MATESW, BWA_TYPE_NO_MATCH,
                               BWA_TYPE_REPEAT, BWA_TYPE_UNIQUE, SAM_FPD,
                               SAM_FPP, SAM_FR1, SAM_FR2, g_log_n)
from bwa_tpu_torch.aln.seqio import open_reads, read_bt_seqs, seq_reverse
from bwa_tpu_torch.index.fmindex import FMIndex
from bwa_tpu_torch.io.fastq import SeqReader
from bwa_tpu_torch.options import fill_scmat
from bwa_tpu_torch.ops.ksw_host import ksw_align2, ksw_global2
from bwa_tpu_torch.utils.hash64 import hash_64
from bwa_tpu_torch.utils.rand48 import Rand48

OUTLIER_BOUND = 2.0
SW_MIN_MATCH_LEN = 20
SW_MIN_MAPQ = 17
CHUNK = 0x40000
M_SQRT1_2 = 1.0 / math.sqrt(2.0)
M_SQRT2 = math.sqrt(2.0)


@dataclass
class IsizeInfo:
    low: int = 0
    high: int = 0
    high_bayesian: int = 0
    avg: float = -1.0
    std: float = -1.0
    ap_prior: float = 0.0


def infer_isize(seqs0, seqs1, ap_prior: float, L: int) -> IsizeInfo:
    """(bwape.c:81-154)"""
    ii = IsizeInfo()
    isizes = []
    max_len = 1
    for p0, p1 in zip(seqs0, seqs1):
        if p0.mapQ >= 20 and p1.mapQ >= 20:
            x = (p1.pos + p1.len - p0.pos if p0.pos < p1.pos
                 else p0.pos + p0.len - p1.pos)
            if x < 100000:
                isizes.append(x)
        max_len = max(max_len, p0.len, p1.len)
    tot = len(isizes)
    if tot < 20:
        print("[infer_isize] fail to infer insert size: too few good pairs",
              file=sys.stderr)
        return ii
    isizes.sort()
    p25 = isizes[int(tot * 0.25 + 0.5)]
    p50 = isizes[int(tot * 0.50 + 0.5)]
    p75 = isizes[int(tot * 0.75 + 0.5)]
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499)
    ii.low = tmp if tmp > max_len else max_len
    ii.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
    if ii.low > ii.high:
        print("[infer_isize] fail to infer insert size: upper bound is "
              "smaller than read length", file=sys.stderr)
        ii.low = ii.high = 0
        return ii
    inliers = [v for v in isizes if ii.low <= v <= ii.high]
    n = len(inliers)
    ii.avg = sum(inliers) / n
    # NOTE: the reference accumulates variance into a field initialized to
    # -1.0 (bwape.c:87,124) — reproduced on purpose.
    std_acc = -1.0
    for v in inliers:
        std_acc += (v - ii.avg) * (v - ii.avg)
    ii.std = math.sqrt(std_acc / n)
    y = 1.0
    while y < 10.0:
        if 0.5 * math.erfc(y / M_SQRT2) < ap_prior / L * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + 0.499)
    n_ap = sum(1 for v in isizes if v > ii.high_bayesian)
    ii.ap_prior = 0.01 * (n_ap + 0.01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    if math.isnan(ii.std) or p75 > 100000:
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
        print("[infer_isize] fail to infer insert size: weird pairing",
              file=sys.stderr)
        return ii
    y = 1.0
    while y < 10.0:
        if 0.5 * math.erfc(y / M_SQRT2) < ap_prior / L * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + 0.499)
    print(f"[infer_isize] inferred external isize from {n} pairs: "
          f"{ii.avg:.3f} +/- {ii.std:.3f}", file=sys.stderr)
    return ii


def pairing(p, arr, alns, popt: PEOpt, s_mm: int, ii: IsizeInfo) -> int:
    """(bwape.c:156-254); p = [p0, p1]; arr = [(x, y)]; alns = [list0, list1]."""
    cnt_chg = 0
    max_len = max(p[0].full_len, p[1].full_len)
    o_score = subo_score = (1 << 64) - 1
    o_n = subo_n = 0
    o_pos = [None, None]
    arr.sort()
    last_pos = [[None, None], [None, None]]  # [readid][slot]

    def aux(u, v):
        nonlocal o_score, subo_score, o_n, subo_n, o_pos, cnt_chg
        if u is None or u[0] == (1 << 64) - 1:
            return
        l = v[0] + p[v[1] & 1].len - u[0]
        if not (v[0] > u[0] and l >= max_len):
            return
        if not ((ii.high and l <= ii.high_bayesian)
                or (ii.high == 0 and l <= popt.max_isize)):
            return
        r_v = alns[v[1] & 1][v[1] >> 2]
        r_u = alns[u[1] & 1][u[1] >> 2]
        s = (r_v.score + r_u.score) * 10
        if ii.high:
            s += int(-4.343 * math.log(
                0.5 * math.erfc(M_SQRT1_2 * abs(l - ii.avg) / ii.std)) + 0.499)
        s = (s << 32) | (hash_64(((u[0] << 32) | v[0]) & ((1 << 64) - 1))
                         & 0xFFFFFFFF)
        if s >> 32 == o_score >> 32:
            o_n += 1
        elif s >> 32 < o_score >> 32:
            subo_n += o_n
            o_n = 1
        else:
            subo_n += 1
        if s < o_score:
            subo_score = o_score
            o_score = s
            o_pos[u[1] & 1] = u
            o_pos[v[1] & 1] = v
        elif s < subo_score:
            subo_score = s

    for x in arr:
        strand = (x[1] >> 1) & 1
        if strand == 1:
            y = 1 - (x[1] & 1)
            aux(last_pos[y][1], x)
            aux(last_pos[y][0], x)
        else:
            last_pos[x[1] & 1][0] = last_pos[x[1] & 1][1]
            last_pos[x[1] & 1][1] = x

    if o_score == (1 << 64) - 1:
        return 0
    mapQ_p = 0
    if o_n == 1:
        if subo_score == (1 << 64) - 1:
            mapQ_p = 29
        elif (subo_score >> 32) - (o_score >> 32) > s_mm * 10:
            mapQ_p = 23
        else:
            n = min(subo_n, 255)
            mapQ_p = ((subo_score >> 32) - (o_score >> 32)) // 2 - g_log_n[n]
            mapQ_p = max(mapQ_p, 0)
    same0 = (p[0].pos == o_pos[0][0] and p[0].strand == ((o_pos[0][1] >> 1) & 1))
    same1 = (p[1].pos == o_pos[1][0] and p[1].strand == ((o_pos[1][1] >> 1) & 1))
    if same0 and same1:
        if p[0].mapQ > 0 and p[1].mapQ > 0:
            mq = min(p[0].mapQ + p[1].mapQ, 60)
            p[0].mapQ = p[1].mapQ = mq
        else:
            if p[0].mapQ == 0:
                p[0].mapQ = min(mapQ_p + 7, p[1].mapQ)
            if p[1].mapQ == 0:
                p[1].mapQ = min(mapQ_p + 7, p[0].mapQ)
    elif same0:
        p[1].seQ = 0
        p[1].mapQ = min(p[0].mapQ, mapQ_p)
    elif same1:
        p[0].seQ = 0
        p[0].mapQ = min(p[1].mapQ, mapQ_p)
    else:
        p[0].seQ = p[1].seQ = 0
        mapQ_p = max(mapQ_p - 20, 0)
        p[0].mapQ = p[1].mapQ = mapQ_p

    for j in (0, 1):
        w = o_pos[j]
        q = p[j]
        r = alns[w[1] & 1][w[1] >> 2]
        q.extra_flag |= SAM_FPP
        if q.pos != w[0] or q.strand != ((w[1] >> 1) & 1):
            q.n_mm = r.n_mm
            q.n_gapo = r.n_gapo
            q.n_gape = r.n_gape
            q.strand = (w[1] >> 1) & 1
            q.score = r.score
            q.pos = w[0]
            if q.mapQ > 0:
                cnt_chg += 1
    return cnt_chg


_SW_MAT = fill_scmat(1, 3)


def sw_core(fm, length: int, seq: np.ndarray, beg: int, reglen: int):
    """bwa_sw_core (bwape.c:409-494).
    Returns (cigar, new_beg, cnt) or None."""
    l_pac = fm.l_pac
    if reglen < SW_MIN_MATCH_LEN or l_pac - beg < length:
        return None
    n_amb = int((seq >= 4).sum())
    if n_amb / length >= 0.25 or length - n_amb < SW_MIN_MATCH_LEN:
        return None
    # forward-strand reference window (stops at l_pac)
    end = min(beg + reglen, l_pac)
    ref = fm.get_seq(beg, end)
    l = len(ref)
    r = ksw_align2(seq, ref, _SW_MAT, 5, 1, 5, 1,
                   use_byte=length < 250, use_start=True, use_subo=True,
                   thres=0)
    gscore, cigar32 = ksw_global2(seq[r.qb:r.qe + 1], ref[r.tb:r.te + 1],
                                  _SW_MAT, 5, 1, 5, 1, 50)
    if r.score < SW_MIN_MATCH_LEN or r.score2 == r.score or gscore != r.score:
        return None
    x = sum(ln for op, ln in cigar32 if op in (0, 2))
    y = sum(ln for op, ln in cigar32 if op in (0, 1))
    if x < SW_MIN_MATCH_LEN or y < SW_MIN_MATCH_LEN:
        return None
    cigar = list(cigar32)
    start, endq = r.qb, r.qe + 1
    beg += r.tb
    if start:
        cigar = [(3, start)] + cigar
    if endq < length:
        cigar = cigar + [(3, length - endq)]
    # cnt: recount from the final cigar (bwape.c:473-490)
    n_mm = n_gapo = n_gape = 0
    xx, yy = r.tb, r.qb
    for op, ln in cigar:
        if op == 0:
            for t in range(ln):
                if ref[xx + t] < 4 and seq[yy + t] < 4 and ref[xx + t] != seq[yy + t]:
                    n_mm += 1
            xx += ln
            yy += ln
        elif op == 2:
            xx += ln
            n_gapo += 1
            n_gape += ln - 1
        elif op == 1:
            yy += ln
            n_gapo += 1
            n_gape += ln - 1
    cnt = (n_mm << 16) | (n_gapo << 8) | n_gape
    return cigar, beg, cnt


def paired_sw(fm, seqs, popt: PEOpt, ii: IsizeInfo) -> None:
    """bwa_paired_sw (bwape.c:496-622)."""
    if not popt.is_sw or ii.avg < 0.0:
        return
    for p0, p1 in zip(seqs[0], seqs[1]):
        p = [p0, p1]
        if not ((p[0].mapQ >= SW_MIN_MAPQ or p[1].mapQ >= SW_MIN_MAPQ)
                and (p[0].extra_flag & SAM_FPP) == 0):
            continue
        beg = [0, 0]
        end = [0, 0]
        cigar = [None, None]
        cnt = [0, 0]
        mq_adjust = [255, 255]
        for k in (0, 1):
            ref_r = p[1 - k]
            if ref_r.type == BWA_TYPE_NO_MATCH:
                continue
            if ref_r.strand == 0:  # mate on reverse strand, larger coord
                a = int(ref_r.pos + ii.avg - 3 * ii.std - p[k].len * 1.5)
                b = int(a + 6 * ii.std + 2 * p[k].len)
                if a < ref_r.pos + ref_r.len:
                    a = ref_r.pos + ref_r.len
                if b > fm.l_pac:
                    b = fm.l_pac
                seq = p[k].rseq
            else:
                a = int(ref_r.pos + ref_r.len - ii.avg - 3 * ii.std
                        - p[k].len * 0.5)
                b = int(a + 6 * ii.std + 2 * p[k].len)
                if a < 0:
                    a = 0
                if b > ref_r.pos:
                    b = ref_r.pos
                seq = seq_reverse(p[k].seq, False)  # ->seq is reversed
            beg[k], end[k] = a, b
            res = sw_core(fm, p[k].len, seq, beg[k], end[k] - beg[k])
            if res is not None:
                cigar[k], beg[k], cnt[k] = res
            if cigar[k] is not None and p[k].type != BWA_TYPE_NO_MATCH:
                clip = 0
                if cigar[k][0][0] == 3:
                    clip += cigar[k][0][1]
                if cigar[k][-1][0] == 3:
                    clip += cigar[k][-1][1]
                s_old = int((p[k].n_mm * 9 + p[k].n_gapo * 13
                             + p[k].n_gape * 2) / 3.0 * 8.0 + 0.499)
                c = cnt[k]
                s_new = int(((c >> 16) * 9 + ((c >> 8) & 0xFF) * 13
                             + (c & 0xFF) * 2 + clip * 3) / 3.0 * 8.0 + 0.499)
                s_old = int(s_old + (-4.343 * math.log(ii.ap_prior / fm.l_pac)))
                # the reference computes log(.5*erfc(1.5/sqrt2) + .499)
                s_new = s_new + int(-4.343 * math.log(
                    0.5 * math.erfc(M_SQRT1_2 * 1.5) + 0.499))
                if s_old < s_new:
                    mq_adjust[k] = s_new - s_old
                    cigar[k] = None
                else:
                    mq_adjust[k] = s_old - s_new
        k = -1
        mapQ = 0
        if cigar[0] is not None and cigar[1] is not None:
            k = 0 if p[0].mapQ < p[1].mapQ else 1
            mapQ = abs(p[1].mapQ - p[0].mapQ)
        elif cigar[0] is not None:
            k, mapQ = 0, p[1].mapQ
        elif cigar[1] is not None:
            k, mapQ = 1, p[0].mapQ
        if k >= 0 and p[k].pos != beg[k]:
            tmp = p[1 - k].mapQ - p[k].mapQ // 2 - 8
            if tmp <= 0:
                tmp = 1
            mapQ = min(mapQ, tmp)
            p[k].mapQ = p[1 - k].mapQ = mapQ
            p[k].seQ = p[1 - k].seQ = min(p[1 - k].seQ, mapQ)
            if p[k].mapQ > mq_adjust[k]:
                p[k].mapQ = mq_adjust[k]
            if p[k].seQ > mq_adjust[k]:
                p[k].seQ = mq_adjust[k]
            p[k].cigar = cigar[k]
            # __set_fixed (bwape.c:539-547)
            p[k].type = BWA_TYPE_MATESW
            p[k].pos = beg[k]
            p[k].seQ = p[1 - k].seQ
            p[k].strand = 1 - p[1 - k].strand
            c = cnt[k]
            p[k].n_mm = c >> 16
            p[k].n_gapo = (c >> 8) & 0xFF
            p[k].n_gape = c & 0xFF
            p[k].extra_flag |= SAM_FPP
            p[1 - k].extra_flag |= SAM_FPP


def sampe_core(prefix, fn_sa, fn_fa, popt: PEOpt, rg_id, rg_line, out,
               fm=None) -> None:
    """bwa_sai2sam_pe_core (bwape.c:624-731)."""
    import os

    from bwa_tpu_torch import __version__
    from bwa_tpu_torch.cli import _hdr_lines
    from bwa_tpu_torch.ops.fm_host import HostFM

    se.initialize()
    if fm is None:
        fm = FMIndex.load(prefix)
    rng = Rand48(fm.bnt.seed)
    fps = [open(fn_sa[0], "rb"), open(fn_sa[1], "rb")]
    sais = [SaiReader(fps[0]), SaiReader(fps[1])]
    opt0, opt = sais[0].opt, sais[1].opt
    readers = [open_reads(opt0.mode, fn_fa[0]),
               open_reads(opt.mode if len(fn_fa) > 1 else opt0.mode, fn_fa[1])]
    last_ii = IsizeInfo()
    pg = (f"@PG\tID:bwa\tPN:bwa-tpu-torch\tVN:{__version__}"
          "\tCL:bwa-tpu-torch sampe")
    out.write(_hdr_lines(fm.bnt, rg_line, pg))

    if os.environ.get("BWA_TPU_SAMPE", "native") == "native":
        import numpy as np

        from bwa_tpu_torch.aln.driver import _sampe_batch_native
        from bwa_tpu_torch.aln.seqio import read_bt_packed

        rest = [memoryview(fps[0].read()), memoryview(fps[1].read())]
        ii_state = np.array([0.0, 0.0, 0.0, -1.0, -1.0, 0.0])
        while True:
            pk0 = read_bt_packed(readers[0], CHUNK, opt0.mode,
                                 opt0.trim_qual)
            if pk0.n == 0:
                break
            pk1 = read_bt_packed(readers[1], CHUNK, opt.mode, opt.trim_qual)
            sam, u0, u1 = _sampe_batch_native(
                fm, pk0, pk1, rest[0], rest[1], opt0, opt, popt,
                ii_state, rg_id, rng)
            rest[0] = rest[0][u0:]
            rest[1] = rest[1][u1:]
            out.write(sam)
        return

    engine = HostFM(fm)
    while True:
        seqs0 = read_bt_seqs(readers[0], CHUNK, opt0.mode, opt0.trim_qual)
        if not seqs0:
            break
        seqs1 = read_bt_seqs(readers[1], CHUNK, opt.mode, opt.trim_qual)
        seqs = [seqs0, seqs1]
        n_seqs = len(seqs0)
        bufs = [[None] * n_seqs, [None] * n_seqs]

        # SE phase (bwape.c:279-303)
        for i in range(n_seqs):
            for j in (0, 1):
                p = seqs[j][i]
                p.extra_flag |= SAM_FPD | (SAM_FR1 if j == 0 else SAM_FR2)
                alns = sais[j].read_read()
                bufs[j][i] = alns
                se.aln2seq_core(alns, p, rng, True, 0)
                if p.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
                    gopt = opt
                    max_diff = (cal_maxdiff(p.len, BWA_AVG_ERR, gopt.fnr)
                                if gopt.fnr > 0.0 else gopt.max_diff)
                    p.seQ = p.mapQ = se.approx_mapQ(p, max_diff)
                    p.pos, p.strand = se.sa2pos(fm, engine, p.sa,
                                                p.len + p.ref_shift)
                    if p.pos == -1:
                        p.type = BWA_TYPE_NO_MATCH

        ii = infer_isize(seqs0, seqs1, popt.ap_prior, fm.seq_len // 2)
        if ii.avg < 0.0 < last_ii.avg:
            ii = last_ii
        if popt.force_isize:
            print(f"[sampe_core] discard insert size estimate as user's "
                  "request.", file=sys.stderr)
            ii.low = ii.high = 0
            ii.avg = ii.std = -1.0

        # PE phase (bwape.c:314-389)
        for i in range(n_seqs):
            p = [seqs[0][i], seqs[1][i]]
            d_aln = [bufs[0][i], bufs[1][i]]
            if (p[0].type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)
                    and p[1].type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)):
                n_occ = [sum(r.l - r.k + 1 for r in d_aln[j]) for j in (0, 1)]
                if not (n_occ[0] > popt.max_occ or n_occ[1] > popt.max_occ):
                    import numpy as _np

                    ranks = []
                    meta = []
                    for j in (0, 1):
                        for kidx, r in enumerate(d_aln[j]):
                            for l in range(r.k, r.l + 1):
                                ranks.append(l)
                                meta.append((j, kidx))
                    pos_f = engine.sa_many(_np.asarray(ranks,
                                                       dtype=_np.int64))
                    arr = []
                    for (j, kidx), pf in zip(meta, pos_f):
                        pos, strand = se.pos2coord(
                            fm, int(pf), p[j].len + p[j].ref_shift)
                        arr.append((pos if pos != -1 else (1 << 64) - 1,
                                    (kidx << 2) | (strand << 1) | j))
                    pairing(p, arr, d_aln, popt, opt.s_mm, ii)

            if popt.N_multi or popt.n_multi:
                for j in (0, 1):
                    if p[j].type != BWA_TYPE_NO_MATCH:
                        if (not (p[j].extra_flag & SAM_FPP)
                                and p[1 - j].type != BWA_TYPE_NO_MATCH):
                            nm = (popt.n_multi
                                  if p[j].c1 + p[j].c2 - 1 > popt.N_multi
                                  else popt.N_multi)
                            se.aln2seq_core(d_aln[j], p[j], rng, False, nm)
                        else:
                            se.aln2seq_core(d_aln[j], p[j], rng, False,
                                            popt.n_multi)
                        kept = []
                        for q in p[j].multi:
                            q.pos, q.strand = se.sa2pos(
                                fm, engine, q.pos, p[j].len + q.ref_shift)
                            if q.pos != p[j].pos and q.pos != -1:
                                kept.append(q)
                        p[j].multi = kept
                        p[j].n_multi = len(kept)

        paired_sw(fm, seqs, popt, ii)
        for j in (0, 1):
            se.refine_gapped(fm, seqs[j])
        for i in range(n_seqs):
            p = [seqs[0][i], seqs[1][i]]
            if p[0].bc or p[1].bc:
                p[0].bc = p[0].bc + p[1].bc
                p[1].bc = p[0].bc
            se.print_sam1(fm, p[0], p[1], opt.mode, opt.max_top2, rg_id, out)
            se.print_sam1(fm, p[1], p[0], opt.mode, opt.max_top2, rg_id, out)
            if p[0].name != p[1].name:
                raise RuntimeError("paired reads have different names")
        last_ii = ii
