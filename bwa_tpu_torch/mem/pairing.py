"""Paired-end machinery: insert-size inference, mate rescue, pairing and
PE SAM emission (bwamem_pair.c).

The default route runs these steps in the C++ finalize
(native/memfin.cpp); this module is the BWA_TPU_FINALIZE=python route, and
its PEStat carries the user's -I setting into either."""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import numpy as np

from bwa_tpu_torch.mem.cigar import reg2aln
from bwa_tpu_torch.mem.ksort import ks_introsort
from bwa_tpu_torch.mem.primary import approx_mapq_se, mark_primary_se, reorder_primary5, sort_dedup_patch
from bwa_tpu_torch.mem.sam import aln2sam, gen_alt, reg2sam
from bwa_tpu_torch.mem.types import MemAln, MemAlnReg
from bwa_tpu_torch.options import (MEM_F_ALL, MEM_F_NO_RESCUE, MEM_F_NOPAIRING,
                             MEM_F_PRIMARY5)
from bwa_tpu_torch.ops.ksw_host import ksw_align2
from bwa_tpu_torch.utils.hash64 import hash_64

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


@dataclass
class PEStat:
    low: int = 0
    high: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0


def infer_dir(l_pac: int, b1: int, b2: int):
    """mem_infer_dir (bwamem_pair.c:49-56): returns (dir, dist)."""
    r1, r2 = int(b1 >= l_pac), int(b2 >= l_pac)
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def _cal_sub(opt, r: list[MemAlnReg]) -> int:
    for j in range(1, len(r)):
        b_max = max(r[j].qb, r[0].qb)
        e_min = min(r[j].qe, r[0].qe)
        if e_min > b_max:
            min_l = min(r[j].qe - r[j].qb, r[0].qe - r[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return r[j].score
    return opt.min_seed_len * opt.a


def pestat_candidates(opt, l_pac: int,
                      regs: list[list[MemAlnReg]]) -> list[tuple[int, int]]:
    """The per-pair candidate extraction half of mem_pestat
    (bwamem_pair.c:76-89), apart from pestat_from_candidates so that the
    (dir, isize) lists of several workers can be merged before the
    estimate (the reference's only cross-worker sync, bwamem.c:1256-1259)."""
    cands: list[tuple[int, int]] = []
    n = len(regs)
    for i in range(n >> 1):
        r0, r1 = regs[i * 2], regs[i * 2 + 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            cands.append((d, dist))
    return cands


def pestat_from_candidates(opt, cands) -> list[PEStat]:
    """The distribution-fitting half of mem_pestat: candidate (dir,isize)
    pairs -> per-orientation bounds.  Each isize list is sorted before any
    float accumulation, so the result is independent of gather order --
    sharded and single-device runs produce bit-identical PEStat."""
    pes = [PEStat() for _ in range(4)]
    isize: list[list[int]] = [[], [], [], []]
    for d, dist in cands:
        isize[int(d)].append(int(dist))
    print("[M::mem_pestat] # candidate unique pairs for (FF, FR, RF, RR): "
          f"({len(isize[0])}, {len(isize[1])}, {len(isize[2])}, {len(isize[3])})",
          file=sys.stderr)
    for d in range(4):
        r = pes[d]
        q = isize[d]
        ori = "FR"[d >> 1 & 1] + "FR"[d & 1]
        if len(q) < MIN_DIR_CNT:
            print(f"[M::mem_pestat] skip orientation {ori} as there are not "
                  "enough pairs", file=sys.stderr)
            r.failed = 1
            continue
        print(f"[M::mem_pestat] analyzing insert size distribution for "
              f"orientation {ori}...", file=sys.stderr)
        q.sort()
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        print(f"[M::mem_pestat] (25, 50, 75) percentile: ({p25}, {p50}, {p75})",
              file=sys.stderr)
        print(f"[M::mem_pestat] low and high boundaries for computing mean "
              f"and std.dev: ({r.low}, {r.high})", file=sys.stderr)
        vals = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(vals) / len(vals)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in q
                              if r.low <= x <= r.high) / len(vals))
        print(f"[M::mem_pestat] mean and std.dev: ({r.avg:.2f}, {r.std:.2f})",
              file=sys.stderr)
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        if r.low < 1:
            r.low = 1
        print(f"[M::mem_pestat] low and high boundaries for proper pairs: "
              f"({r.low}, {r.high})", file=sys.stderr)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
            ori = "FR"[d >> 1 & 1] + "FR"[d & 1]
            print(f"[M::mem_pestat] skip orientation {ori}", file=sys.stderr)
    return pes


def pestat(opt, l_pac: int, regs: list[list[MemAlnReg]]) -> list[PEStat]:
    """mem_pestat (bwamem_pair.c:72-135): the single-device composition of
    the two sharded halves."""
    return pestat_from_candidates(opt, pestat_candidates(opt, l_pac, regs))


def matesw(opt, fm, pes, a: MemAlnReg, l_ms: int, ms: np.ndarray,
           ma: list[MemAlnReg]) -> tuple[int, list[MemAlnReg]]:
    """mem_matesw (bwamem_pair.c:137-206); returns (n, updated ma)."""
    l_pac = fm.l_pac
    skip = [1 if pes[r].failed else 0 for r in range(4)]
    for p in ma:
        r, dist = infer_dir(l_pac, a.rb, p.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return 0, ma
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
        else:
            seq = ms
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        ref = None
        rid = -1
        if rb < re:
            ref, rb, re, rid = fm.fetch_seq(rb, (rb + re) >> 1, re)
        if a.rid == rid and re - rb >= opt.min_seed_len:
            use_byte = l_ms * opt.a < 250
            aln = ksw_align2(seq, ref, opt.mat, opt.o_del, opt.e_del,
                             opt.o_ins, opt.e_ins, use_byte=use_byte,
                             use_start=True, use_subo=True,
                             thres=opt.min_seed_len * opt.a)
            if aln.score >= opt.min_seed_len and aln.qb >= 0:
                b = MemAlnReg()
                b.rid = a.rid
                b.is_alt = a.is_alt
                b.qb = l_ms - (aln.qe + 1) if is_rev else aln.qb
                b.qe = l_ms - aln.qb if is_rev else aln.qe + 1
                b.rb = (l_pac << 1) - (rb + aln.te + 1) if is_rev else rb + aln.tb
                b.re = (l_pac << 1) - (rb + aln.tb) if is_rev else rb + aln.te + 1
                b.score = aln.score
                b.csub = aln.score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insert keeping ma sorted by score (bwamem_pair.c:191-197)
                ma.append(b)
                i = 0
                while i < len(ma) - 1 and ma[i].score >= b.score:
                    i += 1
                tmp = i
                for i in range(len(ma) - 1, tmp, -1):
                    ma[i] = ma[i - 1]
                ma[tmp] = b
            n += 1
        if n:
            ma = sort_dedup_patch(opt, None, None, ma)
    return n, ma


def pair(opt, fm, pes, a: list[list[MemAlnReg]], read_id: int,
         n_pri: list[int]):
    """mem_pair (bwamem_pair.c:208-269).
    Returns (score, sub, n_sub, z[2]) or None if no pair found."""
    l_pac = fm.l_pac
    v: list[tuple[int, int]] = []  # (x, y) like pair64_t
    for r in range(2):
        for i in range(n_pri[r]):
            e = a[r][i]
            x = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            x = (e.rid << 32) | (x - fm.bnt.contigs[e.rid].offset)
            y = (e.score << 32) | (i << 2) | (int(e.rb >= l_pac) << 1) | r
            v.append((x, y))
    ks_introsort(v, lambda p, q: p[0] < q[0] or (p[0] == q[0] and p[1] < q[1]))
    y = [-1, -1, -1, -1]
    u: list[tuple[int, int]] = []
    for i in range(len(v)):
        for r in range(2):
            dr = (r << 1) | (v[i][1] >> 1 & 1)
            if pes[dr].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dr].high:
                    break
                if dist < pes[dr].low:
                    continue
                ns = (dist - pes[dr].avg) / pes[dr].std
                q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                        + 0.721 * math.log(2.0 * math.erfc(abs(ns) * (1.0 / math.sqrt(2.0))))
                        * opt.a + 0.499)
                if q < 0:
                    q = 0
                yv = (k << 32) | i
                xv = (q << 32) | (hash_64((yv ^ (read_id << 8)) & ((1 << 64) - 1)) & 0xFFFFFFFF)
                u.append((xv, yv))
        y[v[i][1] & 3] = i
    if not u:
        return None
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    ks_introsort(u, lambda p, q: p[0] < q[0] or (p[0] == q[0] and p[1] < q[1]))
    i = u[-1][1] >> 32
    k = u[-1][1] & 0xFFFFFFFF
    z = [0, 0]
    z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
    z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
    ret = u[-1][0] >> 32
    sub = u[-2][0] >> 32 if len(u) > 1 else 0
    n_sub = 0
    for j in range(len(u) - 2, -1, -1):
        if sub - (u[j][0] >> 32) <= tmp:
            n_sub += 1
    return ret, sub, n_sub, z


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def sam_pe(opt, fm, pes, pair_id: int, reads, codes, a, rg_id=None) -> int:
    """mem_sam_pe (bwamem_pair.c:276-419)."""
    n = 0
    extra_flag = 1
    if not (opt.flag & MEM_F_NO_RESCUE):
        # mate rescue using each end's near-best hits; b holds COPIES like
        # the reference's kv_push (later dedup mutates a[] in place)
        import copy as _copy

        b = [[], []]
        for i in range(2):
            for reg in a[i]:
                if a[i] and reg.score >= a[i][0].score - opt.pen_unpaired:
                    b[i].append(_copy.copy(reg))
        for i in range(2):
            for j in range(min(len(b[i]), opt.max_matesw)):
                cnt, a[1 - i] = matesw(opt, fm, pes, b[i][j],
                                       len(codes[1 - i]), codes[1 - i], a[1 - i])
                n += cnt
    n_pri = [mark_primary_se(opt, a[0], pair_id << 1 | 0),
             mark_primary_se(opt, a[1], pair_id << 1 | 1)]
    if opt.flag & MEM_F_PRIMARY5:
        reorder_primary5(opt.T, a[0])
        reorder_primary5(opt.T, a[1])
    if not (opt.flag & MEM_F_NOPAIRING):
        pr = (pair(opt, fm, pes, a, pair_id, n_pri)
              if n_pri[0] and n_pri[1] else None)
        if pr is not None and pr[0] > 0:
            o, subo, n_sub, z = pr
            # multiple hits on an end even after rescue? -> no pairing
            is_multi = [False, False]
            for i in range(2):
                for j in range(1, n_pri[i]):
                    if a[i][j].secondary < 0 and a[i][j].score >= opt.T:
                        is_multi[i] = True
                        break
            if not (is_multi[0] or is_multi[1]):
                score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
                subo = max(subo, score_un)
                q_pe = raw_mapq(o - subo, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
                q_pe = max(0, min(60, q_pe))
                q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep
                                                + a[1][0].frac_rep)) + 0.499)
                q_se = [0, 0]
                if o > score_un:  # paired alignment preferred
                    for i in range(2):
                        c = a[i][z[i]]
                        if c.secondary >= 0:
                            c.sub = a[i][c.secondary].score
                            c.secondary = -2
                        q_se[i] = approx_mapq_se(opt, c)
                    for i in range(2):
                        q_se[i] = (q_se[i] if q_se[i] > q_pe
                                   else min(q_pe, q_se[i] + 40))
                    extra_flag |= 2
                    for i in range(2):
                        c = a[i][z[i]]
                        q_se[i] = min(q_se[i], raw_mapq(c.score - c.csub, opt.a))
                else:
                    z = [0, 0]
                    q_se[0] = approx_mapq_se(opt, a[0][0])
                    q_se[1] = approx_mapq_se(opt, a[1][0])
                # promote the chosen hit to primary (bwamem_pair.c:350-359)
                for i in range(2):
                    k = a[i][z[i]].secondary_all
                    if 0 <= k < n_pri[i]:
                        assert a[i][k].secondary_all < 0
                        for j in range(len(a[i])):
                            if a[i][j].secondary_all == k or j == k:
                                a[i][j].secondary_all = z[i]
                        a[i][z[i]].secondary_all = -1
                XA = [None, None]
                if not (opt.flag & MEM_F_ALL):
                    for i in range(2):
                        XA[i] = gen_alt(opt, fm, a[i], len(codes[i]), codes[i])
                # write SAM
                h = [None, None]
                aa = [[], []]
                for i in range(2):
                    h[i] = reg2aln(opt, fm, len(codes[i]), codes[i], a[i][z[i]])
                    h[i].mapq = q_se[i]
                    h[i].flag |= (0x40 << i) | extra_flag
                    h[i].XA = XA[i][z[i]] if XA[i] else None
                    aa[i].append(h[i])
                    if n_pri[i] < len(a[i]):  # ALT hits
                        p = a[i][n_pri[i]]
                        if p.score < opt.T or p.secondary >= 0 or not p.is_alt:
                            continue
                        g = reg2aln(opt, fm, len(codes[i]), codes[i], p)
                        g.flag |= 0x800 | (0x40 << i) | extra_flag
                        g.XA = XA[i][n_pri[i]] if XA[i] else None
                        aa[i].append(g)
                sam0 = "".join(
                    aln2sam(opt, fm.bnt, reads[0], codes[0], len(aa[0]),
                            aa[0], i, h[1], rg_id) for i in range(len(aa[0])))
                sam1 = "".join(
                    aln2sam(opt, fm.bnt, reads[1], codes[1], len(aa[1]),
                            aa[1], i, h[0], rg_id) for i in range(len(aa[1])))
                reads[0].sam = sam0
                reads[1].sam = sam1
                if reads[0].name != reads[1].name:
                    raise RuntimeError("paired reads have different names: "
                                       f"{reads[0].name!r}, {reads[1].name!r}")
                return n

    # no_pairing (bwamem_pair.c:397-418)
    h = [None, None]
    for i in range(2):
        which = -1
        if a[i]:
            if a[i][0].score >= opt.T:
                which = 0
            elif n_pri[i] < len(a[i]) and a[i][n_pri[i]].score >= opt.T:
                which = n_pri[i]
        if which >= 0:
            h[i] = reg2aln(opt, fm, len(codes[i]), codes[i], a[i][which])
        else:
            h[i] = reg2aln(opt, fm, len(codes[i]), codes[i], None)
    if (not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid >= 0
            and a[0] and a[1]):
        d, dist = infer_dir(fm.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    reads[0].sam = reg2sam(opt, fm, reads[0], codes[0], a[0],
                           0x41 | extra_flag, h[1], rg_id)
    reads[1].sam = reg2sam(opt, fm, reads[1], codes[1], a[1],
                           0x81 | extra_flag, h[0], rg_id)
    if reads[0].name != reads[1].name:
        raise RuntimeError("paired reads have different names")
    return n
