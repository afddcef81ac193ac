"""Seed chaining and chain filtering (bwamem.c:194-411, 586-641)."""

from __future__ import annotations

from bisect import bisect_right, insort

from bwa_tpu_torch.mem.ksort import ks_introsort
from bwa_tpu_torch.mem.types import MemChain, MemSeed
from bwa_tpu_torch.ops.ksw_host import ksw_align2

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


def chain_weight(c: MemChain) -> int:
    """mem_chain_weight (bwamem.c:239-258): min of query/ref seed coverage."""
    w = 0
    for which in (0, 1):
        tot, end = 0, 0
        for s in c.seeds:
            beg = s.qbeg if which == 0 else s.rbeg
            if beg >= end:
                tot += s.len
            elif beg + s.len > end:
                tot += beg + s.len - end
            end = max(end, beg + s.len)
        w = tot if which == 0 else min(w, tot)
    return min(w, (1 << 30) - 1)


def _test_and_merge(opt, l_pac, c: MemChain, p: MemSeed, seed_rid: int) -> bool:
    """(bwamem.c:216-237)"""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (p.qbeg >= c.seeds[0].qbeg and p.qbeg + p.len <= qend
            and p.rbeg >= c.seeds[0].rbeg and p.rbeg + p.len <= rend):
        return True  # contained
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac:
        return False  # different strand
    x = p.qbeg - last.qbeg
    y = p.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last.len < opt.max_chain_gap
            and y - last.len < opt.max_chain_gap):
        c.seeds.append(p)
        return True
    return False


def chain(opt, engine, bnt, q, mems) -> list[MemChain]:
    """mem_chain (bwamem.c:277-341): B-tree chaining of seed occurrences.

    engine must provide .sa(k); mems from seeding.collect_intv.
    Returns chains in pos order (B-tree traversal order).
    """
    l_pac = bnt.l_pac
    if len(q) < opt.min_seed_len:
        return []

    # frac_rep: fraction of the read covered by over-repetitive SMEMs
    b = e = l_rep = 0
    for iv in mems:
        sb, se = iv[3] >> 32, iv[3] & 0xFFFFFFFF
        if iv[2] <= opt.max_occ:
            continue
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b

    # sorted chain list emulating the kbtree keyed by pos
    keys: list[int] = []
    chains: list[MemChain] = []

    for iv in mems:
        slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
        step = iv[2] // opt.max_occ if iv[2] > opt.max_occ else 1
        k = 0
        count = 0
        while k < iv[2] and count < opt.max_occ:
            rbeg = engine.sa(iv[0] + k)
            s = MemSeed(rbeg=rbeg, qbeg=iv[3] >> 32, len=slen, score=slen)
            rid = bnt.intv2rid(rbeg, rbeg + slen)
            to_add = False
            if rid < 0:
                k += step
                count += 1
                continue
            if chains:
                # kb_intervalp: lower = rightmost chain with pos <= rbeg
                i = bisect_right(keys, rbeg) - 1
                if i < 0 or not _test_and_merge(opt, l_pac, chains[i], s, rid):
                    to_add = True
            else:
                to_add = True
            if to_add:
                c = MemChain(rid=rid, pos=rbeg, seeds=[s],
                             is_alt=int(bool(bnt.contigs[rid].is_alt)))
                i = bisect_right(keys, rbeg)
                keys.insert(i, rbeg)
                chains.insert(i, c)
            k += step
            count += 1

    for c in chains:
        c.frac_rep = l_rep / len(q)
    return chains


def chain_flt(opt, chains: list[MemChain]) -> list[MemChain]:
    """mem_chain_flt (bwamem.c:353-411)."""
    if not chains:
        return []
    a = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            a.append(c)
    if not a:
        return []
    ks_introsort(a, lambda x, y: x.w > y.w)
    a[0].kept = 3
    kept_idx = [0]
    for i in range(1, len(a)):
        large_ovlp = False
        hit = False
        for j in kept_idx:
            cb_j, ce_j = a[j].seeds[0].qbeg, a[j].seeds[-1].qbeg + a[j].seeds[-1].len
            cb_i, ce_i = a[i].seeds[0].qbeg, a[i].seeds[-1].qbeg + a[i].seeds[-1].len
            b_max = max(cb_j, cb_i)
            e_min = min(ce_j, ce_i)
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = ce_i - cb_i
                lj = ce_j - cb_j
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (a[i].w < a[j].w * opt.drop_ratio
                            and a[j].w - a[i].w >= opt.min_seed_len * 2):
                        hit = True
                        break
        if not hit:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap the number of .kept=1/2 chains to extend (bwamem.c:399-404)
    k = 0
    i = 0
    n = len(a)
    while i < n:
        if a[i].kept == 0 or a[i].kept == 3:
            i += 1
            continue
        k += 1
        if k >= opt.max_chain_extend:
            break
        i += 1
    for j in range(i, n):
        if a[j].kept < 3:
            a[j].kept = 0
    return [c for c in a if c.kept != 0]


def seed_sw(opt, fm, q, s: MemSeed) -> int:
    """mem_seed_sw (bwamem.c:597-622)."""
    l_pac = fm.l_pac
    if s.len >= MEM_SHORT_LEN:
        return -1
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, len(q))
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rseq, rb, re, _ = fm.fetch_seq(rb, mid, re)
    r = ksw_align2(q[qb:qe], rseq, opt.mat, opt.o_del, opt.e_del,
                   opt.o_ins, opt.e_ins, use_start=True)
    return r.score


def flt_chained_seeds(opt, fm, q, chains: list[MemChain]) -> None:
    """mem_flt_chained_seeds (bwamem.c:624-641); long-read only."""
    import math

    min_l = (MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight
             else MEM_MINSC_COEF * math.log(len(q)))
    if min_l > MEM_SEEDSW_COEF * len(q):
        return
    min_hsp = int(opt.a * min_l + 0.499)
    for c in chains:
        kept = []
        for s in c.seeds:
            s.score = seed_sw(opt, fm, q, s)
            if s.score < 0 or s.score >= min_hsp:
                s.score = s.len * opt.a if s.score < 0 else s.score
                kept.append(s)
        c.seeds = kept
