"""Primary marking, mapQ and dedup/patch (bwamem.c:417-584, 982-1030)."""

from __future__ import annotations

import math

from bwa_tpu_torch.mem.ksort import ks_introsort
from bwa_tpu_torch.mem.types import MemAlnReg
from bwa_tpu_torch.utils.hash64 import hash_64

INT_MAX = 2**31 - 1
PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90
MEM_MAPQ_COEF = 30.0


def patch_reg(opt, fm, query_codes, a: MemAlnReg, b: MemAlnReg):
    """mem_patch_reg (bwamem.c:432-461): can hits a<b merge into one?
    Returns (score, w) or None."""
    from bwa_tpu_torch.mem.cigar import gen_cigar2_full

    if fm is None or query_codes is None:
        return None
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < fm.l_pac and b.rb >= fm.l_pac:
        return None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return None
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:  # no overlap on query or ref
        if w > opt.w * 2 or r >= PATCH_MAX_R_BW:
            return None
    elif w > opt.w * 4 or r >= PATCH_MAX_R_BW * 2:
        return None
    w += a.w + b.w
    w = min(w, opt.w * 4)
    res = gen_cigar2_full(opt, fm, b.qe - a.qb, query_codes[a.qb:b.qe],
                          a.rb, b.re, w, want_cigar=False)
    if res is None:
        return None
    score = res[0]
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return None
    return score, w


def sort_dedup_patch(opt, fm, query_codes, regs: list[MemAlnReg]) -> list[MemAlnReg]:
    """mem_sort_dedup_patch (bwamem.c:463-515)."""
    n = len(regs)
    if n <= 1:
        return regs
    a = regs
    ks_introsort(a, lambda x, y: x.re < y.re)  # sort by END position
    for p in a:
        p.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        for j in range(i - 1, -1, -1):
            q = a[j]
            if p.rid != q.rid or p.rb >= q.re + opt.max_chain_gap:
                break
            if q.qe == q.qb:
                continue  # excluded
            o_r = q.re - p.rb
            o_q = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            m_r = min(q.re - q.rb, p.re - p.rb)
            m_q = min(q.qe - q.qb, p.qe - p.qb)
            if o_r > opt.mask_level_redun * m_r and o_q > opt.mask_level_redun * m_q:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb:
                res = patch_reg(opt, fm, query_codes, q, p)
                if res is not None:
                    score, w = res
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
    a = [p for p in a if p.qe > p.qb]
    ks_introsort(a, lambda x, y: (
        x.score > y.score
        or (x.score == y.score
            and (x.rb < y.rb or (x.rb == y.rb and x.qb < y.qb)))))
    for i in range(1, len(a)):
        if (a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb
                and a[i].qb == a[i - 1].qb):
            a[i].qe = a[i].qb
    out = [a[0]] if a else []
    out += [p for p in a[1:] if p.qe > p.qb]
    return out


def _mark_primary_core(opt, a: list[MemAlnReg], n: int) -> None:
    """mem_mark_primary_se_core over a[:n] (bwamem.c:519-545)."""
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n):
        found = -1
        for k in z:
            b_max = max(a[k].qb, a[i].qb)
            e_min = min(a[k].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[k].qe - a[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if a[k].sub == 0:
                        a[k].sub = a[i].score
                    if a[k].score - a[i].score <= tmp and (a[k].is_alt or not a[i].is_alt):
                        a[k].sub_n += 1
                    found = k
                    break
        if found < 0:
            z.append(i)
        else:
            a[i].secondary = found


def mark_primary_se(opt, regs: list[MemAlnReg], read_id: int) -> int:
    """mem_mark_primary_se (bwamem.c:547-584); returns n_pri.  NOTE: sorts
    regs in place (mem_ars_hash order)."""
    n = len(regs)
    if n == 0:
        return 0
    n_pri = 0
    for i, p in enumerate(regs):
        p.sub = p.alt_sc = 0
        p.secondary = p.secondary_all = -1
        p.hash = hash_64(read_id + i)
        if not p.is_alt:
            n_pri += 1
    ks_introsort(regs, lambda x, y: (
        x.score > y.score
        or (x.score == y.score
            and (x.is_alt < y.is_alt
                 or (x.is_alt == y.is_alt and x.hash < y.hash)))))
    _mark_primary_core(opt, regs, n)
    for i, p in enumerate(regs):
        p.secondary_all = i  # rank in the first round
        if not p.is_alt and p.secondary >= 0 and regs[p.secondary].is_alt:
            p.alt_sc = regs[p.secondary].score
    if 0 <= n_pri < n:
        z = [0] * n
        if n_pri > 0:
            ks_introsort(regs, lambda x, y: (
                x.is_alt < y.is_alt
                or (x.is_alt == y.is_alt
                    and (x.score > y.score
                         or (x.score == y.score and x.hash < y.hash)))))
        for i, p in enumerate(regs):
            z[p.secondary_all] = i
        for p in regs:
            if p.secondary >= 0:
                p.secondary_all = z[p.secondary]
                if p.is_alt:
                    p.secondary = INT_MAX
            else:
                p.secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                regs[i].sub = 0
                regs[i].secondary = -1
            _mark_primary_core(opt, regs, n_pri)
    else:
        for p in regs:
            p.secondary_all = p.secondary
    return n_pri


def approx_mapq_se(opt, a: MemAlnReg) -> int:
    """mem_approx_mapq_se (bwamem.c:982-1006)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(MEM_MAPQ_COEF * (1.0 - sub / a.score) * math.log(a.seedcov) + 0.499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1.0 - a.frac_rep) + 0.499)


def reorder_primary5(T: int, regs: list[MemAlnReg]) -> None:
    """mem_reorder_primary5 (bwamem.c:1008-1030)."""
    n_pri = sum(1 for p in regs
                if p.secondary < 0 and not p.is_alt and p.score >= T)
    if n_pri <= 1:
        return
    left_st, left_k = INT_MAX, -1
    for k, p in enumerate(regs):
        if p.secondary >= 0 or p.is_alt or p.score < T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    assert regs[0].secondary < 0
    if left_k == 0:
        return
    regs[0], regs[left_k] = regs[left_k], regs[0]
    for k in range(1, len(regs)):
        p = regs[k]
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0
    return
