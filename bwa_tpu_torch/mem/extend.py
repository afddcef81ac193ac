"""Seed extension: mem_chain2aln (bwamem.c:647-812)."""

from __future__ import annotations

from bwa_tpu_torch.mem.ksort import ks_introsort
from bwa_tpu_torch.mem.types import MemAlnReg, MemChain
from bwa_tpu_torch.ops.ksw_host import ksw_extend2

MAX_BAND_TRY = 2


def cal_max_gap(opt, qlen: int) -> int:
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w * 2)


def chain2aln(opt, fm, q, c: MemChain, regs: list[MemAlnReg]) -> None:
    """Extend every seed of chain c left+right, appending hits to regs."""
    l_pac = fm.l_pac
    l_query = len(q)
    if c.n == 0:
        return
    # reference window spanned by any possible extension (bwamem.c:667-683)
    rmax0, rmax1 = l_pac << 1, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = (t.rbeg + t.len
             + (l_query - t.qbeg - t.len)
             + cal_max_gap(opt, l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rseq, rmax0, rmax1, rid = fm.fetch_seq(rmax0, c.seeds[0].rbeg, rmax1)
    assert c.rid == rid

    srt = [(s.score << 32) | i for i, s in enumerate(c.seeds)]
    ks_introsort(srt, lambda a, b: a < b)

    for k in range(c.n - 1, -1, -1):
        s = c.seeds[srt[k] & 0xFFFFFFFF]

        # skip seeds (almost) contained in an existing hit (bwamem.c:697-732)
        hit_i = -1
        for i, p in enumerate(regs):
            if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                    or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd, rd = s.qbeg - p.qb, s.rbeg - p.rb
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                hit_i = i
                break
            qd = p.qe - (s.qbeg + s.len)
            rd = p.re - (s.rbeg + s.len)
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                hit_i = i
                break
        if hit_i >= 0:
            # only extend if an overlapping same-chain seed may disagree
            i = k + 1
            while i < c.n:
                if srt[i] == 0:
                    i += 1
                    continue
                t = c.seeds[srt[i] & 0xFFFFFFFF]
                if t.len < s.len * 0.95:
                    i += 1
                    continue
                if (s.qbeg <= t.qbeg and s.qbeg + s.len - t.qbeg >= s.len >> 2
                        and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                    break
                if (t.qbeg <= s.qbeg and t.qbeg + t.len - s.qbeg >= s.len >> 2
                        and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                    break
                i += 1
            if i == c.n:
                srt[k] = 0  # mark extension not performed
                continue

        a = MemAlnReg()
        a.w = aw0 = aw1 = opt.w
        a.score = a.truesc = -1
        a.rid = c.rid
        regs.append(a)

        if s.qbeg:  # left extension (bwamem.c:741-770)
            qs = q[:s.qbeg][::-1]
            tmp = s.rbeg - rmax0
            rs = rseq[:tmp][::-1]
            qle = tle = gtle = gscore = 0
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw0 = opt.w << i
                (a.score, qle, tle, gtle, gscore, max_off0) = ksw_extend2(
                    qs, rs, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                    opt.e_ins, aw0, opt.pen_clip5, opt.zdrop, s.len * opt.a)
                if a.score == prev or max_off0 < (aw0 >> 1) + (aw0 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip5:
                a.qb = s.qbeg - qle
                a.rb = s.rbeg - tle
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s.rbeg - gtle
                a.truesc = gscore
        else:
            a.score = a.truesc = s.len * opt.a
            a.qb = 0
            a.rb = s.rbeg

        if s.qbeg + s.len != l_query:  # right extension (bwamem.c:772-797)
            sc0 = a.score
            qe = s.qbeg + s.len
            re = s.rbeg + s.len - rmax0
            assert re >= 0
            qle = tle = gtle = gscore = 0
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw1 = opt.w << i
                (a.score, qle, tle, gtle, gscore, max_off1) = ksw_extend2(
                    q[qe:], rseq[re:], opt.mat, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, aw1, opt.pen_clip3, opt.zdrop, sc0)
                if a.score == prev or max_off1 < (aw1 >> 1) + (aw1 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip3:
                a.qe = qe + qle
                a.re = rmax0 + re + tle
                a.truesc += a.score - sc0
            else:
                a.qe = l_query
                a.re = rmax0 + re + gtle
                a.truesc += gscore - sc0
        else:
            a.qe = l_query
            a.re = s.rbeg + s.len

        a.seedcov = 0
        for t in c.seeds:
            if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                a.seedcov += t.len
        a.w = max(aw0, aw1)
        a.seedlen0 = s.len
        a.frac_rep = c.frac_rep
