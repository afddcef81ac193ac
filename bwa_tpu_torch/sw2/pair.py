"""BWA-SW paired-end rescue (bwtsw2_pair.c)."""

from __future__ import annotations

import sys

import numpy as np

from bwa_tpu_torch.index.pack import NT4_TABLE
from bwa_tpu_torch.mem.ksort import ks_introsort
from bwa_tpu_torch.ops.ksw_host import ksw_align2
from bwa_tpu_torch.sw2.types import (Bsw2Opt, BSW2_FLAG_MATESW, BSW2_FLAG_MOVED,
                               BSW2_FLAG_RESCUED, BSW2_FLAG_TANDEM, Hit,
                               HitSet, pair_scmat)

OUTLIER_BOUND = 2.0
MAX_STDDEV = 4.0
EXT_STDDEV = 4.0


class PeStat:
    __slots__ = ("low", "high", "failed", "avg", "std")

    def __init__(self):
        self.low = self.high = self.failed = 0
        self.avg = self.std = 0.0


def bsw2_stat(n: int, buf: list[HitSet], msg: list[str],
              max_ins: int) -> PeStat:
    """Insert-size inference (bsw2_stat, bwtsw2_pair.c:26-95)."""
    r = PeStat()
    isize = [0] * max(n, 1)
    k = 0
    max_len = 0
    for i in range(0, n, 2):
        if buf[i] is None or buf[i].n != 1 or buf[i + 1].n != 1:
            continue
        t0, t1 = buf[i].hits[0], buf[i + 1].hits[0]
        if t0.G2 > 0.8 * t0.G:
            continue  # best hit not good enough
        if t1.G2 > 0.8 * t1.G:
            continue
        l = (t0.k - t1.k + t1.len if t0.k > t1.k else t1.k - t0.k + t0.len)
        if l >= max_ins:
            continue
        max_len = max(max_len, t0.end - t0.beg, t1.end - t1.beg)
        isize[k] = l
        k += 1
    head = isize[:k]
    ks_introsort(head, lambda a, b: a < b)
    isize[:k] = head
    p25 = isize[int(.25 * k + .499)]
    p50 = isize[int(.50 * k + .499)]
    p75 = isize[int(.75 * k + .499)]
    msg.append("[bsw2_stat] infer the insert size distribution from "
               f"{k} high-quality pairs.\n")
    if k < 8:
        msg.append("[bsw2_stat] fail to infer the insert size distribution: "
                   "too few good pairs.\n")
        r.failed = 1
        return r
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.low < 1:
        r.low = 1
    r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
    if r.low > r.high:
        msg.append("[bsw2_stat] fail to infer the insert size distribution: "
                   "upper bound is smaller than max read length.\n")
        r.failed = 1
        return r
    msg.append(f"[bsw2_stat] (25, 50, 75) percentile: ({p25}, {p50}, {p75})\n")
    msg.append("[bsw2_stat] low and high boundaries for computing mean and "
               f"std.dev: ({r.low}, {r.high})\n")
    x = 0
    r.avg = 0.0
    for i in range(k):
        if r.low <= isize[i] <= r.high:
            r.avg += isize[i]
            x += 1
    if x == 0:
        msg.append("[bsw2_stat] fail to infer the insert size distribution: "
                   "no pairs within boundaries.\n")
        r.failed = 1
        return r
    r.avg /= x
    r.std = 0.0
    for i in range(k):
        if r.low <= isize[i] <= r.high:
            r.std += (isize[i] - r.avg) * (isize[i] - r.avg)
    r.std = (r.std / x) ** 0.5
    msg.append(f"[bsw2_stat] mean and std.dev: ({r.avg:.2f}, {r.std:.2f})\n")
    tmp = int(p25 - 3. * (p75 - p25) + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.low < 1:
        r.low = 1
    r.high = int(p75 + 3. * (p75 - p25) + .499)
    if r.low > r.avg - MAX_STDDEV * r.std:
        r.low = int(r.avg - MAX_STDDEV * r.std + .499)
    r.low = tmp if tmp > max_len else max_len  # sic (bwtsw2_pair.c:90)
    if r.high < r.avg + MAX_STDDEV * r.std:
        r.high = int(r.avg + MAX_STDDEV * r.std + .499)
    msg.append("[bsw2_stat] low and high boundaries for proper pairs: "
               f"({r.low}, {r.high})\n")
    return r


def bsw2_pair1(opt: Bsw2Opt, fm, st: PeStat, h: Hit, mseq: bytes,
               a: Hit, g_mat: np.ndarray) -> None:
    """Mate window Smith-Waterman (bsw2_pair1, bwtsw2_pair.c:105-162)."""
    l_pac = fm.l_pac
    l_mseq = len(mseq)
    a.n_seeds = 1
    a.flag |= BSW2_FLAG_MATESW
    if h.is_rev == 0:
        beg = int(h.k + st.avg - EXT_STDDEV * st.std - l_mseq + .499)
        if beg < h.k:
            beg = h.k
        end = int(h.k + st.avg + EXT_STDDEV * st.std + .499)
        a.is_rev = 1
        a.flag |= 16
    else:
        beg = int(h.k + h.end - h.beg - st.avg - EXT_STDDEV * st.std + .499)
        end = int(h.k + h.end - h.beg - st.avg + EXT_STDDEV * st.std
                  + l_mseq + .499)
        if end > h.k + (h.end - h.beg):
            end = h.k + (h.end - h.beg)
        a.is_rev = 0
    if beg < 1:
        beg = 1
    if end > l_pac:
        end = l_pac
    if end - beg < l_mseq:
        return
    ref = fm.pac_codes[beg:end]
    codes = NT4_TABLE[np.frombuffer(mseq, dtype=np.uint8)]
    if h.is_rev == 0:  # align the mate on the reverse strand
        seq = np.where(codes > 3, 4, 3 - codes).astype(np.uint8)[::-1].copy()
    else:
        seq = codes.copy()
    use_byte = l_mseq * int(g_mat[0, 0]) < 250
    aln = ksw_align2(seq, ref, g_mat, opt.q, opt.r, opt.q, opt.r,
                     use_byte=use_byte, use_start=True, use_subo=True,
                     thres=opt.t)
    a.G = aln.score
    a.G2 = aln.score2
    if a.G < opt.t:
        a.G = 0
    if a.G2 < opt.t:
        a.G2 = 0
    if a.G2:
        a.flag |= BSW2_FLAG_TANDEM
    a.k = beg + aln.tb
    a.len = aln.te - aln.tb + 1
    a.beg = aln.qb
    a.end = aln.qe + 1
    if a.is_rev:
        i = a.beg
        a.beg = l_mseq - a.end
        a.end = l_mseq - i


def bsw2_pair(opt: Bsw2Opt, fm, reads, hits: list[HitSet]) -> None:
    """bsw2_pair (bwtsw2_pair.c:164-274)."""
    n = len(reads)
    msg: list[str] = []
    pes = bsw2_stat(n, hits, msg, opt.max_ins)
    g_mat = pair_scmat(opt.a, opt.b)
    n_rescued = n_moved = n_fixed = 0
    for i in range(0, n, 2):
        a = [Hit(), Hit()]
        a[0].flag = 1 << 6
        a[1].flag = 1 << 7
        for j in range(2):  # set the read1/2 flag on existing hits
            if hits[i + j] is None:
                continue
            for p in hits[i + j].hits:
                p.flag |= 1 << (6 + j)
        if pes.failed:
            continue
        if hits[i] is None or hits[i + 1] is None:
            continue  # one end has excessive N
        if hits[i].n != 1 and hits[i + 1].n != 1:
            continue
        if hits[i].n > 1 or hits[i + 1].n > 1:
            continue
        if not opt.skip_sw:
            if hits[i].n == 1:
                bsw2_pair1(opt, fm, pes, hits[i].hits[0],
                           reads[i + 1].seq, a[1], g_mat)
            if hits[i + 1].n == 1:
                bsw2_pair1(opt, fm, pes, hits[i + 1].hits[0],
                           reads[i].seq, a[0], g_mat)
        if hits[i].n + hits[i + 1].n == 1:  # rescue the unmapped end
            if hits[i].n == 1:
                p0, p1, which = hits[i], hits[i + 1], 1
            else:
                p0, p1, which = hits[i + 1], hits[i], 0
            if a[which].G == 0:
                continue
            a[which].flag |= BSW2_FLAG_RESCUED
            p1.hits = [a[which]]
            p0.hits[0].flag |= 2
            p1.hits[0].flag |= 2
            n_rescued += 1
        else:  # both ends mapped
            is_fixed = False
            for j in range(2):  # fix suboptimal mappings/scores
                p = hits[i + j].hits[0]
                if p.G < a[j].G:
                    a[j].G2 = a[j].G2 if a[j].G2 > p.G else p.G
                    hits[i + j].hits[0] = a[j]
                    n_fixed += 1
                    is_fixed = True
                elif p.k != a[j].k and p.G2 < a[j].G:
                    p.G2 = a[j].G
                elif p.k == a[j].k and p.G2 < a[j].G2:
                    p.G2 = a[j].G2
            h0, h1 = hits[i].hits[0], hits[i + 1].hits[0]
            if h0.k == a[0].k and h1.k == a[1].k:  # properly paired
                for j in range(2):
                    hits[i + j].hits[0].flag |= 2 | (a[j].flag
                                                     & BSW2_FLAG_TANDEM)
            elif h0.k == a[0].k or h1.k == a[1].k:  # a tandem match
                for j in range(2):
                    hits[i + j].hits[0].flag |= 2
                    if hits[i + j].hits[0].k != a[j].k:
                        hits[i + j].hits[0].flag |= BSW2_FLAG_TANDEM
            elif not is_fixed and (a[0].G or a[1].G):  # maybe move one end
                if a[0].G and a[1].G:  # two "proper pairs": drop the worse
                    G = [h0.G + a[1].G, h1.G + a[0].G]
                    diff = (abs(float(G[0] - G[1])) / (opt.a + opt.b)
                            / ((h0.len + a[1].len + h1.len + a[0].len) / 2.))
                    if diff > 0.05:
                        a[0 if G[0] > G[1] else 1].G = 0
                if a[0].G == 0 or a[1].G == 0:  # one proper pair only
                    if a[0].G:
                        p0h, p1h, which = hits[i + 1].hits, hits[i].hits, 0
                    else:
                        p0h, p1h, which = hits[i].hits, hits[i + 1].hits, 1
                    p0, p1 = p0h[0], p1h[0]
                    if p0.is_rev:
                        isz = p0.k + p0.len - a[which].k
                    else:
                        isz = a[which].k + a[which].len - p0.k
                    dev = abs(isz - pes.avg) / pes.std
                    diff = (float(p1.G - a[which].G) / (opt.a + opt.b)
                            / (p1.end - p1.beg) * 100.0)
                    if diff < dev * 2.:  # move (heuristic)
                        a[which].G2 = a[which].G
                        p1h[0] = a[which]
                        p1h[0].flag |= BSW2_FLAG_MOVED | 2
                        p0.flag |= 2
                        n_moved += 1
            elif is_fixed:
                hits[i].hits[0].flag |= 2
                hits[i + 1].hits[0].flag |= 2
    msg.append(f"[bsw2_pair] #fixed={n_fixed}, #rescued={n_rescued}, "
               f"#moved={n_moved}\n")
    sys.stderr.write("".join(msg))
