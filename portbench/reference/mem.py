"""Plain NumPy reference for `bwa mem` on a repeat-free genome.

Each read of the benchmark's traffic is cut from a known place of a
uniform random genome, so its best locus is that place: the reference
aligns the read there as lh3/bwa 0.7.19 does (mem_chain2aln,
bwamem.c:647-812; ksw_extend2, ksw.c:416-515): the longest exact-match
segment of at least min_seed_len bases is the seed (on a tie the last);
the seed is extended to the left and to the right by the banded
extension DP with its tie rules, z-drop and band retry; each end is
clipped at the extension's best cell unless reaching the read's end
scores more than that best less the clip penalty.  AS is the
extension's best score (ar->score); the CIGAR and NM come from the
banded global alignment of the aligned region (bwa_gen_cigar2, with
mem_reg2aln's band choice and retries).  A paired read also gets the mate fields and the proper
flag from the insert-size bounds that mem_pestat derives from the
library's quartiles.

Nothing here imports the program under test.  `bits` = 8 computes every
score as the 8-bit saturating lanes of ksw's first SIMD pass would
(the control of PERF.md's correctness section).
"""

from __future__ import annotations

import numpy as np

# SAM flag bits the comparison reads
PAIRED, PROPER, UNMAP, REV, MREV, READ1, READ2 = (
    0x1, 0x2, 0x4, 0x10, 0x20, 0x40, 0x80)


class Scoring:
    """bwa mem's scoring and extension options as a mix file states them."""

    def __init__(self, d: dict):
        self.a, self.b = int(d["match"]), int(d["mismatch"])
        self.o_del, self.e_del = int(d["gap_open"]), int(d["gap_extend"])
        self.o_ins, self.e_ins = self.o_del, self.e_del
        self.pen_clip5 = self.pen_clip3 = int(d["clip_penalty"])
        self.w, self.zdrop = int(d["band_width"]), int(d["zdrop"])
        self.min_seed_len = int(d["min_seed_len"])
        self.mat = np.full((5, 5), -1, np.int32)
        self.mat[:4, :4] = -self.b
        np.fill_diagonal(self.mat[:4, :4], self.a)


class Genome:
    """The forward strand's codes; windows of the doubled text (forward
    then reverse complement, bwa's coordinates) are cut on demand."""

    def __init__(self, codes: np.ndarray):
        self.codes = codes
        self.l_pac = len(codes)

    def fetch(self, beg: int, end: int) -> np.ndarray:
        """Doubled-text codes [beg, end), on one strand."""
        n = self.l_pac
        if end <= n:
            return self.codes[beg:end]
        assert beg >= n
        # position p >= n of the doubled text is 3 - codes[2n - 1 - p]
        return 3 - self.codes[2 * n - end:2 * n - beg][::-1]


def _sat(x, bits):
    """x held in a signed integer of `bits` bits (saturating), or as is."""
    if bits is None:
        return x
    hi = (1 << (bits - 1)) - 1
    return np.minimum(x, hi) if isinstance(x, np.ndarray) else min(x, hi)


def extend(sc: Scoring, query: np.ndarray, target: np.ndarray, w: int,
           end_bonus: int, h0: int, bits=None):
    """ksw_extend2 (ksw.c:416-515), a row (one target base) at a time over
    the band's columns.  Returns (max, qle, tle, gtle, gscore, max_off)."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = sc.o_del + sc.e_del, sc.o_ins + sc.e_ins
    e_del, e_ins = sc.e_del, sc.e_ins
    prof = sc.mat[:, np.minimum(query, 4)]  # [target base, query column]
    eh_h = np.zeros(qlen + 1, np.int64)
    eh_e = np.zeros(qlen + 1, np.int64)
    eh_h[0] = h0
    eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > e_ins:
        eh_h[j] = eh_h[j - 1] - e_ins
        j += 1
    mx = int(sc.mat.max())
    max_ins = max(int((qlen * mx + end_bonus - sc.o_ins) / e_ins + 1.0), 1)
    w = min(w, max_ins)
    max_del = max(int((qlen * mx + end_bonus - sc.o_del) / e_del + 1.0), 1)
    w = min(w, max_del)
    best, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    beg, end = 0, qlen
    for i in range(tlen):
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        if beg == 0:
            h1 = max(h0 - (sc.o_del + e_del * (i + 1)), 0)
        else:
            h1 = 0
        n = end - beg
        if n <= 0:
            m, mj = 0, -1
            eh_h[end] = h1
            eh_e[end] = 0
        else:
            M = eh_h[beg:end].copy()
            e = eh_e[beg:end]
            M = np.where(M != 0, M + prof[min(int(target[i]), 4), beg:end], 0)
            M = _sat(M, bits)
            # F(i, j): gaps open from M only; f starts at 0 at beg
            t = np.maximum(M - oe_ins, 0) + e_ins * np.arange(n)
            f = np.zeros(n, np.int64)
            if n > 1:
                f[1:] = (np.maximum.accumulate(t)[:-1]
                         - e_ins * np.arange(n - 1))
            h = np.maximum(np.maximum(M, e), f)
            new_e = np.maximum(e - e_del, np.maximum(M - oe_del, 0))
            eh_h[beg] = h1
            eh_h[beg + 1:end + 1] = h
            eh_e[beg:end] = new_e
            eh_e[end] = 0
            h1 = int(h[-1])
            m = int(h.max())
            mj = beg + int(np.flatnonzero(h == m)[-1]) if m > 0 else end - 1
        if (end if n > 0 else beg) == qlen:
            max_ie = max_ie if gscore > h1 else i
            gscore = max(gscore, h1)
        if m == 0:
            break
        if m > best:
            best, max_i, max_j = m, i, mj
            max_off = max(max_off, abs(mj - i))
        elif sc.zdrop > 0:
            if i - max_i > mj - max_j:
                if best - m - ((i - max_i) - (mj - max_j)) * e_del > sc.zdrop:
                    break
            elif best - m - ((mj - max_j) - (i - max_i)) * e_ins > sc.zdrop:
                break
        live = (eh_h[beg:end] != 0) | (eh_e[beg:end] != 0)
        nz = np.flatnonzero(live)
        beg = beg + int(nz[0]) if nz.size else end
        tail = (eh_h[beg:end + 1] != 0) | (eh_e[beg:end + 1] != 0)
        nz = np.flatnonzero(tail)
        j = beg + int(nz[-1]) if nz.size else beg - 1
        end = min(j + 2, qlen)
    return best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def cal_max_gap(sc: Scoring, qlen: int) -> int:
    l_del = int((qlen * sc.a - sc.o_del) / sc.e_del + 1.0)
    l_ins = int((qlen * sc.a - sc.o_ins) / sc.e_ins + 1.0)
    return min(max(l_del, l_ins, 1), sc.w * 2)


def seeds_of(q: np.ndarray, ref: np.ndarray, min_len: int):
    """The exact-match segments of at least min_len bases of the read
    against its locus, in read order: [(qbeg, len)]."""
    eq = np.concatenate([[False], q == ref, [False]])
    d = np.diff(eq.astype(np.int8))
    starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
    return [(int(b), int(e - b)) for b, e in zip(starts, ends)
            if e - b >= min_len]


def seed_of(q: np.ndarray, ref: np.ndarray, min_len: int):
    """The longest segment (the last on a tie), or None."""
    segs = seeds_of(q, ref, min_len)
    if not segs:
        return None
    top = max(n for _, n in segs)
    return [s for s in segs if s[1] == top][-1]


def align_at(sc: Scoring, g: Genome, q: np.ndarray, origin: int, bits=None):
    """One read aligned at its doubled-text origin as mem_chain2aln does:
    dict(qb, qe, rb, re, score, truesc), or None with no seed."""
    L = len(q)
    n2 = 2 * g.l_pac
    s = seed_of(q, g.fetch(origin, origin + L), sc.min_seed_len)
    if s is None:
        return None
    qbeg, slen = s
    rbeg = origin + qbeg
    # the window any seed of the chain may extend into (bwamem.c:667-683)
    rmax0, rmax1 = n2, 0
    for sb, sl in seeds_of(q, g.fetch(origin, origin + L), sc.min_seed_len):
        rest = L - sb - sl
        rmax0 = min(rmax0, origin - cal_max_gap(sc, sb))
        rmax1 = max(rmax1, origin + L + cal_max_gap(sc, rest))
    rmax0, rmax1 = max(rmax0, 0), min(rmax1, n2)
    if rmax0 < g.l_pac < rmax1:
        if rbeg < g.l_pac:
            rmax1 = g.l_pac
        else:
            rmax0 = g.l_pac
    a = dict(score=-1, truesc=-1)
    aw0 = aw1 = sc.w
    if qbeg:
        qs = q[:qbeg][::-1]
        rs = g.fetch(rmax0, rbeg)[::-1]
        for i in range(2):
            prev = a["score"]
            aw0 = sc.w << i
            score, qle, tle, gtle, gscore, off = extend(
                sc, qs, rs, aw0, sc.pen_clip5, slen * sc.a, bits)
            a["score"] = score
            if score == prev or off < (aw0 >> 1) + (aw0 >> 2):
                break
        if gscore <= 0 or gscore <= a["score"] - sc.pen_clip5:
            a["qb"], a["rb"], a["truesc"] = qbeg - qle, rbeg - tle, a["score"]
        else:
            a["qb"], a["rb"], a["truesc"] = 0, rbeg - gtle, gscore
    else:
        a["score"] = a["truesc"] = _sat(slen * sc.a, bits)
        a["qb"], a["rb"] = 0, rbeg
    if qbeg + slen != L:
        sc0 = a["score"]
        qe, re = qbeg + slen, rbeg + slen
        ts = g.fetch(re, rmax1)
        for i in range(2):
            prev = a["score"]
            aw1 = sc.w << i
            score, qle, tle, gtle, gscore, off = extend(
                sc, q[qe:], ts, aw1, sc.pen_clip3, sc0, bits)
            a["score"] = score
            if score == prev or off < (aw1 >> 1) + (aw1 >> 2):
                break
        if gscore <= 0 or gscore <= a["score"] - sc.pen_clip3:
            a["qe"], a["re"] = qe + qle, re + tle
            a["truesc"] += a["score"] - sc0
        else:
            a["qe"], a["re"] = L, re + gtle
            a["truesc"] += gscore - sc0
    else:
        a["qe"], a["re"] = L, rbeg + slen
    a["w"] = max(aw0, aw1)
    return a


MINUS_INF = -0x40000000


def global2(sc: Scoring, query: np.ndarray, target: np.ndarray, w: int):
    """ksw_global2 (ksw.c:540-642): the banded global alignment's score and
    CIGAR [(op, len)] (0 M, 1 I, 2 D), with its traceback's tie rules."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = sc.o_del + sc.e_del, sc.o_ins + sc.e_ins
    e_del, e_ins = sc.e_del, sc.e_ins
    prof = sc.mat[:, np.minimum(query, 4)].astype(np.int64)
    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((tlen, max(n_col, 1)), np.uint8)
    eh_h = np.full(qlen + 1, MINUS_INF, np.int64)
    eh_e = np.full(qlen + 1, MINUS_INF, np.int64)
    eh_h[0] = 0
    top = min(qlen, w)
    eh_h[1:top + 1] = -(sc.o_ins + e_ins * np.arange(1, top + 1))
    for i in range(tlen):
        beg, end = max(i - w, 0), min(i + w + 1, qlen)
        h1 = -(sc.o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        n = end - beg
        if n > 0:
            m = eh_h[beg:end] + prof[min(int(target[i]), 4), beg:end]
            e = eh_e[beg:end]
            t = m - oe_ins
            f = np.full(n, MINUS_INF, np.int64)
            if n > 1:
                r = np.arange(n - 1)
                f[1:] = np.maximum(
                    np.maximum.accumulate(t[:-1] + e_ins * r) - e_ins * r,
                    MINUS_INF - e_ins * (r + 1))
            d = np.where(m >= e, 0, 1).astype(np.uint8)
            h = np.maximum(m, e)
            d = np.where(h >= f, d, 2).astype(np.uint8)
            h = np.maximum(h, f)
            te = m - oe_del
            e2 = e - e_del
            d |= np.where(e2 > te, 1 << 2, 0).astype(np.uint8)
            d |= np.where(f - e_ins > t, 2 << 4, 0).astype(np.uint8)
            z[i, :n] = d
            eh_e[beg:end] = np.maximum(e2, te)
            eh_h[beg] = h1
            eh_h[beg + 1:end + 1] = h
        else:
            eh_h[end] = h1
        eh_e[end] = MINUS_INF
    score = int(eh_h[qlen])
    ops: list[list[int]] = []

    def push(op, ln):
        if ops and ops[-1][0] == op:
            ops[-1][1] += ln
        else:
            ops.append([op, ln])

    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        which = int(z[i, k - max(i - w, 0)]) >> (which << 1) & 3
        if which == 0:
            push(0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            push(2, 1)
            i -= 1
        else:
            push(1, 1)
            k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    return score, [tuple(o) for o in reversed(ops)]


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """bwamem.c:818-825."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    return max(int((min(l1, l2) * a - score - q) / r + 2.0), abs(l1 - l2))


def cigar_of(sc: Scoring, q: np.ndarray, r: np.ndarray, rev: bool, w_: int):
    """bwa_gen_cigar2 (bwa.c:148-234) on the region's query and reference
    codes: (score, CIGAR, NM)."""
    L = len(q)
    if rev:  # both reversed, so that indels go leftmost on the forward strand
        q, r = q[::-1], r[::-1]
    if L == len(r) and w_ == 0:
        score = int(sc.mat[r, q].sum())
        cig = [(0, L)]
    else:
        a = int(sc.mat[0, 0])
        mi = int((((L + 1) >> 1) * a - sc.o_ins) / sc.e_ins + 1.0)
        md = int((((L + 1) >> 1) * a - sc.o_del) / sc.e_del + 1.0)
        w = min(((max(mi, md, 1) + abs(len(r) - L) + 1) >> 1), w_)
        score, cig = global2(sc, q, r, max(w, abs(len(r) - L) + 3))
    nm, x, y = 0, 0, 0
    for ci, (op, ln) in enumerate(cig):
        if op == 0:
            nm += int(np.count_nonzero(q[x:x + ln] != r[y:y + ln]))
            x, y = x + ln, y + ln
        elif op == 2:
            nm += ln if 0 < ci < len(cig) - 1 else 0
            y += ln
        else:
            nm += ln
            x += ln
    return score, cig, nm


def record_of(sc: Scoring, g: Genome, q: np.ndarray, origin: int,
              bits=None) -> dict:
    """The SAM fields of the read's primary record at its origin as
    mem_reg2aln (bwamem.c:1119-1189) makes them: flag, pos (1-based),
    cigar, NM, AS and ref_len; an unmapped read gives flag 4 alone."""
    a = align_at(sc, g, q, origin, bits)
    if a is None:
        return dict(flag=UNMAP)
    L = len(q)
    qb, qe, rb, re = a["qb"], a["qe"], a["rb"], a["re"]
    rev = rb >= g.l_pac
    w2 = max(infer_bw(qe - qb, re - rb, a["truesc"], sc.a, sc.o_del,
                      sc.e_del),
             infer_bw(qe - qb, re - rb, a["truesc"], sc.a, sc.o_ins,
                      sc.e_ins))
    if w2 > sc.w:
        w2 = min(w2, a["w"])
    last, i = -(1 << 30), 0
    while True:
        w2 = min(w2, sc.w << 2)
        score, cig, nm = cigar_of(sc, q[qb:qe], g.fetch(rb, re), rev, w2)
        if score == last or w2 == sc.w << 2:
            break
        last, w2, i = score, w2 << 1, i + 1
        if not (i < 3 and score < a["truesc"] - sc.a):
            break
    pos = 2 * g.l_pac - re if rev else rb
    if cig[0][0] == 2:
        pos += cig[0][1]
        cig = cig[1:]
    elif cig[-1][0] == 2:
        cig = cig[:-1]
    clip5, clip3 = (L - qe, qb) if rev else (qb, L - qe)
    cig = ([(3, clip5)] if clip5 else []) + cig + (
        [(3, clip3)] if clip3 else [])
    ref_len = sum(ln for op, ln in cig if op in (0, 2))
    return dict(flag=REV if rev else 0, pos=pos + 1, NM=nm,
                AS=int(a["score"]), ref_len=ref_len,
                cigar="".join(f"{ln}{'MIDSH'[op]}" for op, ln in cig))


def insert_bounds(mean: float, std: float) -> tuple[int, int]:
    """mem_pestat's proper-pair bounds (bwamem_pair.c:66-94) for a normal
    library: the quartiles' outlier bounds widened to 4 standard
    deviations."""
    z = 0.6744897501960817
    p25, p75 = mean - z * std, mean + z * std
    low = int(p25 - 3.0 * (p75 - p25) + .499)
    high = int(p75 + 3.0 * (p75 - p25) + .499)
    low = min(low, int(mean - 4.0 * std + .499))
    high = max(high, int(mean + 4.0 * std + .499))
    return max(low, 1), high


def pair_records(r1: dict, r2: dict, bounds) -> tuple[dict, dict]:
    """Mate fields and flags of two mapped mates (mem_aln2sam,
    bwamem.c:1012-1051): TLEN from the 5' ends, proper when the pair
    faces inwards with its insert within the bounds."""
    out = []
    for me, mate, rd in ((r1, r2, READ1), (r2, r1, READ2)):
        d = dict(me)
        d["flag"] = me["flag"] | PAIRED | rd
        if me["flag"] & UNMAP or mate["flag"] & UNMAP:
            out.append(d)
            continue
        if mate["flag"] & REV:
            d["flag"] |= MREV
        p0 = me["pos"] - 1 + (me["ref_len"] - 1 if me["flag"] & REV else 0)
        p1 = mate["pos"] - 1 + (mate["ref_len"] - 1 if mate["flag"] & REV
                                else 0)
        d["tlen"] = -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))
        d["pnext"] = mate["pos"]
        out.append(d)
    a, b = out
    if not (a["flag"] | b["flag"]) & UNMAP:
        fwd, rev = (a, b) if not a["flag"] & REV else (b, a)
        inward = (not fwd["flag"] & REV) and rev["flag"] & REV \
            and fwd["pos"] <= rev["pos"] + rev["ref_len"] - 1
        if inward and bounds[0] <= abs(a["tlen"]) <= bounds[1]:
            a["flag"] |= PROPER
            b["flag"] |= PROPER
    return a, b

