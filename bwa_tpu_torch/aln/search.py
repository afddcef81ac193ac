"""Bounded-difference gapped backward search (bwa aln).

Host-exact implementation of bwt_cal_width (bwtaln.c:57-81) and
bwt_match_gap (bwtgap.c:109-264): best-first search over a score-indexed
LIFO stack with D-array lower-bound pruning.  The device reformulation
(score-bucketed frontier expansion) comes on top of this executable spec.
"""

from __future__ import annotations

from dataclasses import dataclass

from bwa_tpu_torch.aln.opts import (BWA_MODE_GAPE, BWA_MODE_LOGGAP,
                              BWA_MODE_NONSTOP, GapOpt)

STATE_M = 0
STATE_I = 1
STATE_D = 2


@dataclass
class Aln1:
    n_mm: int
    n_gapo: int
    n_gape: int
    score: int
    n_ins: int
    n_del: int
    k: int
    l: int


def aln_score(m, o, e, opt: GapOpt) -> int:
    return m * opt.s_mm + o * opt.s_gapo + e * opt.s_gape


def cal_width(fm, seq) -> list[tuple[int, int]]:
    """bwt_cal_width: per-position (w, bid) lower bounds."""
    k, l = 0, fm.seq_len
    bid = 0
    width = []
    for c in seq:
        c = int(c)
        if c < 4:
            ok = fm.occ(k - 1, c)
            ol = fm.occ(l, c)
            k = int(fm.L2[c]) + ok + 1
            l = int(fm.L2[c]) + ol
        if k > l or c > 3:
            k, l = 0, fm.seq_len
            bid += 1
        width.append((l - k + 1, bid))
    width.append((0, bid + 1))
    return width


def _int_log2(v: int) -> int:
    c = 0
    if v & 0xFFFF0000:
        v >>= 16
        c |= 16
    if v & 0xFF00:
        v >>= 8
        c |= 8
    if v & 0xF0:
        v >>= 4
        c |= 4
    if v & 0xC:
        v >>= 2
        c |= 2
    if v & 0x2:
        c |= 1
    return c


class GapStack:
    """Score-bucketed LIFO stack (bwtgap.c:17-84)."""

    def __init__(self, n_stacks: int):
        self.stacks: list[list] = [[] for _ in range(n_stacks)]
        self.best = n_stacks
        self.n = 0

    def push(self, entry, score: int):
        self.stacks[score].append(entry)
        self.n += 1
        if self.best > score:
            self.best = score

    def pop(self):
        q = self.stacks[self.best]
        e = q.pop()
        self.n -= 1
        if not q and self.n:
            i = self.best + 1
            while i < len(self.stacks) and not self.stacks[i]:
                i += 1
            self.best = i
        elif self.n == 0:
            self.best = len(self.stacks)
        return e


def _match_exact_alt(fm, seq, i, k, l):
    """bwt_match_exact_alt over seq[0:i] (bwt.c:241-256)."""
    for j in range(i - 1, -1, -1):
        c = int(seq[j])
        if c > 3:
            return 0, k, l
        ok = fm.occ(k - 1, c)
        ol = fm.occ(l, c)
        k = int(fm.L2[c]) + ok + 1
        l = int(fm.L2[c]) + ol
        if k > l:
            return 0, k, l
    return l - k + 1, k, l


def match_gap(fm, seq, width, seed_width, opt: GapOpt) -> list[Aln1]:
    """bwt_match_gap; seq is the reverse complement of the read."""
    length = len(seq)
    best_score = aln_score(opt.max_diff + 1, opt.max_gapo + 1,
                           opt.max_gape + 1, opt)
    best_diff = opt.max_diff + 1
    max_diff = opt.max_diff
    best_cnt = 0
    alns: list[Aln1] = []

    if sum(1 for c in seq if c > 3) > max_diff:
        return alns

    stack = GapStack(aln_score(opt.max_diff + 1, opt.max_gapo + 1,
                               opt.max_gape + 1, opt))
    # entry: (i, k, l, n_mm, n_gapo, n_gape, n_ins, n_del, state,
    #         last_diff_pos, score)
    stack.push((length, 0, fm.seq_len, 0, 0, 0, 0, 0, STATE_M, 0), 0)

    while stack.n:
        if stack.n > opt.max_entries:
            break
        e = stack.pop()
        (i, k, l, n_mm, n_gapo, n_gape, n_ins, n_del, state, ldp) = e
        score = aln_score(n_mm, n_gapo, n_gape, opt)
        if not (opt.mode & BWA_MODE_NONSTOP) and score > best_score + opt.s_mm:
            break

        m = max_diff - (n_mm + n_gapo)
        if opt.mode & BWA_MODE_GAPE:
            m -= n_gape
        if m < 0:
            continue
        m_seed = 0
        if seed_width is not None:
            m_seed = opt.max_seed_diff - (n_mm + n_gapo)
            if opt.mode & BWA_MODE_GAPE:
                m_seed -= n_gape
        if i > 0 and m < width[i - 1][1]:
            continue

        hit_found = False
        if i == 0:
            hit_found = True
        elif m == 0 and (state == STATE_M or (opt.mode & BWA_MODE_GAPE)
                         or n_gape == opt.max_gape):
            cnt, k, l = _match_exact_alt(fm, seq, i, k, l)
            if cnt:
                hit_found = True
            else:
                continue

        if hit_found:
            do_add = True
            if not alns:
                best_score = score
                best_diff = n_mm + n_gapo
                if opt.mode & BWA_MODE_GAPE:
                    best_diff += n_gape
                if not (opt.mode & BWA_MODE_NONSTOP):
                    max_diff = (opt.max_diff if best_diff + 1 > opt.max_diff
                                else best_diff + 1)
            if score == best_score:
                best_cnt += l - k + 1
            elif best_cnt > opt.max_top2:
                break
            if n_gapo:  # tandem-repeat duplicate check
                if any(a.k == k and a.l == l for a in alns):
                    do_add = False
            if do_add:
                # gap_shadow (bwtgap.c:86-96)
                x = l - k + 1
                jj = 0
                for t in range(ldp):
                    w, bid = width[t]
                    if w > x:
                        width[t] = (w - x, bid)
                    elif w == x:
                        jj += 1
                        width[t] = (fm.seq_len - jj, 1)
                alns.append(Aln1(n_mm=n_mm, n_gapo=n_gapo, n_gape=n_gape,
                                 score=score, n_ins=n_ins, n_del=n_del,
                                 k=k, l=l))
            continue

        i -= 1
        cnt_k = fm.occ4(k - 1)
        cnt_l = fm.occ4(l)
        occ = l - k + 1
        allow_diff = allow_M = True
        if i > 0:
            ii = i - (length - opt.seed_len)
            if width[i - 1][1] > m - 1:
                allow_diff = False
            elif (width[i - 1][1] == m - 1 and width[i][1] == m - 1
                  and width[i - 1][0] == width[i][0]):
                allow_M = False
            if seed_width is not None and ii > 0:
                if seed_width[ii - 1][1] > m_seed - 1:
                    allow_diff = False
                elif (seed_width[ii - 1][1] == m_seed - 1
                      and seed_width[ii][1] == m_seed - 1
                      and seed_width[ii - 1][0] == seed_width[ii][0]):
                    allow_M = False

        tmp = (_int_log2(n_gape + n_gapo) // 2 + 1
               if opt.mode & BWA_MODE_LOGGAP else n_gapo + n_gape)
        if (allow_diff and i >= opt.indel_end_skip + tmp
                and length - i >= opt.indel_end_skip + tmp):
            if state == STATE_M:
                if n_gapo < opt.max_gapo:
                    # insertion
                    stack.push((i, k, l, n_mm, n_gapo + 1, n_gape,
                                n_ins + 1, n_del, STATE_I, i),
                               aln_score(n_mm, n_gapo + 1, n_gape, opt))
                    # deletions
                    for j in range(4):
                        kk = int(fm.L2[j]) + int(cnt_k[j]) + 1
                        ll = int(fm.L2[j]) + int(cnt_l[j])
                        if kk <= ll:
                            stack.push((i + 1, kk, ll, n_mm, n_gapo + 1,
                                        n_gape, n_ins, n_del + 1, STATE_D,
                                        i + 1),
                                       aln_score(n_mm, n_gapo + 1, n_gape, opt))
            elif state == STATE_I:
                if n_gape < opt.max_gape:
                    stack.push((i, k, l, n_mm, n_gapo, n_gape + 1,
                                n_ins + 1, n_del, STATE_I, i),
                               aln_score(n_mm, n_gapo, n_gape + 1, opt))
            elif state == STATE_D:
                if n_gape < opt.max_gape:
                    if n_gape + n_gapo < max_diff or occ < opt.max_del_occ:
                        for j in range(4):
                            kk = int(fm.L2[j]) + int(cnt_k[j]) + 1
                            ll = int(fm.L2[j]) + int(cnt_l[j])
                            if kk <= ll:
                                stack.push((i + 1, kk, ll, n_mm, n_gapo,
                                            n_gape + 1, n_ins, n_del + 1,
                                            STATE_D, i + 1),
                                           aln_score(n_mm, n_gapo,
                                                     n_gape + 1, opt))
        if allow_diff and allow_M:
            for j in range(1, 5):
                c = (int(seq[i]) + j) & 3
                is_mm = int(j != 4 or int(seq[i]) > 3)
                kk = int(fm.L2[c]) + int(cnt_k[c]) + 1
                ll = int(fm.L2[c]) + int(cnt_l[c])
                if kk <= ll:
                    stack.push((i, kk, ll, n_mm + is_mm, n_gapo, n_gape,
                                n_ins, n_del, STATE_M, i if is_mm else 0),
                               aln_score(n_mm + is_mm, n_gapo, n_gape, opt))
        elif int(seq[i]) < 4:
            c = int(seq[i]) & 3
            kk = int(fm.L2[c]) + int(cnt_k[c]) + 1
            ll = int(fm.L2[c]) + int(cnt_l[c])
            if kk <= ll:
                stack.push((i, kk, ll, n_mm, n_gapo, n_gape, n_ins, n_del,
                            STATE_M, 0),
                           aln_score(n_mm, n_gapo, n_gape, opt))
    return alns
