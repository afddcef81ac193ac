"""SAM record emission: mem_aln2sam (bwamem.c:838-976), XA generation
(bwamem_extra.c:116-172) and mem_reg2sam (bwamem.c:1033-1079)."""

from __future__ import annotations

import numpy as np

from bwa_tpu_torch.mem.cigar import reg2aln
from bwa_tpu_torch.mem.types import MemAln, MemAlnReg, Read
from bwa_tpu_torch.options import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI,
                             MEM_F_REF_HDR, MEM_F_SOFTCLIP, MEM_F_XB)
from bwa_tpu_torch.mem.primary import INT_MAX

_CIGAR_STR = "MIDSH"
_CIGAR_STR_N = "MIDSHN"
_FWD = "ACGTN"
_REV = "TGCAN"


def _cigar_text(opt, p: MemAln, which: int) -> str:
    """add_cigar (bwamem.c:838-849)."""
    if not p.cigar:
        return "*"
    out = []
    for op, ln in p.cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{_CIGAR_STR[c]}")
    return "".join(out)


def _rlen(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (0, 2))


def aln2sam(opt, bnt, read: Read, seq_codes: np.ndarray, n: int,
            alns: list[MemAln], which: int, m_: MemAln | None,
            rg_id: str | None = None) -> str:
    p = MemAln(**{k: getattr(alns[which], k) for k in alns[which].__dataclass_fields__})
    m = None
    if m_ is not None:
        m = MemAln(**{k: getattr(m_, k) for k in m_.__dataclass_fields__})
    # flags (bwamem.c:858-866)
    p.flag |= 0x1 if m else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m and m.rid < 0) else 0
    if p.rid < 0 and m and m.rid >= 0:  # copy mate position to this record
        p.rid, p.pos, p.is_rev, p.cigar = m.rid, m.pos, m.is_rev, []
    if m and m.rid < 0 and p.rid >= 0:
        m.rid, m.pos, m.is_rev, m.cigar = p.rid, p.pos, p.is_rev, []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m and m.is_rev) else 0

    out = [read.name, str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0))]
    if p.rid >= 0:
        out.append(bnt.contigs[p.rid].name)
        out.append(str(p.pos + 1))
        out.append(str(p.mapq))
        out.append(_cigar_text(opt, p, which))
    else:
        out.extend(["*", "0", "0", "*"])

    if m and m.rid >= 0:
        out.append("=" if p.rid == m.rid else bnt.contigs[m.rid].name)
        out.append(str(m.pos + 1))
        if p.rid == m.rid:
            p0 = p.pos + (_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (_rlen(m.cigar) - 1 if m.is_rev else 0)
            if not m.cigar or not p.cigar:
                out.append("0")
            else:
                out.append(str(-(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))))
        else:
            out.append("0")
    else:
        out.extend(["*", "0", "0"])

    # SEQ/QUAL (bwamem.c:896-927)
    l_seq = len(seq_codes)
    if p.flag & 0x100:
        out.append("*\t*")
    else:
        qb, qe = 0, l_seq
        if p.cigar and which and not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt:
            if not p.is_rev:
                if p.cigar[0][0] in (3, 4):
                    qb += p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qe -= p.cigar[-1][1]
            else:
                if p.cigar[0][0] in (3, 4):
                    qe -= p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qb += p.cigar[-1][1]
        if not p.is_rev:
            seq_txt = "".join(_FWD[c] for c in seq_codes[qb:qe])
            qual_txt = (read.qual[qb:qe].decode()
                        if read.qual else "*")
        else:
            seq_txt = "".join(_REV[c] for c in seq_codes[qb:qe][::-1])
            qual_txt = (read.qual[qb:qe][::-1].decode()
                        if read.qual else "*")
        out.append(seq_txt + "\t" + (qual_txt if qual_txt else "*"))

    # optional tags (bwamem.c:929-974)
    tags = []
    if p.cigar:
        tags.append(f"NM:i:{p.NM}")
        tags.append(f"MD:Z:{p.md}")
    if m and m.cigar:
        tags.append(f"MC:Z:{_cigar_text(opt, m, which)}")
    if m:
        tags.append(f"MQ:i:{m.mapq}")
    if p.score >= 0:
        tags.append(f"AS:i:{p.score}")
    if p.sub >= 0:
        tags.append(f"XS:i:{p.sub}")
    if rg_id:
        tags.append(f"RG:Z:{rg_id}")
    if not (p.flag & 0x100):
        others = [i for i in range(n)
                  if i != which and not (alns[i].flag & 0x100)]
        if others:
            sa = []
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                cig = "".join(f"{ln}{_CIGAR_STR[op]}" for op, ln in r.cigar)
                strand = "-" if r.is_rev else "+"
                sa.append(f"{bnt.contigs[r.rid].name},{r.pos + 1},{strand},"
                          f"{cig},{r.mapq},{r.NM};")
            tags.append("SA:Z:" + "".join(sa))
        if p.alt_sc > 0:
            tags.append("pa:f:%.3f" % (p.score / p.alt_sc))
    if p.XA:
        tags.append(("XB:Z:" if opt.flag & MEM_F_XB else "XA:Z:") + p.XA)
    if read.comment:
        tags.append(read.comment)
    if (opt.flag & MEM_F_REF_HDR) and p.rid >= 0 and bnt.contigs[p.rid].anno:
        tags.append("XR:Z:" + bnt.contigs[p.rid].anno.replace("\t", " "))
    line = "\t".join(out)
    if tags:
        line += "\t" + "\t".join(tags)
    return line + "\n"


def _get_pri_idx(xa_drop_ratio, a: list[MemAlnReg], i: int) -> int:
    k = a[i].secondary_all
    if k >= 0 and a[i].score >= a[k].score * xa_drop_ratio:
        return k
    return -1


def gen_alt(opt, fm, regs: list[MemAlnReg], l_query: int,
            query_codes: np.ndarray) -> list[str | None] | None:
    """mem_gen_alt (bwamem_extra.c:124-172); returns XA per reg index."""
    n = len(regs)
    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    if tot == 0:
        return None
    aln: list[list[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or (not has_alt[r] and cnt[r] > opt.max_XA_hits):
            continue
        t = reg2aln(opt, fm, l_query, query_codes, regs[i])
        cig = "".join(f"{ln}{_CIGAR_STR_N[op]}" for op, ln in t.cigar)
        s = (f"{fm.bnt.contigs[t.rid].name},{'-' if t.is_rev else '+'}{t.pos + 1},"
             f"{cig},{t.NM}")
        if opt.flag & MEM_F_XB:
            s += f",{t.score},{t.mapq}"
        s += ";"
        aln[r].append(s)
    return ["".join(x) if x else None for x in aln]


def reg2sam(opt, fm, read: Read, seq_codes: np.ndarray,
            regs: list[MemAlnReg], extra_flag: int, m: MemAln | None,
            rg_id: str | None = None) -> str:
    """mem_reg2sam (bwamem.c:1033-1079)."""
    XA = None
    if not (opt.flag & MEM_F_ALL):
        XA = gen_alt(opt, fm, regs, len(seq_codes), seq_codes)
    aa: list[MemAln] = []
    l = 0
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (p.secondary >= 0 and p.secondary < INT_MAX
                and p.score < regs[p.secondary].score * opt.drop_ratio):
            continue
        q = reg2aln(opt, fm, len(seq_codes), seq_codes, p)
        assert q.rid >= 0
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1
        if l and p.secondary < 0:
            q.flag |= 0x10000 if opt.flag & MEM_F_NO_MULTI else 0x800
        if (not (opt.flag & MEM_F_KEEP_SUPP_MAPQ) and l and not p.is_alt
                and q.mapq > aa[0].mapq):
            q.mapq = aa[0].mapq
        aa.append(q)
        l += 1
    if not aa:
        t = reg2aln(opt, fm, len(seq_codes), seq_codes, None)
        t.flag |= extra_flag
        return aln2sam(opt, fm.bnt, read, seq_codes, 1, [t], 0, m, rg_id)
    return "".join(
        aln2sam(opt, fm.bnt, read, seq_codes, len(aa), aa, k, m, rg_id)
        for k in range(len(aa)))
