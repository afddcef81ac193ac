"""Auxiliary subcommands: fa2pac, pac2bwt, bwtupdate, bwt2sa, maxk,
pemerge, and the xa2multi/qualfa2fq script equivalents."""

from __future__ import annotations

import sys

import numpy as np

from bwa_tpu_torch.options import fill_scmat


# ---------------------------------------------------------------------------
# index tooling (bntseq.c:335-352, bwtindex.c:128-207)
# ---------------------------------------------------------------------------

def main_fa2pac(argv) -> int:
    import getopt as g

    from bwa_tpu_torch.index.pack import fasta2bnt, write_ann_amb, write_pac
    opts, args = g.getopt(argv, "f")
    for_only = any(c == "-f" for c, _ in opts)
    if not args:
        print("Usage: python -m bwa_tpu_torch.cli fa2pac [-f] <in.fasta> "
              "[<out.prefix>]",
              file=sys.stderr)
        return 1
    prefix = args[1] if len(args) > 1 else args[0]
    bnt, fwd = fasta2bnt(args[0])
    code = fwd if for_only else np.concatenate([fwd, (3 - fwd)[::-1]])
    # fa2pac writes the (possibly doubled) pac + metadata
    write_pac(prefix + ".pac", code)
    write_ann_amb(prefix, bnt)
    return 0


def main_pac2bwt(argv) -> int:
    """bwa pac2bwt <in.pac> <out.bwt> — BWT without occ interleaving
    (requires bwtupdate before use, bwtindex.c:128-146)."""
    import getopt as g

    from bwa_tpu_torch.index.build import bwt_from_sa, pack_bwt_words
    from bwa_tpu_torch.native.build import suffix_array
    opts, args = g.getopt(argv, "d")
    if len(args) < 2:
        print("Usage: python -m bwa_tpu_torch.cli pac2bwt <in.pac> <out.bwt>",
              file=sys.stderr)
        return 1
    raw = np.fromfile(args[0], dtype=np.uint8)
    last = int(raw[-1])
    n = (len(raw) - 2) * 4 + last  # bwa_seq_len (bwtindex.c:51-62)
    from bwa_tpu_torch.index.pack import unpack_pac
    code = unpack_pac(raw, n)
    sa = suffix_array(code)
    bwt_str, primary = bwt_from_sa(code, sa)
    counts = np.bincount(code, minlength=4).astype(np.uint64)
    L2 = np.zeros(5, dtype=np.uint64)
    np.cumsum(counts, out=L2[1:])
    words = pack_bwt_words(bwt_str)
    with open(args[1], "wb") as f:
        np.uint64(primary).tofile(f)
        L2[1:5].tofile(f)
        words.tofile(f)
    return 0


def main_pac2bwtgen(argv) -> int:
    """bwa pac2bwtgen <in.pac> <out.bwt> (bwt_bwtgen_main,
    bwt_gen.c:1606-1615): the bounded-memory blockwise BWT constructor.
    Output bytes == pac2bwt's (the BWT is unique; both write the
    pre-bwtupdate format), but peak memory stays O(block) via the native
    dynamic-BWT builder (native/bwtinc.cpp) instead of a full suffix
    array — the bwt_gen.c memory property."""
    from bwa_tpu_torch.native.build import bwt_incremental
    if len(argv) < 2:
        print("Usage: python -m bwa_tpu_torch.cli pac2bwtgen <in.pac> "
              "<out.bwt>",
              file=sys.stderr)
        return 1
    raw = np.fromfile(argv[0], dtype=np.uint8)
    last = int(raw[-1])
    n = (len(raw) - 2) * 4 + last  # bwa_seq_len (bwtindex.c:51-62)
    block = max(10_000_000, n // 96)
    inter, primary, cnt = bwt_incremental(raw[: (n + 3) // 4], n, block)
    L2 = np.zeros(5, dtype=np.uint64)
    np.cumsum(cnt.astype(np.uint64), out=L2[1:])
    # de-interleave: each 128-char block is 8 uint32 of occ counts then
    # 8 uint32 of packed chars; pac2bwtgen's output carries only the chars
    n_words = (n + 15) >> 4
    words = inter.view(np.uint32).reshape(-1, 16)[:, 8:].reshape(-1)[:n_words]
    with open(argv[1], "wb") as f:
        np.uint64(primary).tofile(f)
        L2[1:5].tofile(f)
        np.ascontiguousarray(words).tofile(f)
    return 0


def main_bwtupdate(argv) -> int:
    """bwa bwtupdate <the.bwt>: interleave occ checkpoints in place."""
    from bwa_tpu_torch.index.build import (interleave_bwt, occ_checkpoints,
                                     write_bwt_file)
    if not argv:
        print("Usage: python -m bwa_tpu_torch.cli bwtupdate <the.bwt>",
              file=sys.stderr)
        return 1
    fn = argv[0]
    raw = np.fromfile(fn, dtype=np.uint8)
    head = raw[:40].view(np.uint64)
    primary = int(head[0])
    L2 = np.zeros(5, dtype=np.uint64)
    L2[1:5] = head[1:5]
    seq_len = int(L2[4])
    words = raw[40:].view(np.uint32)
    # unpack the plain BWT string
    n_words = (seq_len + 15) >> 4
    assert words.shape[0] == n_words, "bwt already occ-interleaved?"
    shifts = (np.arange(15, -1, -1, dtype=np.uint32) * 2)
    bwt_str = ((words[:, None] >> shifts[None, :]) & 3).reshape(-1)[:seq_len]
    bwt_str = bwt_str.astype(np.uint8)
    ckpt = occ_checkpoints(bwt_str)
    from bwa_tpu_torch.index.build import pack_bwt_words
    interleaved = interleave_bwt(pack_bwt_words(bwt_str), ckpt, seq_len)
    write_bwt_file(fn, primary, L2, interleaved)
    return 0


def main_bwt2sa(argv) -> int:
    """bwa bwt2sa [-i intv] <in.bwt> <out.sa> via the host invPsi walk."""
    import getopt as g

    from bwa_tpu_torch.index.build import read_bwt_file, write_sa_file
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.ops.fm_host import HostFM
    opts, args = g.getopt(argv, "i:")
    sa_intv = 32
    for c, a in opts:
        if c == "-i":
            sa_intv = int(a)
    if len(args) < 2:
        print("Usage: python -m bwa_tpu_torch.cli bwt2sa [-i 32] <in.bwt> "
              "<out.sa>",
              file=sys.stderr)
        return 1
    primary, L2, seq_len, ckpt, words = read_bwt_file(args[0])
    # walk the inverse Psi chain like bwt_cal_sa (bwt.c:62-84)
    import types

    fmstub = types.SimpleNamespace()
    host = HostFM.__new__(HostFM)
    host.fm = fmstub
    host.primary = primary
    host.seq_len = seq_len
    host.L2 = L2.astype(np.int64)
    host.ckpt = ckpt.astype(np.int64)
    host.words = words
    n_sa = (seq_len + sa_intv) // sa_intv
    samples = np.zeros(n_sa, dtype=np.uint64)
    isa, sa = 0, seq_len
    for _ in range(seq_len):
        if isa % sa_intv == 0:
            samples[isa // sa_intv] = sa
        sa -= 1
        isa = host.inv_psi(isa)
    if isa % sa_intv == 0:
        samples[isa // sa_intv] = sa
    write_sa_file(args[1], primary, L2, sa_intv, seq_len, samples)
    return 0


# ---------------------------------------------------------------------------
# maxk (maxk.c)
# ---------------------------------------------------------------------------

def main_maxk(argv) -> int:
    import getopt as g

    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE
    from bwa_tpu_torch.io.fastq import SeqReader
    from bwa_tpu_torch.mem.fastmap import smem_iter
    from bwa_tpu_torch.ops.fm_host import HostFM

    opts, args = g.getopt(argv, "s")
    self_mode = any(c == "-s" for c, _ in opts)
    if len(args) < 2:
        print("Usage: python -m bwa_tpu_torch.cli maxk [-s] <index.prefix> "
              "<seq.fa>",
              file=sys.stderr)
        return 1
    fm = FMIndex.load(args[0])
    engine = HostFM(fm)  # the host spec, as maxk.c walks one read at a time
    hist = np.zeros(256, dtype=np.int64)
    min_intv = 2 if self_mode else 1
    for read in SeqReader(args[1]):
        q = NT4_TABLE[np.frombuffer(read.seq, dtype=np.uint8)]
        cnt = np.zeros(len(q), dtype=np.int64)
        for mems in smem_iter(engine, q, min_intv, 0):
            for (x0, x1, x2, info) in mems:
                start, end = info >> 32, info & 0xFFFFFFFF
                l = min(end - start, 255)
                cnt[start:end] = np.maximum(cnt[start:end], l)
        for v in cnt:
            hist[v] += 1
    for i in range(256):
        print(f"{i}\t{hist[i]}")
    return 0


# ---------------------------------------------------------------------------
# pemerge (pemerge.c)
# ---------------------------------------------------------------------------

MAX_SCORE_RATIO = 0.9
MAX_ERR = 8

_ERR_MSG = [
    "successful merges",
    "low-scoring pairs",
    "pairs where the best SW alignment is not an overlap (long left end)",
    "pairs where the best SW alignment is not an overlap (long right end)",
    "pairs with large 2nd best SW score",
    "pairs with gapped overlap",
    "pairs where the end-to-end alignment is inconsistent with SW",
    "pairs potentially with tandem overlaps",
    "pairs with high sum of errors",
]


def _pemerge_one(opt_mat, q_gapo, q_gape, T, q_def, q_thres, x0, x1):
    """bwa_pemerge (pemerge.c:59-145).  x0/x1: Read objects.
    Returns (err_code, merged_seq, merged_qual) — err 0 on success."""
    from bwa_tpu_torch.index.pack import NT4_TABLE
    from bwa_tpu_torch.ops.ksw_host import ksw_align2

    l0, l1 = len(x0.seq), len(x1.seq)
    s0 = NT4_TABLE[np.frombuffer(x0.seq, dtype=np.uint8)].copy()
    q0 = (np.frombuffer(x0.qual, dtype=np.uint8).astype(np.int32) - 33
          if x0.qual else np.full(l0, q_def, np.int32))
    raw1 = NT4_TABLE[np.frombuffer(x1.seq, dtype=np.uint8)][::-1].copy()
    s1 = np.where(raw1 < 4, 3 - raw1, 4).astype(np.uint8)
    q1 = (np.frombuffer(x1.qual, dtype=np.uint8)[::-1].astype(np.int32) - 33
          if x1.qual else np.full(l1, q_def, np.int32))

    r = ksw_align2(s1, s0, opt_mat, q_gapo, q_gape, q_gapo, q_gape,
                   use_byte=False, use_start=True, use_subo=True, thres=0)
    qe, te = r.qe + 1, r.te + 1
    if r.score < T:
        return 1, None, None
    if r.tb < r.qb:
        return 2, None, None
    if l0 - te > l1 - qe:
        return 3, None, None
    if r.score2 / r.score >= MAX_SCORE_RATIO:
        return 4, None, None
    if qe - r.qb != te - r.tb:
        return 5, None, None

    # tandem test (pemerge.c:95-114)
    mat = opt_mat.reshape(-1).astype(np.int32)
    min_l = min(l0, l1)
    max_m = max_m2 = 0
    max_l = max_l2 = 0
    for l in range(1, min_l):
        o = l0 - l
        m = int(mat[s1[:l].astype(np.int32) * 5 + s0[o:o + l]].sum())
        if m > max_m:
            max_m2, max_m = max_m, m
            max_l2, max_l = max_l, l
        elif m > max_m2:
            max_m2, max_l2 = m, l
    if max_m < T or max_l != l0 - (r.tb - r.qb):
        return 6, None, None
    if (max_l2 < max_l and max_m2 >= T
            and (max_m2 + (max_l - max_l2) * int(opt_mat[0, 0])) / max_m >= MAX_SCORE_RATIO):
        return 7, None, None
    if max_l2 > max_l and max_m2 / max_m >= MAX_SCORE_RATIO:
        return 7, None, None

    l = l0 - (r.tb - r.qb)
    l_seq = l0 + l1 - l
    seq = np.concatenate([s0, s1[l:]])
    qual = np.concatenate([q0, q1[l:]])
    sum_q = 0
    for i in range(l):
        k = l0 - l + i
        if s0[k] == 4:
            seq[k] = s1[i]
            qual[k] = q1[i]
        elif s1[i] == 4:
            pass
        elif s0[k] == s1[i]:
            qual[k] = max(qual[k], q1[i])
        else:
            qq = min(q0[k], q1[i])
            sum_q += (qq << 1) if qq >= 3 else 1
            seq[k] = s0[k] if q0[k] > q1[i] else s1[i]
            qual[k] = abs(int(q0[k]) - int(q1[i]))
    if (sum_q >> 1) > q_thres:
        return 8, None, None
    txt = "".join("ACGTN"[c] for c in seq)
    qtx = "".join(chr(min(int(v) + 33, 255)) for v in qual)
    return 0, txt, qtx


def main_pemerge(argv) -> int:
    import getopt as g

    from bwa_tpu_torch.io.fastq import SeqReader, read_batch

    flag = 0
    q_thres = 70
    min_ovlp = 10
    opts, args = g.getopt(argv, "muQ:t:T:")
    for c, a in opts:
        if c == "-m": flag |= 1
        elif c == "-u": flag |= 2
        elif c == "-Q": q_thres = int(a)
        elif c == "-T": min_ovlp = int(a)
    if flag == 0:
        flag = 3
    if not args:
        print("Usage: python -m bwa_tpu_torch.cli pemerge [-mu] <read1.fq> "
              "[read2.fq]",
              file=sys.stderr)
        return 1
    mat = fill_scmat(5, 4)
    T = 5 * min_ovlp
    ks1 = SeqReader(args[0])
    ks2 = SeqReader(args[1]) if len(args) > 1 else None
    cnt = [0] * (MAX_ERR + 1)
    out = sys.stdout

    def print_bseq(name, seq, qual, rn):
        out.write("@" if qual else ">")
        out.write(name)
        out.write(f"/{rn}\n" if rn in (1, 2) else " merged\n")
        out.write(seq + "\n")
        if qual:
            out.write("+\n" if False else "+\n")
            out.write(qual + "\n")

    while True:
        reads = read_batch(ks1, ks2, 10000000, copy_comment=False)
        if not reads:
            break
        n = len(reads) >> 1 << 1
        for i in range(n >> 1):
            a, b = reads[i * 2], reads[i * 2 + 1]
            err, seq, qual = _pemerge_one(mat, 2, 17, T, 20, q_thres, a, b)
            cnt[err] += 1
            if err != 0:
                if flag & 2:
                    print_bseq(a.name, a.seq.decode(),
                               a.qual.decode() if a.qual else None, 1)
                    print_bseq(b.name, b.seq.decode(),
                               b.qual.decode() if b.qual else None, 2)
            elif flag & 1:
                print_bseq(a.name, seq, qual, 0)
    for i in range(MAX_ERR + 1):
        print(f"{cnt[i]:12d} {_ERR_MSG[i]}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# script equivalents (xa2multi.pl, qualfa2fq.pl)
# ---------------------------------------------------------------------------

def main_xa2multi(argv) -> int:
    """Expand XA:Z: tags into extra 0x100 SAM records (xa2multi.pl)."""
    src = open(argv[0]) if argv else sys.stdin
    for line in src:
        if line.startswith("@"):
            sys.stdout.write(line)
            continue
        fields = line.rstrip("\n").split("\t")
        xa = None
        for t in fields[11:]:
            if t.startswith("XA:Z:"):
                xa = t[5:]
                break
        sys.stdout.write(line)
        if not xa:
            continue
        flag = int(fields[1])
        for hit in xa.rstrip(";").split(";"):
            chrom, pos, cigar, nm = hit.split(",")
            strand = pos[0]
            newflag = (flag & 0x6E9) | 0x100
            if strand == "-":
                newflag |= 0x10
            rec = [fields[0], str(newflag), chrom, pos[1:], "0", cigar,
                   "*", "0", "0", fields[9], fields[10], f"NM:i:{nm}"]
            sys.stdout.write("\t".join(rec) + "\n")
    return 0


def main_qualfa2fq(argv) -> int:
    """Merge a FASTA and a quality file into FASTQ (qualfa2fq.pl)."""
    if len(argv) < 2:
        print("Usage: python -m bwa_tpu_torch.cli qualfa2fq <in.fa> "
              "<in.qual>", file=sys.stderr)
        return 1
    from bwa_tpu_torch.index.pack import read_fasta
    quals = {}
    name = None
    chunks = []
    with open(argv[1]) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name:
                    quals[name] = " ".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name:
            quals[name] = " ".join(chunks)
    for name, _, seq in read_fasta(argv[0]):
        q = quals.get(name, "")
        qstr = "".join(chr(min(int(v) + 33, 126)) for v in q.split())
        print(f"@{name}\n{seq.decode()}\n+\n{qstr}")
    return 0
