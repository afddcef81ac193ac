"""Backtrack read intake: bwa_read_seq semantics (bwaseqio.c:151-221):
nt4 conversion, quality trimming, /1|/2 name trim, barcode clip, Casava
filter, Illumina-1.3 quals; p.seq stored REVERSED, p.rseq reverse(-comp)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from bwa_tpu_torch.aln.opts import (BWA_MODE_CFY, BWA_MODE_COMPREAD, BWA_MODE_IL13,
                              BWA_MIN_RDLEN)
from bwa_tpu_torch.index.pack import NT4_TABLE
from bwa_tpu_torch.io.fastq import SeqReader

BARCODE_LOW_QUAL = 13


@dataclass
class BtSeq:
    name: str
    full_codes: np.ndarray     # original orientation, FULL length (for SEQ
                               # output: bwa_print_seq uses full_len bases)
    qual: bytearray | None     # original orientation ASCII quals
    len: int
    full_len: int
    clip_len: int
    bc: str = ""
    is_comp: bool = True       # mode & BWA_MODE_COMPREAD (for lazy rseq)
    # seq/rseq are LAZY: the native samse path never touches them, and
    # they were ~0.1s of per-read numpy work per 8k batch.  seq = nt4
    # codes of the REVERSED trimmed read (p->seq); rseq =
    # reverse(complement per is_comp).
    _seq: np.ndarray | None = None
    _rseq: np.ndarray | None = None
    # alignment state (filled by samse/sampe)
    strand: int = 0
    type: int = 0              # BWA_TYPE_*
    extra_flag: int = 0
    n_mm: int = 0
    n_gapo: int = 0
    n_gape: int = 0
    mapQ: int = 0
    seQ: int = 0
    score: int = 0
    n_aln: int = 0
    aln: list = field(default_factory=list)
    n_multi: int = 0
    multi: list = field(default_factory=list)
    sa: int = 0
    pos: int = -1
    c1: int = 0
    c2: int = 0
    ref_shift: int = 0
    cigar: list | None = None  # [(op, len)] op in MIDS=0..3
    nm: int = 0
    md: str | None = None

    @property
    def seq(self) -> np.ndarray:
        if self._seq is None:
            self._seq = seq_reverse(
                np.asarray(self.full_codes[:self.len], np.uint8), False)
        return self._seq

    @seq.setter
    def seq(self, v) -> None:
        self._seq = v

    @property
    def rseq(self) -> np.ndarray:
        if self._rseq is None:
            self._rseq = seq_reverse(
                np.asarray(self.full_codes[:self.len], np.uint8),
                self.is_comp)
        return self._rseq

    @rseq.setter
    def rseq(self, v) -> None:
        self._rseq = v


def seq_reverse(arr: np.ndarray, is_comp: bool) -> np.ndarray:
    if is_comp:
        out = arr[::-1].copy()
        mask = out < 4
        out[mask] = 3 - out[mask]
        return out
    return arr[::-1].copy()


def trim_read(trim_qual: int, qual: bytes, length: int) -> int:
    """bwa_trim_read (bwaseqio.c:80-91): returns the trimmed length."""
    if trim_qual < 1 or qual is None:
        return length
    s, mx, max_l = 0, 0, length
    for l in range(length - 1, BWA_MIN_RDLEN - 1, -1):
        s += trim_qual - (qual[l] - 33)
        if s < 0:
            break
        if s > mx:
            mx, max_l = s, l
    return max_l


def open_reads(mode: int, fn: str):
    """bwa_open_reads (bwtaln.c:146-157): BAM when BWA_MODE_BAM, with the
    which-mask from -0/-1/-2, else FASTQ/FASTA."""
    from bwa_tpu_torch.aln.opts import (BWA_MODE_BAM, BWA_MODE_BAM_READ1,
                                  BWA_MODE_BAM_READ2, BWA_MODE_BAM_SE)

    if mode & BWA_MODE_BAM:
        from bwa_tpu_torch.io.bam import BamReader

        which = 0
        if mode & BWA_MODE_BAM_SE:
            which |= 4
        if mode & BWA_MODE_BAM_READ1:
            which |= 1
        if mode & BWA_MODE_BAM_READ2:
            which |= 2
        if which == 0:
            which = 7
        rd = BamReader(fn)
        rd.which = which
        return rd
    # fast strict-FASTQ block path when no per-record transforms apply
    # (barcode clip, Casava filter, Illumina-1.3 quals) and the input is
    # a plain uncompressed file
    import os as _os

    if (not (mode & (BWA_MODE_CFY | BWA_MODE_IL13)) and (mode >> 24) == 0
            and fn != "-" and _os.path.isfile(fn)):
        with open(fn, "rb") as probe:
            head = probe.read(2)
        if head[:1] == b"@" :
            return BtReadStream(fn)
    return SeqReader(fn)


def read_bam_seqs(reader, n_needed: int, is_comp: bool,
                  trim_qual: int) -> list[BtSeq]:
    """bwa_read_bam (bwaseqio.c:94-148)."""
    from bwa_tpu_torch.io.bam import BAM_FREAD1, BAM_FREAD2, BAM_FREVERSE

    which = reader.which
    out: list[BtSeq] = []
    for rec in reader:
        go = ((which & 1) and (rec.flag & BAM_FREAD1)) or \
             ((which & 2) and (rec.flag & BAM_FREAD2)) or \
             ((which & 4) and not (rec.flag & (BAM_FREAD1 | BAM_FREAD2)))
        if not go:
            continue
        codes = np.frombuffer(rec.nt4_codes(), dtype=np.uint8).copy()
        qual = bytearray(min(q + 33, 126) for q in rec.qual)
        if rec.flag & BAM_FREVERSE:  # stored reverse-complemented
            codes = seq_reverse(codes, True)
            qual = qual[::-1]
        full_len = length = rec.l_qseq
        if trim_qual >= 1:
            length = trim_read(trim_qual, qual, length)
        out.append(BtSeq(name=rec.name, full_codes=codes,
                         qual=qual, len=length, full_len=full_len,
                         clip_len=length, is_comp=is_comp))
        if len(out) == n_needed:
            break
    return out


def read_bt_seqs(reader, n_needed: int, mode: int,
                 trim_qual: int) -> list[BtSeq]:
    is_comp = bool(mode & BWA_MODE_COMPREAD)
    if isinstance(reader, BtReadStream):
        return reader.read(n_needed, mode, trim_qual, is_comp)
    if not isinstance(reader, SeqReader):  # BAM input (aln -b)
        return read_bam_seqs(reader, n_needed, is_comp, trim_qual)
    is_64 = bool(mode & BWA_MODE_IL13)
    l_bc = mode >> 24
    out: list[BtSeq] = []
    for read in reader:
        if (mode & BWA_MODE_CFY) and read.comment:
            i = read.comment.find(":")
            if i >= 0 and i + 1 < len(read.comment) and read.comment[i + 1] == "Y":
                continue
        seq_bytes = read.seq
        qual = bytearray(read.qual) if read.qual else None
        if is_64 and qual:
            qual = bytearray(q - 31 for q in qual)
        if len(seq_bytes) <= l_bc:
            continue
        bc = ""
        if l_bc:
            bcs = []
            for i in range(l_bc):
                ch = chr(seq_bytes[i])
                if qual and qual[i] - 33 < BARCODE_LOW_QUAL:
                    bcs.append(ch.lower())
                else:
                    bcs.append(ch.upper())
            bc = "".join(bcs)
            seq_bytes = seq_bytes[l_bc:]
            if qual:
                qual = qual[l_bc:]
        full_len = len(seq_bytes)
        codes = NT4_TABLE[np.frombuffer(seq_bytes, dtype=np.uint8)].copy()
        length = full_len
        if qual and trim_qual >= 1:
            length = trim_read(trim_qual, qual, length)
        p = BtSeq(name=read.name, full_codes=codes,
                  qual=qual, len=length, full_len=full_len,
                  clip_len=length, bc=bc, is_comp=is_comp)
        out.append(p)
        if len(out) == n_needed:
            break
    return out


class FastBtFastq:
    """Strict 4-line FASTQ block parser for the backtrack read intake —
    the general kseq-equivalent SeqReader pays ~30us of Python per record
    (rstrip/decode/split per line), which had become the largest share of
    aln/samse wall time after the native ports.  Reads the file in 64 MB
    blocks and splits whole records with bytes.split; any structural
    surprise (multi-line records, FASTA, comments needing Casava
    filtering) makes the caller fall back to the general parser over the
    remaining byte stream, so correctness never depends on the fast
    path."""

    BLOCK = 64 << 20

    def __init__(self, path):
        self.f = open(path, "rb")
        self.rem = b""
        self.eof = False

    def take_rest_stream(self):
        """File-like over (unconsumed remainder + rest of file) for the
        general-parser fallback."""
        import io

        rest = self.rem
        self.rem = b""

        class _Chain(io.RawIOBase):
            def __init__(s):
                s._head = io.BytesIO(rest)

            def readable(s):
                return True

            def readinto(s, b):
                n = s._head.readinto(b)
                if n:
                    return n
                return self.f.readinto(b) if hasattr(self.f, "readinto") \
                    else s._fallback(b)

            def _fallback(s, b):
                data = self.f.read(len(b))
                b[: len(data)] = data
                return len(data)

        return io.BufferedReader(_Chain())

    def batch(self, n_needed: int):
        """(records, ok): up to n_needed (name, seq_bytes, qual_bytes)
        records, all fully validated and consumed.  ok=False means the
        NEXT record is not strict 4-line FASTQ — the caller must finish
        the stream through the general parser (take_rest_stream);
        everything already returned stands."""
        out = []
        while len(out) < n_needed:
            # ensure the remainder holds complete records or EOF
            nl = self.rem.count(b"\n")
            if nl < 4 and not self.eof:
                chunk = self.f.read(self.BLOCK)
                if not chunk:
                    self.eof = True
                else:
                    self.rem += chunk
                    continue
            if not self.rem:
                break
            lines = self.rem.split(b"\n")
            tail = lines.pop()  # partial line (or b"")
            n_rec = len(lines) // 4
            if n_rec == 0:
                if self.eof:
                    return (out, False) if self.rem.strip() else (out, True)
                continue
            take = min(n_rec, n_needed - len(out))
            for r in range(take):
                hdr, seq, plus, qual = lines[4 * r: 4 * r + 4]
                if (not hdr.startswith(b"@") or not plus.startswith(b"+")
                        or len(seq) != len(qual) or b" " in hdr
                        or b"\t" in hdr or hdr.endswith(b"\r")
                        or not seq):
                    # structural surprise: consume exactly the records
                    # already emitted, leave the rest for the fallback
                    self.rem = b"\n".join(lines[4 * r:] + [tail])
                    return out, False
                out.append((hdr[1:], seq, qual))
            self.rem = b"\n".join(lines[4 * take:] + [tail])
        return out, True


class BtReadStream:
    """Fast-path reader handle: strict 4-line FASTQ blocks until a
    structural surprise, then the general SeqReader over the remaining
    byte stream (records already returned stand — they were fully
    validated)."""

    def __init__(self, path):
        self.fast = FastBtFastq(path)
        self.fallback: SeqReader | None = None

    def read(self, n_needed: int, mode: int, trim_qual: int,
             is_comp: bool) -> list[BtSeq]:
        out: list[BtSeq] = []
        if self.fast is not None:
            recs, ok = self.fast.batch(n_needed)
            got = _build_bt(recs, is_comp, trim_qual)
            if not ok:
                self.fallback = SeqReader(self.fast.take_rest_stream())
                self.fast = None
            out.extend(got)
        if self.fallback is not None and len(out) < n_needed:
            out.extend(read_bt_seqs(self.fallback, n_needed - len(out),
                                    mode, trim_qual))
        return out


class PackedReads:
    """One batch of backtrack reads as the flat arrays the native
    finalizers (btsam.cpp/btgap.cpp) consume — built either directly by
    the native strict-FASTQ parser (bt_fastq_parse, native/txtutil.cpp),
    which skips per-read Python object construction entirely, or by
    flattening a list[BtSeq] (from_seqs) on the general-parser path."""

    __slots__ = ("n", "codes_flat", "codes_off", "lens", "full_lens",
                 "clip_lens", "qual_flat", "qual_off", "names_blob",
                 "name_off", "bc_blob", "bc_off")

    @classmethod
    def from_seqs(cls, seqs: list[BtSeq]) -> "PackedReads":
        pk = cls()
        n = pk.n = len(seqs)
        codes_off = np.zeros(n + 1, np.int64)
        qual_off = np.zeros(n + 1, np.int64)
        name_off = np.zeros(n + 1, np.int64)
        bc_off = np.zeros(n, np.int32)
        lens = np.zeros(n, np.int32)
        full_lens = np.zeros(n, np.int32)
        clip_lens = np.zeros(n, np.int32)
        has_qual = all(p.qual is not None for p in seqs)
        codes_parts, qual_parts, name_parts, bc_parts = [], [], [], []
        bpos = 0
        for i, p in enumerate(seqs):
            codes_off[i + 1] = codes_off[i] + p.full_len
            codes_parts.append(np.asarray(p.full_codes[:p.full_len],
                                          np.uint8))
            if has_qual:
                qual_off[i + 1] = qual_off[i] + len(p.qual)
                qual_parts.append(bytes(p.qual))
            nb = p.name.encode() + b"\x00"
            name_off[i + 1] = name_off[i] + len(nb)
            name_parts.append(nb)
            bc_off[i] = bpos
            bb = p.bc.encode() + b"\x00"
            bc_parts.append(bb)
            bpos += len(bb)
            lens[i] = p.len
            full_lens[i] = p.full_len
            clip_lens[i] = p.clip_len
        pk.codes_flat = np.ascontiguousarray(
            np.concatenate(codes_parts) if codes_parts
            else np.zeros(0, np.uint8), np.uint8)
        pk.qual_flat = np.ascontiguousarray(
            np.frombuffer(b"".join(qual_parts), np.uint8)) if has_qual \
            else None
        pk.codes_off, pk.lens, pk.full_lens = codes_off, lens, full_lens
        pk.clip_lens = clip_lens
        pk.qual_off = qual_off if has_qual else None
        pk.names_blob, pk.name_off = b"".join(name_parts), name_off
        pk.bc_blob, pk.bc_off = b"".join(bc_parts), bc_off
        return pk

    @classmethod
    def concat(cls, a: "PackedReads", b: "PackedReads") -> "PackedReads":
        if a.n == 0:
            return b
        if b.n == 0:
            return a
        pk = cls()
        pk.n = a.n + b.n
        pk.codes_flat = np.concatenate([a.codes_flat, b.codes_flat])
        pk.codes_off = np.concatenate(
            [a.codes_off, b.codes_off[1:] + a.codes_off[-1]])
        for f in ("lens", "full_lens", "clip_lens"):
            setattr(pk, f, np.concatenate([getattr(a, f), getattr(b, f)]))
        if a.qual_flat is not None and b.qual_flat is not None:
            pk.qual_flat = np.concatenate([a.qual_flat, b.qual_flat])
            pk.qual_off = np.concatenate(
                [a.qual_off, b.qual_off[1:] + a.qual_off[-1]])
        else:  # mixed FASTQ/FASTA: same all-or-nothing rule as from_seqs
            pk.qual_flat = pk.qual_off = None
        pk.names_blob = a.names_blob + b.names_blob
        pk.name_off = np.concatenate(
            [a.name_off, b.name_off[1:] + a.name_off[-1]])
        pk.bc_blob = a.bc_blob + b.bc_blob
        pk.bc_off = np.concatenate(
            [a.bc_off, b.bc_off + np.int32(len(a.bc_blob))])
        return pk


def _txt_native():
    """ctypes handle with bt_fastq_parse registered, or None."""
    try:
        import ctypes

        from bwa_tpu_torch.native.build import get_lib

        lib = get_lib()
    except Exception:
        return None
    if not getattr(lib, "_btfq_sig", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bt_fastq_parse.restype = ctypes.c_int64
        lib.bt_fastq_parse.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, u8p, i64p, i32p, i32p, u8p, i64p, u8p, i64p,
            i64p, i32p]
        lib._btfq_sig = True
    return lib


def _batch_packed_native(fast: FastBtFastq, lib, n_needed: int,
                         trim_qual: int):
    """(PackedReads, ok) via the native strict parser over fast's byte
    stream; ok=False means the stream must continue through the general
    parser (take_rest_stream) — records already packed stand."""
    import ctypes

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    parts: list[PackedReads] = []
    total = 0
    ok = True
    while total < n_needed:
        if not fast.rem and not fast.eof:
            chunk = fast.f.read(fast.BLOCK)
            if not chunk:
                fast.eof = True
            else:
                fast.rem = chunk
        if not fast.rem:
            break
        buf = np.frombuffer(fast.rem, np.uint8)
        ln = buf.shape[0]
        want = n_needed - total
        pk = PackedReads()
        codes = np.empty(ln, np.uint8)
        codes_off = np.zeros(want + 1, np.int64)
        lens = np.empty(want, np.int32)
        full_lens = np.empty(want, np.int32)
        names = np.empty(ln, np.uint8)
        name_off = np.zeros(want + 1, np.int64)
        quals = np.empty(ln, np.uint8)
        qual_off = np.zeros(want + 1, np.int64)
        consumed = np.zeros(1, np.int64)
        okv = np.zeros(1, np.int32)
        n = int(lib.bt_fastq_parse(
            buf.ctypes.data_as(u8p), np.int64(ln), np.int64(want),
            np.int32(1 if fast.eof else 0), np.int32(trim_qual),
            codes.ctypes.data_as(u8p), codes_off.ctypes.data_as(i64p),
            lens.ctypes.data_as(i32p), full_lens.ctypes.data_as(i32p),
            names.ctypes.data_as(u8p), name_off.ctypes.data_as(i64p),
            quals.ctypes.data_as(u8p), qual_off.ctypes.data_as(i64p),
            consumed.ctypes.data_as(i64p), okv.ctypes.data_as(i32p)))
        fast.rem = fast.rem[int(consumed[0]):]
        if n:
            pk.n = n
            pk.codes_flat = codes[: codes_off[n]]
            pk.codes_off = codes_off[: n + 1]
            pk.lens, pk.full_lens = lens[:n], full_lens[:n]
            pk.clip_lens = lens[:n].copy()
            pk.qual_flat = quals[: qual_off[n]]
            pk.qual_off = qual_off[: n + 1]
            pk.names_blob = names[: name_off[n]].tobytes()
            pk.name_off = name_off[: n + 1]
            pk.bc_blob = b"\x00" * n
            pk.bc_off = np.arange(n, dtype=np.int32)
            parts.append(pk)
            total += n
        if not okv[0]:
            ok = False
            break
        if n < want:
            if fast.eof:
                fast.rem = b""  # at most trailing whitespace (ok==1)
                break
            chunk = fast.f.read(fast.BLOCK)  # partial record: refill
            if not chunk:
                fast.eof = True
            else:
                fast.rem += chunk
    if not parts:
        out = PackedReads.from_seqs([])
    else:
        out = parts[0]
        for p in parts[1:]:
            out = PackedReads.concat(out, p)
    return out, ok


def read_bt_packed(reader, n_needed: int, mode: int,
                   trim_qual: int) -> PackedReads:
    """Batch intake straight to the native finalizers' flat-array form.
    Uses the native strict-FASTQ parser when the stream is still on the
    fast path; otherwise packs the general parser's BtSeq list."""
    if isinstance(reader, BtReadStream) and reader.fast is not None:
        lib = _txt_native()
        if lib is not None:
            pk, ok = _batch_packed_native(reader.fast, lib, n_needed,
                                          trim_qual)
            if not ok:
                reader.fallback = SeqReader(reader.fast.take_rest_stream())
                reader.fast = None
                if pk.n < n_needed:
                    rest = read_bt_seqs(reader, n_needed - pk.n, mode,
                                        trim_qual)
                    if rest:
                        pk = PackedReads.concat(
                            pk, PackedReads.from_seqs(rest))
            return pk
    return PackedReads.from_seqs(
        read_bt_seqs(reader, n_needed, mode, trim_qual))


def _build_bt(recs, is_comp: bool, trim_qual: int) -> list[BtSeq]:
    out = []
    for name_b, seq_b, qual_b in recs:
        name = name_b.decode()
        if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
            name = name[:-2]
        codes = NT4_TABLE[np.frombuffer(seq_b, dtype=np.uint8)].copy()
        qual = bytearray(qual_b)
        full_len = length = len(seq_b)
        if trim_qual >= 1:
            length = trim_read(trim_qual, qual, length)
        out.append(BtSeq(name=name, full_codes=codes, qual=qual,
                         len=length, full_len=full_len, clip_len=length,
                         is_comp=is_comp))
    return out
