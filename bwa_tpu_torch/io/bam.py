"""Minimal BAM reader (bamlite.{h,c} semantics) for `aln -b` input.

Reads BGZF/gzip/plain BAM streams (the reference reads through zlib's
gzFile, which transparently accepts all three — bamlite.h:23-31), parses
the header and yields alignment records.  Input-only, like the reference.
"""

from __future__ import annotations

import struct

from bwa_tpu_torch.io.fastq import _open

# 4-bit nt16 code -> nt4 (bwaseqio.c:15)
BAM_NT16_NT4 = bytes([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4])

BAM_FPAIRED = 1
BAM_FREVERSE = 0x10
BAM_FREAD1 = 0x40
BAM_FREAD2 = 0x80


class BamRecord:
    __slots__ = ("flag", "name", "seq4", "qual", "l_qseq")

    def __init__(self, flag, name, seq4, qual, l_qseq):
        self.flag = flag
        self.name = name
        self.seq4 = seq4    # packed 4-bit, (l+1)//2 bytes
        self.qual = qual    # raw phred bytes (0xFF when absent)
        self.l_qseq = l_qseq

    def nt4_codes(self):
        out = bytearray(self.l_qseq)
        s = self.seq4
        for i in range(self.l_qseq):
            out[i] = BAM_NT16_NT4[(s[i >> 1] >> (4 * (1 - (i & 1)))) & 0xF]
        return bytes(out)


class BamReader:
    """Iterates alignment records of a BAM stream (bam_read1,
    bamlite.c:135-167)."""

    def __init__(self, path):
        self.f = _open(path)
        magic = self._read(4)
        if magic != b"BAM\x01":
            raise ValueError("invalid BAM binary header "
                             "(this is not a BAM file)")
        (l_text,) = struct.unpack("<i", self._read(4))
        self._read(l_text)
        (n_targets,) = struct.unpack("<i", self._read(4))
        for _ in range(n_targets):
            (name_len,) = struct.unpack("<i", self._read(4))
            self._read(name_len + 4)

    def _read(self, n):
        buf = self.f.read(n)
        if len(buf) != n:
            raise EOFError("truncated BAM stream")
        return buf

    def close(self):
        self.f.close()

    def __iter__(self):
        return self

    def __next__(self) -> BamRecord:
        head = self.f.read(4)
        if len(head) == 0:
            raise StopIteration
        if len(head) != 4:
            raise EOFError("truncated BAM stream")
        (block_len,) = struct.unpack("<i", head)
        core = self._read(32)
        (_tid, _pos, x2, x3, l_qseq, _mtid, _mpos, _isize) = struct.unpack(
            "<iiIIiiii", core)
        l_qname = x2 & 0xFF
        flag = x3 >> 16
        n_cigar = x3 & 0xFFFF
        data = self._read(block_len - 32)
        off = 0
        name = data[off:off + l_qname - 1].decode()
        off += l_qname
        off += n_cigar * 4
        nseq = (l_qseq + 1) // 2
        seq4 = data[off:off + nseq]
        off += nseq
        qual = data[off:off + l_qseq]
        return BamRecord(flag, name, seq4, qual, l_qseq)


def write_bam(path, records, targets=()):
    """Tiny BAM writer (plain, uncompressed-into-gzip optional) used by the
    test suite to synthesize `aln -b` inputs; mirrors the layout bam_read1
    expects."""
    import gzip

    buf = bytearray()
    buf += b"BAM\x01"
    text = b""
    buf += struct.pack("<i", len(text)) + text
    buf += struct.pack("<i", len(targets))
    for name, length in targets:
        nb = name.encode() + b"\x00"
        buf += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    for flag, name, seq_str, qual in records:
        nb = name.encode() + b"\x00"
        l = len(seq_str)
        nt16 = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
        packed = bytearray((l + 1) // 2)
        for i, ch in enumerate(seq_str.upper()):
            v = nt16.get(ch, 15)
            packed[i >> 1] |= v << (4 * (1 - (i & 1)))
        q = bytes((min(ord(c) - 33, 93) for c in qual) if qual
                  else (0xFF,) * l)
        data = (nb + b"" + bytes(packed) + q)
        x2 = (0 << 16) | (0 << 8) | len(nb)
        x3 = (flag << 16) | 0
        core = struct.pack("<iiIIiiii", -1, -1, x2, x3, l, -1, -1, 0)
        buf += struct.pack("<i", 32 + len(data)) + core + data
    with gzip.open(path, "wb") as f:
        f.write(bytes(buf))
