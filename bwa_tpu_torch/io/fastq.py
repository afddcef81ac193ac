"""FASTQ/FASTA reading into Read batches (bseq_read, bwa.c:79-112)."""

from __future__ import annotations

import gzip

from bwa_tpu_torch.mem.types import Read


def _open(path):
    """Magic open (kopen.c): plain files, '-' for stdin, and http://
    or ftp:// URLs, transparently gunzipped."""
    import io
    import sys

    p = str(path)
    if p == "-":
        raw = sys.stdin.buffer
        head = raw.peek(2)[:2] if hasattr(raw, "peek") else b""
        if head == b"\x1f\x8b":
            return gzip.open(raw, "rb")
        return raw
    if p.startswith(("http://", "ftp://", "https://")):
        from urllib.request import urlopen

        resp = urlopen(p)
        buf = io.BufferedReader(resp)
        if buf.peek(2)[:2] == b"\x1f\x8b":
            return gzip.open(buf, "rb")
        return buf
    f = open(p, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.close()
        return gzip.open(p, "rb")
    f.seek(0)
    return f


def _trim_readno(name: str) -> str:
    """trim_readno (bwa.c:47-53): drop trailing /1 or /2."""
    if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


class SeqReader:
    """Streaming FASTQ/FASTA parser equivalent to kseq."""

    def __init__(self, path):
        # a file-like (e.g. the FastBtFastq fallback chain) is used as-is
        self.f = path if hasattr(path, "readline") else _open(path)
        self._peek = None

    def close(self):
        self.f.close()

    def _readline(self):
        if self._peek is not None:
            l, self._peek = self._peek, None
            return l
        return self.f.readline()

    def __iter__(self):
        return self

    def __next__(self) -> Read:
        while True:
            hdr = self._readline()
            if not hdr:
                raise StopIteration
            hdr = hdr.rstrip(b"\r\n")
            if hdr:
                break
        if hdr[:1] not in (b"@", b">"):
            raise ValueError(f"malformed record header: {hdr[:40]!r}")
        fields = hdr[1:].decode().split(None, 1)
        name = _trim_readno(fields[0]) if fields else ""
        comment = fields[1] if len(fields) > 1 else None
        seq_parts = []
        qual = None
        while True:
            line = self._readline()
            if not line:
                break
            line = line.rstrip(b"\r\n")
            if line[:1] == b"+":
                qual_parts = []
                need = sum(map(len, seq_parts))
                got = 0
                while got < need:
                    ql = self._readline()
                    if not ql:
                        break
                    ql = ql.rstrip(b"\r\n")
                    qual_parts.append(ql)
                    got += len(ql)
                qual = b"".join(qual_parts)
                break
            if line[:1] in (b"@", b">"):
                self._peek = line + b"\n"
                break
            seq_parts.append(line)
        seq = b"".join(seq_parts)
        return Read(name=name, seq=seq, qual=qual if qual else None,
                    comment=comment)


def read_batch(ks1: SeqReader, ks2: SeqReader | None, chunk_size: int,
               copy_comment: bool = False) -> list[Read]:
    """bseq_read: read until total bases >= chunk_size (even count in PE)."""
    reads: list[Read] = []
    size = 0
    it1 = iter(ks1)
    it2 = iter(ks2) if ks2 is not None else None
    while True:
        try:
            r1 = next(it1)
        except StopIteration:
            break
        if it2 is not None:
            try:
                r2 = next(it2)
            except StopIteration:
                import sys
                print("[W::bseq_read] the 2nd file has fewer sequences.",
                      file=sys.stderr)
                break
        r1.id = len(reads)
        if not copy_comment:
            r1.comment = None
        reads.append(r1)
        size += len(r1.seq)
        if it2 is not None:
            r2.id = len(reads)
            if not copy_comment:
                r2.comment = None
            reads.append(r2)
            size += len(r2.seq)
        if size >= chunk_size and len(reads) % 2 == 0:
            break
    return reads
