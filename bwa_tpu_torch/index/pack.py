"""Reference-sequence metadata and 2-bit packing.

Byte-compatible with the reference's bntseq layer (.pac/.ann/.amb files,
bntseq.c:65-333): FASTA contigs are concatenated, A/C/G/T -> 0/1/2/3,
ambiguous bases are replaced with lrand48()&3 under fixed seed 11, and
runs of the same ambiguity character are recorded as "holes" in .amb.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from bwa_tpu_torch.utils.rand48 import Rand48

# base -> 2-bit code; 4 = ambiguous, 5 = '-' (bntseq.c:46-63)
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i
NT4_TABLE[ord("-")] = 5


@dataclass
class Contig:
    name: str
    anno: str  # FASTA comment; "(null)" when absent
    offset: int
    length: int
    n_ambs: int
    gi: int = 0
    is_alt: bool = False


@dataclass
class Hole:
    offset: int
    length: int
    amb: str


@dataclass
class Bnt:
    l_pac: int
    seed: int
    contigs: list[Contig]
    holes: list[Hole]
    pac: np.ndarray | None = None  # packed forward-only 2-bit, uint8 bytes
    _cum: np.ndarray | None = field(default=None, repr=False)

    @property
    def n_seqs(self) -> int:
        return len(self.contigs)

    # ---- coordinate services (bntseq.c:354-401, bntseq.h:87-90) ----

    def offsets(self) -> np.ndarray:
        if self._cum is None:
            self._cum = np.array([c.offset for c in self.contigs], dtype=np.int64)
        return self._cum

    def pos2rid(self, pos_f: int) -> int:
        if pos_f >= self.l_pac:
            return -1
        return int(np.searchsorted(self.offsets(), pos_f, side="right") - 1)

    def depos(self, pos: int) -> tuple[int, int]:
        """fwd/rev de-projection; returns (forward pos, is_rev)."""
        is_rev = int(pos >= self.l_pac)
        return ((self.l_pac << 1) - 1 - pos, 1) if is_rev else (pos, 0)

    def intv2rid(self, rb: int, re: int) -> int:
        if rb < self.l_pac < re:
            return -2
        assert rb <= re
        rid_b = self.pos2rid(self.depos(rb)[0])
        rid_e = self.pos2rid(self.depos(re - 1)[0]) if rb < re else rid_b
        return rid_b if rid_b == rid_e else -1

    def cnt_ambi(self, pos_f: int, length: int) -> int:
        """Number of ambiguous reference bases overlapping [pos_f, pos_f+length)
        (bntseq.c:380-401; stops at first overlapping hole like the reference)."""
        left, right = 0, len(self.holes)
        nn = 0
        while left < right:
            mid = (left + right) >> 1
            h = self.holes[mid]
            if pos_f >= h.offset + h.length:
                left = mid + 1
            elif pos_f + length <= h.offset:
                right = mid
            else:
                if pos_f >= h.offset:
                    nn += (h.offset + h.length - pos_f
                           if h.offset + h.length < pos_f + length else length)
                else:
                    nn += (h.length if h.offset + h.length < pos_f + length
                           else length - (h.offset - pos_f))
                break
        return nn


def _open_maybe_gz(path):
    p = str(path)
    f = open(p, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        f.close()
        return gzip.open(p, "rb")
    return f


def read_fasta(path):
    """Yield (name, comment, seq_bytes) per contig."""
    name = None
    comment = ""
    chunks: list[bytes] = []
    with _open_maybe_gz(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">") or line.startswith(b"@"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                hdr = line[1:].decode()
                parts = hdr.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                chunks = []
            elif line.startswith(b"+") and name is not None and chunks:
                # FASTQ quality header: the reference kseq also accepts FASTQ
                # as reference input; skip the quality line.
                next(f, None)
            else:
                chunks.append(line)
    if name is not None:
        yield name, comment, b"".join(chunks)


def fasta2bnt(path) -> tuple[Bnt, np.ndarray]:
    """Parse FASTA -> (Bnt metadata, forward code array uint8 in 0..3).

    Ambiguous bases are already replaced by lrand48()&3 (seed 11), matching
    bns_fasta2bntseq (bntseq.c:280-333).
    """
    rng = Rand48(11)
    contigs: list[Contig] = []
    holes: list[Hole] = []
    codes_parts: list[np.ndarray] = []
    offset = 0
    for name, comment, seq in read_fasta(path):
        raw = np.frombuffer(seq, dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        amb_idx = np.nonzero(codes >= 4)[0]
        n_ambs = 0
        if amb_idx.size:
            # hole runs: same raw character, contiguous (bntseq.c:246-263)
            prev_i = -2
            prev_ch = -1
            for i in amb_idx.tolist():
                ch = int(raw[i])
                if i == prev_i + 1 and ch == prev_ch:
                    holes[-1].length += 1
                else:
                    holes.append(Hole(offset + i, 1, chr(ch)))
                    n_ambs += 1
                prev_i, prev_ch = i, ch
            # random fill, one lrand48 call per ambiguous base, in order
            fill = np.array([rng.lrand48() & 3 for _ in range(amb_idx.size)],
                            dtype=np.uint8)
            codes[amb_idx] = fill
        contigs.append(Contig(name=name, anno=comment if comment else "(null)",
                              offset=offset, length=len(seq), n_ambs=n_ambs))
        offset += len(seq)
        codes_parts.append(codes)
    code = (np.concatenate(codes_parts) if codes_parts
            else np.zeros(0, dtype=np.uint8))
    bnt = Bnt(l_pac=offset, seed=11, contigs=contigs, holes=holes)
    return bnt, code


def pack_codes(code: np.ndarray) -> np.ndarray:
    """2-bit pack: base l lands in byte l>>2 at bit shift (~l&3)*2
    (bntseq.c:229)."""
    n = code.shape[0]
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = code
    q = padded.reshape(-1, 4)
    return (q[:, 0] << 6 | q[:, 1] << 4 | q[:, 2] << 2 | q[:, 3]).astype(np.uint8)


def unpack_pac(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_codes for the first n bases."""
    b = pac[: (n + 3) // 4]
    out = np.empty(b.shape[0] * 4, dtype=np.uint8)
    out[0::4] = b >> 6
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:n]


def write_pac(path, code: np.ndarray) -> None:
    """.pac writer; trailing-byte convention per bntseq.c:314-327."""
    l_pac = code.shape[0]
    data = pack_codes(code)
    with open(path, "wb") as f:
        f.write(data[: (l_pac >> 2) + (0 if l_pac % 4 == 0 else 1)].tobytes())
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def write_ann_amb(prefix, bnt: Bnt) -> None:
    """Writers for .ann/.amb, formats per bns_dump (bntseq.c:65-95)."""
    with open(str(prefix) + ".ann", "w") as f:
        f.write(f"{bnt.l_pac} {bnt.n_seqs} {bnt.seed}\n")
        for c in bnt.contigs:
            f.write(f"{c.gi} {c.name}")
            f.write(f" {c.anno}\n" if c.anno else "\n")
            f.write(f"{c.offset} {c.length} {c.n_ambs}\n")
    with open(str(prefix) + ".amb", "w") as f:
        f.write(f"{bnt.l_pac} {bnt.n_seqs} {len(bnt.holes)}\n")
        for h in bnt.holes:
            f.write(f"{h.offset} {h.length} {h.amb}\n")


def read_ann_amb(prefix) -> Bnt:
    """Load .ann/.amb (+.alt if present), mirroring bns_restore
    (bntseq.c:97-211)."""
    contigs: list[Contig] = []
    holes: list[Hole] = []
    with open(str(prefix) + ".ann") as f:
        toks = f.readline().split()
        l_pac, n_seqs, seed = int(toks[0]), int(toks[1]), int(toks[2])
        for _ in range(n_seqs):
            line = f.readline().rstrip("\n")
            parts = line.split(" ", 2)
            gi = int(parts[0])
            name = parts[1]
            anno = parts[2] if len(parts) > 2 and parts[2] != "(null)" else ""
            toks = f.readline().split()
            contigs.append(Contig(name=name, anno=anno, offset=int(toks[0]),
                                  length=int(toks[1]), n_ambs=int(toks[2]), gi=gi))
    with open(str(prefix) + ".amb") as f:
        toks = f.readline().split()
        n_holes = int(toks[2])
        for _ in range(n_holes):
            toks = f.readline().split()
            holes.append(Hole(int(toks[0]), int(toks[1]), toks[2][0]))
    bnt = Bnt(l_pac=l_pac, seed=seed, contigs=contigs, holes=holes)
    alt = Path(str(prefix) + ".alt")
    if alt.exists():
        by_name = {c.name: c for c in bnt.contigs}
        for line in alt.read_text().splitlines():
            nm = line.split("\t")[0].split("\n")[0]
            if nm and not nm.startswith("@") and nm in by_name:
                by_name[nm].is_alt = True
    return bnt


def load_pac(prefix, l_pac: int) -> np.ndarray:
    """Load .pac bytes (forward strand only), as the aligner keeps it
    (bwa.c:307-309: l_pac/4+1 bytes)."""
    with open(str(prefix) + ".pac", "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data[: l_pac // 4 + 1].copy()
