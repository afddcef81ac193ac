""".sai file format (SAI_MAGIC + raw gap_opt_t + per-read aln records),
byte-compatible with the reference (bwtaln.c:178-218, bwase.c:528-551)."""

from __future__ import annotations

import struct

import numpy as np

from bwa_tpu_torch.aln.opts import GapOpt
from bwa_tpu_torch.aln.search import Aln1

SAI_MAGIC = b"SAI\x01"


def pack_aln1(a: Aln1) -> bytes:
    """bwt_aln1_t: bitfield u64 (n_mm:8,n_gapo:8,n_gape:8,score:20,
    n_ins:10,n_del:10) + k,l u64."""
    word = (a.n_mm & 0xFF) | ((a.n_gapo & 0xFF) << 8) | ((a.n_gape & 0xFF) << 16) \
        | ((a.score & 0xFFFFF) << 24) | ((a.n_ins & 0x3FF) << 44) \
        | ((a.n_del & 0x3FF) << 54)
    return struct.pack("<QQQ", word, a.k, a.l)


def unpack_aln1(data: bytes) -> Aln1:
    word, k, l = struct.unpack("<QQQ", data)
    return Aln1(n_mm=word & 0xFF, n_gapo=(word >> 8) & 0xFF,
                n_gape=(word >> 16) & 0xFF, score=(word >> 24) & 0xFFFFF,
                n_ins=(word >> 44) & 0x3FF, n_del=(word >> 54) & 0x3FF,
                k=k, l=l)


class SaiWriter:
    def __init__(self, fp, opt: GapOpt):
        self.fp = fp
        fp.write(SAI_MAGIC)
        fp.write(opt.pack())

    def write_read(self, alns: list[Aln1]) -> None:
        self.fp.write(struct.pack("<i", len(alns)))
        for a in alns:
            self.fp.write(pack_aln1(a))

    def write_batch_raw(self, out_n: "np.ndarray",
                        rows: "np.ndarray") -> None:
        """Vectorized batch write from the native search's flat record
        rows [n_rec, 8] = (n_mm, n_gapo, n_gape, score, n_ins, n_del, k,
        l) — identical bytes to per-record pack_aln1."""
        r = rows.astype(np.uint64)
        recs = np.empty((r.shape[0], 3), np.uint64)
        recs[:, 0] = ((r[:, 0] & 0xFF) | ((r[:, 1] & 0xFF) << 8)
                      | ((r[:, 2] & 0xFF) << 16)
                      | ((r[:, 3] & 0xFFFFF) << 24)
                      | ((r[:, 4] & 0x3FF) << 44)
                      | ((r[:, 5] & 0x3FF) << 54))
        recs[:, 1] = r[:, 6]
        recs[:, 2] = r[:, 7]
        rb = recs.tobytes()
        nb = out_n.astype(np.int32).tobytes()
        parts = []
        off = 0
        for i in range(out_n.shape[0]):
            c = int(out_n[i])
            parts.append(nb[4 * i:4 * i + 4])
            parts.append(rb[off * 24:(off + c) * 24])
            off += c
        self.fp.write(b"".join(parts))


class SaiReader:
    def __init__(self, fp):
        self.fp = fp
        magic = fp.read(4)
        if magic != SAI_MAGIC:
            raise ValueError("Unmatched SAI magic")
        self.opt = GapOpt.unpack(fp.read(GapOpt.size()))

    def read_read(self) -> list[Aln1]:
        raw = self.fp.read(4)
        if len(raw) < 4:
            raise EOFError
        n = struct.unpack("<i", raw)[0]
        return [unpack_aln1(self.fp.read(24)) for _ in range(n)]
