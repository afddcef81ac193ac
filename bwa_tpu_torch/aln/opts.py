"""Backtrack options (gap_opt_t / pe_opt_t) with the reference defaults and
the raw-struct .sai serialization (bwtaln.c:26-40, 178-179)."""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_CFY = 0x08
BWA_MODE_NONSTOP = 0x10
BWA_MODE_BAM = 0x20
BWA_MODE_BAM_SE = 0x40
BWA_MODE_BAM_READ1 = 0x80
BWA_MODE_BAM_READ2 = 0x100
BWA_MODE_IL13 = 0x200

BWA_AVG_ERR = 0.02
BWA_MIN_RDLEN = 35

# gap_opt_t layout: 7 ints, 1 float, 8 ints (64 bytes, bwtaln.h:105-115)
_FMT = "<7if8i"


@dataclass
class GapOpt:
    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    mode: int = BWA_MODE_GAPE | BWA_MODE_COMPREAD
    indel_end_skip: int = 5
    max_del_occ: int = 10
    max_entries: int = 2000000
    fnr: float = 0.04
    max_diff: int = -1
    max_gapo: int = 1
    max_gape: int = 6
    max_seed_diff: int = 2
    seed_len: int = 32
    n_threads: int = 1
    max_top2: int = 30
    trim_qual: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _FMT, self.s_mm, self.s_gapo, self.s_gape, self.mode,
            self.indel_end_skip, self.max_del_occ, self.max_entries,
            self.fnr, self.max_diff, self.max_gapo, self.max_gape,
            self.max_seed_diff, self.seed_len, self.n_threads,
            self.max_top2, self.trim_qual)

    @classmethod
    def unpack(cls, data: bytes) -> "GapOpt":
        v = struct.unpack(_FMT, data[:struct.calcsize(_FMT)])
        return cls(s_mm=v[0], s_gapo=v[1], s_gape=v[2], mode=v[3],
                   indel_end_skip=v[4], max_del_occ=v[5], max_entries=v[6],
                   fnr=v[7], max_diff=v[8], max_gapo=v[9], max_gape=v[10],
                   max_seed_diff=v[11], seed_len=v[12], n_threads=v[13],
                   max_top2=v[14], trim_qual=v[15])

    @staticmethod
    def size() -> int:
        return struct.calcsize(_FMT)


@dataclass
class PEOpt:
    max_isize: int = 500
    force_isize: int = 0
    max_occ: int = 100000
    n_multi: int = 3
    N_multi: int = 10
    type: int = 1  # BWA_PET_STD
    is_sw: int = 1
    is_preload: int = 0
    ap_prior: float = 1e-5


def cal_maxdiff(l: int, err: float, thres: float) -> int:
    """bwa_cal_maxdiff (bwtaln.c:42-54).

    The reference accumulates the factorial in a C ``int``: it wraps at
    k=13 (13! > 2^31) and hits exactly 0 at k=34 (34! has 32 factors of
    two), where C's y/0.0 yields inf and terminates the loop.  That
    wraparound is observable for long reads with fractional -n, so it is
    mirrored bit-for-bit here (validated against a compiled probe of the
    reference function over l in [10, 10000]).
    """
    elambda = math.exp(-l * err)
    y = 1.0
    x = 1
    total = elambda
    for k in range(1, 1000):
        y *= l * err
        x = (x * k) & 0xFFFFFFFF
        xs = x - (1 << 32) if x >= (1 << 31) else x
        if xs == 0:
            total += math.inf if y > 0 else (-math.inf if y < 0 else math.nan)
        else:
            total += elambda * y / xs
        if 1.0 - total < thres:
            return k
    return 2
