"""BWA-SW data types and options (bwtsw2.h:14-49)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# hit flags (bwtsw2.h:9-12)
BSW2_FLAG_MATESW = 0x100
BSW2_FLAG_TANDEM = 0x200
BSW2_FLAG_MOVED = 0x400
BSW2_FLAG_RESCUED = 0x800

# IUPAC complement for raw SAM SEQ bytes (nt_comp_table, bwtsw2_aux.c:32-49)
NT_COMP_TABLE = (
    b"N" * 64
    + b"NTVGHNNCDNNMNKNN"
    + b"NNYSANBWXRNNNNNN"
    + b"ntvghnncdnnmnknn"
    + b"nnysanbwxrnNNNNN"
    + b"N" * 128
)
assert len(NT_COMP_TABLE) == 256


def fill_scmat(a: int, b: int) -> np.ndarray:
    """bwa_fill_scmat (bwa.c:117-125): 5x5 with N rows/cols at -1.
    Memoized (it is rebuilt on every extension otherwise) and returned
    read-only so accidental mutation fails loudly."""
    return _fill_scmat_cached(a, b)


from functools import lru_cache  # noqa: E402


@lru_cache(maxsize=None)
def _fill_scmat_cached(a: int, b: int) -> np.ndarray:
    mat = np.full((5, 5), -1, dtype=np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = a if i == j else -b
    mat.setflags(write=False)
    return mat


def pair_scmat(a: int, b: int) -> np.ndarray:
    """The pairing score matrix (bwtsw2_pair.c:173-177): the 5th column is
    0 (not -1) and the N row scores -b."""
    mat = np.zeros((5, 5), dtype=np.int8)
    for i in range(5):
        for j in range(4):
            mat[i, j] = a if i == j else -b
        mat[i, 4] = 0
    return mat


@dataclass
class Bsw2Opt:
    """bsw2opt_t with bsw2_init_opt defaults (bwtsw2_aux.c:54-66)."""

    a: int = 1
    b: int = 3
    q: int = 5
    r: int = 2
    t: int = 30
    bw: int = 50
    max_ins: int = 20000
    z: int = 1
    is_: int = 3
    t_seeds: int = 5
    hard_clip: int = 0
    skip_sw: int = 0
    multi_2nd: int = 0
    mask_level: float = field(default_factory=lambda: float(np.float32(0.50)))
    coef: float = field(default_factory=lambda: float(np.float32(5.5)))
    qr: int = 7
    n_threads: int = 1
    chunk_size: int = 10000000
    max_chain_gap: int = 10000
    cpy_cmt: int = 0

    def copy(self) -> "Bsw2Opt":
        return Bsw2Opt(**{f: getattr(self, f) for f in self.__dataclass_fields__})


class Hit:
    """bsw2hit_t (bwtsw2.h:22-27)."""

    __slots__ = ("k", "l", "flag", "n_seeds", "is_rev", "len", "G", "G2",
                 "beg", "end")

    def __init__(self, k=0, l=0, flag=0, n_seeds=0, is_rev=0, len=0, G=0,
                 G2=0, beg=0, end=0):
        self.k = k
        self.l = l
        self.flag = flag
        self.n_seeds = n_seeds
        self.is_rev = is_rev
        self.len = len
        self.G = G
        self.G2 = G2
        self.beg = beg
        self.end = end

    def copy(self) -> "Hit":
        return Hit(self.k, self.l, self.flag, self.n_seeds, self.is_rev,
                   self.len, self.G, self.G2, self.beg, self.end)

    def __repr__(self):  # debugging aid only
        return (f"Hit(k={self.k},l={self.l},G={self.G},G2={self.G2},"
                f"beg={self.beg},end={self.end},len={self.len},"
                f"flag={self.flag:#x},rev={self.is_rev},ns={self.n_seeds})")


class Aux:
    """bsw2aux_t (bwtsw2.h:29-32)."""

    __slots__ = ("flag", "nn", "n_cigar", "chr", "pos", "qual", "mchr",
                 "mpos", "pqual", "isize", "nm", "cigar")

    def __init__(self):
        self.flag = 0
        self.nn = 0
        self.n_cigar = 0
        self.chr = 0
        self.pos = 0
        self.qual = 0
        self.mchr = 0
        self.mpos = 0
        self.pqual = 0
        self.isize = 0
        self.nm = 0
        self.cigar = None  # list[(op, len)] or None


class HitSet:
    """bwtsw2_t: a mutable container so aliases observe list replacement."""

    __slots__ = ("hits", "aux")

    def __init__(self, hits=None):
        self.hits = hits if hits is not None else []
        self.aux = None

    @property
    def n(self) -> int:
        return len(self.hits)

    def dup_no_cigar(self) -> "HitSet":
        return HitSet([h.copy() for h in self.hits])


def hitG_lt(a: Hit, b: Hit) -> bool:
    """__hitG_lt (bwtsw2_core.c:42): descending G + 4*n_seeds."""
    return a.G + (a.n_seeds << 2) > b.G + (b.n_seeds << 2)
