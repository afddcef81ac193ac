"""Pipeline data types (mirrors bwamem.h structs)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class MemSeed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclass
class MemChain:
    rid: int
    pos: int                 # B-tree key: rbeg of the first seed
    seeds: list[MemSeed]
    is_alt: int = 0
    w: int = 0               # weight
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0

    @property
    def n(self) -> int:
        return len(self.seeds)


@dataclass
class MemAlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0


@dataclass
class MemAln:
    """Final per-record alignment (mem_aln_t)."""
    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    is_alt: int = 0
    mapq: int = 0
    NM: int = -1
    cigar: list = field(default_factory=list)  # [(op, len)] MIDSH = 0..4
    md: str = ""
    XA: str | None = None
    score: int = -1
    sub: int = -1
    alt_sc: int = 0


@dataclass
class Read:
    name: str
    seq: bytes               # raw ASCII
    qual: bytes | None = None
    comment: str | None = None
    id: int = 0
    sam: str = ""
