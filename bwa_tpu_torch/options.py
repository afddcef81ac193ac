"""Alignment options, mirroring the reference mem_opt_t flag-for-flag.

Defaults match mem_opt_init() (reference bwamem.c:74-110); the -x mode
presets and the -A rescaling rule (update_a) match fastmap.c:125-139,330-359.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

import numpy as np

# flag bits (bwamem.h:40-50)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000
MEM_F_XB = 0x2000

MEM_MAPQ_COEF = 30.0
MEM_MAPQ_MAX = 60


def fill_scmat(a: int, b: int) -> np.ndarray:
    """5x5 scoring matrix: match a, mismatch -b, anything vs N = -1
    (reference bwa.c:136-145)."""
    mat = np.full((5, 5), -1, dtype=np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = a if i == j else -b
    return mat


@dataclass
class MemOptions:
    a: int = 1
    b: int = 4
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100
    zdrop: int = 100
    max_mem_intv: int = 20
    T: int = 30
    flag: int = 0
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    chunk_size: int = 10000000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    mask_level_redun: float = 0.95
    mapQ_coef_len: float = 50.0
    # the reference stores this in an *int* field (bwamem.h:79), so
    # log(50)=3.91 truncates to 3 — observable in near-tie ALT mapq
    mapQ_coef_fac: int = field(default_factory=lambda: int(math.log(50.0)))
    max_ins: int = 10000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    mat: np.ndarray = field(default_factory=lambda: fill_scmat(1, 4))

    # shadow struct: which fields were explicitly set on the command line
    # (the reference's opt0, fastmap.c:143,158)
    _explicit: set = field(default_factory=set)

    # mem_opt_t stores these as C float (bwamem.h:68-77), so every value
    # rounds through float32 before any double arithmetic.  Observable:
    # XA_drop_ratio 0.80 -> 0.800000011920929 makes 150*ratio exceed 120
    # (a score-120 hit is then EXCLUDED from XA, while double 0.8*150
    # rounds to exactly 120.0 and would include it); same hazard for
    # mask_level_redun 0.95.
    _F32_FIELDS = ("split_factor", "mask_level", "drop_ratio",
                   "XA_drop_ratio", "mask_level_redun", "mapQ_coef_len")

    def __post_init__(self):
        for name in self._F32_FIELDS:
            object.__setattr__(self, name, float(np.float32(getattr(self, name))))

    def set(self, name: str, value) -> None:
        if name in self._F32_FIELDS:
            value = float(np.float32(value))
        setattr(self, name, value)
        self._explicit.add(name)

    def was_set(self, name: str) -> bool:
        return name in self._explicit

    def apply_mode(self, mode: str | None) -> None:
        """-x presets; only override fields not explicitly set
        (fastmap.c:330-359)."""
        if mode is None:
            self._update_a()
            self.mat = fill_scmat(self.a, self.b)
            return
        e = self.was_set
        if mode == "intractg":
            if not e("o_del"): self.o_del = 16
            if not e("o_ins"): self.o_ins = 16
            if not e("b"): self.b = 9
            if not e("pen_clip5"): self.pen_clip5 = 5
            if not e("pen_clip3"): self.pen_clip3 = 5
        elif mode in ("pacbio", "pbref", "ont2d"):
            if not e("o_del"): self.o_del = 1
            if not e("e_del"): self.e_del = 1
            if not e("o_ins"): self.o_ins = 1
            if not e("e_ins"): self.e_ins = 1
            if not e("b"): self.b = 1
            if not e("split_factor"): self.split_factor = 10.0
            if mode == "ont2d":
                if not e("min_chain_weight"): self.min_chain_weight = 20
                if not e("min_seed_len"): self.min_seed_len = 14
                if not e("pen_clip5"): self.pen_clip5 = 0
                if not e("pen_clip3"): self.pen_clip3 = 0
            else:
                if not e("min_chain_weight"): self.min_chain_weight = 40
                if not e("min_seed_len"): self.min_seed_len = 17
                if not e("pen_clip5"): self.pen_clip5 = 0
                if not e("pen_clip3"): self.pen_clip3 = 0
        else:
            raise ValueError(f"unknown read type '{mode}'")
        self.mat = fill_scmat(self.a, self.b)

    def _update_a(self) -> None:
        """-A rescaling of dependent penalties (fastmap.c:125-139)."""
        if not self.was_set("a"):
            return
        e = self.was_set
        if not e("b"): self.b *= self.a
        if not e("T"): self.T *= self.a
        if not e("o_del"): self.o_del *= self.a
        if not e("e_del"): self.e_del *= self.a
        if not e("o_ins"): self.o_ins *= self.a
        if not e("e_ins"): self.e_ins *= self.a
        if not e("zdrop"): self.zdrop *= self.a
        if not e("pen_clip5"): self.pen_clip5 *= self.a
        if not e("pen_clip3"): self.pen_clip3 *= self.a
        if not e("pen_unpaired"): self.pen_unpaired *= self.a
