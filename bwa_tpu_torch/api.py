"""Library API: the equivalent of example.c + mem_align1 (bwamem_extra.c:102).

>>> from bwa_tpu_torch.api import Aligner
>>> a = Aligner("ref.fa")                    # the CUDA card
>>> for hit in a.align(b"ACGT..."):
...     print(hit.rid, hit.pos, hit.cigar_str, hit.mapq, hit.NM)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bwa_tpu_torch.engine import make_engine
from bwa_tpu_torch.index.fmindex import FMIndex
from bwa_tpu_torch.mem.cigar import reg2aln
from bwa_tpu_torch.mem.pipeline import _batch_align, to_codes
from bwa_tpu_torch.mem.primary import mark_primary_se
from bwa_tpu_torch.options import MemOptions
from bwa_tpu_torch.utils.rand48 import Rand48

_CIG = "MIDSH"


@dataclass
class Hit:
    rid: int
    ref_name: str
    pos: int
    is_rev: bool
    mapq: int
    score: int
    NM: int
    cigar: list
    secondary: bool

    @property
    def cigar_str(self) -> str:
        return "".join(f"{ln}{_CIG[op]}" for op, ln in self.cigar)


class Aligner:
    """One index and its engine on `device` ("cuda", the default, raises
    where there is no card; "cpu" runs the plain versions).  align()
    seeds its one read through the batch seeder, one read a lane (kernel
    K1 on the card), then chains and extends it on the host.  The seeds
    are exact, so the hits are those of bwa_tpu's Aligner, which seeds
    through its host engine's scalar API."""

    def __init__(self, index_prefix, opt: MemOptions | None = None,
                 device: str | torch.device = "cuda"):
        self.fm = FMIndex.load(index_prefix)
        self.opt = opt or MemOptions()
        self.engine = make_engine(self.fm, device)
        self._rng = Rand48(0)  # mem_align1 uses lrand48() for the hash id

    def align(self, seq: bytes) -> list[Hit]:
        """Align one read; returns its hits (primary first)."""
        codes = to_codes(seq)
        regs = _batch_align(self.opt, self.engine, self.fm, [codes])[0]
        mark_primary_se(self.opt, regs, self._rng.lrand48())
        hits = []
        for reg in regs:
            if reg.score < self.opt.T:
                continue
            a = reg2aln(self.opt, self.fm, len(codes), codes, reg)
            hits.append(Hit(rid=a.rid,
                            ref_name=self.fm.bnt.contigs[a.rid].name,
                            pos=a.pos, is_rev=bool(a.is_rev), mapq=a.mapq,
                            score=a.score, NM=a.NM, cigar=a.cigar,
                            secondary=reg.secondary >= 0))
        return hits
