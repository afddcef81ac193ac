"""Paired-end insert-size statistics (mem_pestat_t, bwamem.h:96-100).

The pairing itself (mem_pestat, mate rescue, mem_sam_pe) runs in the C++
finalize (native/memfin.cpp); this class carries the user's -I setting
into it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PEStat:
    low: int = 0
    high: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0
