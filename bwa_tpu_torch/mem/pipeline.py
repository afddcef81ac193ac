"""The mem pipeline for single-end reads: mem_process_seqs
(bwamem.c:1235-1264) through the batched seeding engine and the C++
finalize (native/memfin.cpp).

Seeding runs on the engine's device bucket by bucket; bucket k's host
finalize runs while bucket k+1 seeds (the kt_pipeline overlap,
kthread.c:119-147).  Paired-end and -5 (primary5) are not ported yet and
raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np

from bwa_tpu_torch.index.pack import NT4_TABLE
from bwa_tpu_torch.mem.seeding import collect_intv
from bwa_tpu_torch.mem.types import Read
from bwa_tpu_torch.ops.ksw_band import K2_MAX_BAND, _band_for
from bwa_tpu_torch.options import MEM_F_PE, MEM_F_PRIMARY5


def to_codes_batch(reads) -> list[np.ndarray]:
    """One table lookup for the whole batch; returns per-read views."""
    if not reads:
        return []
    flat = NT4_TABLE[np.frombuffer(b"".join(r.seq for r in reads),
                                   dtype=np.uint8)]
    out = []
    pos = 0
    for r in reads:
        ln = len(r.seq)
        out.append(flat[pos:pos + ln])
        pos += ln
    return out


def use_device_ext(opt, engine, codes,
                   device_ext: bool | None = None) -> bool:
    """Route chain2aln extensions through the band kernel?  Explicit
    True/False wins; None (auto) means an engine on a CUDA device and a
    batch whose longest read is 512 bp or more (one extension batch then
    serves many long extensions; short-read extension is a few percent
    of the time and stays on the host).  On a CUDA engine the doubled
    retry band must fit K2 (-w up to 1023): a wider one raises."""
    on_cuda = getattr(getattr(engine, "device", None), "type", None) == "cuda"
    if device_ext is not None:
        use = bool(device_ext) and bool(codes)
    else:
        use = on_cuda and bool(codes) and max(len(c) for c in codes) >= 512
    if use and on_cuda and _band_for(opt.w << 1) > K2_MAX_BAND:
        raise ValueError(
            f"-w {opt.w}: the band-doubling retry needs P = "
            f"{_band_for(opt.w << 1)} band slots, K2 takes up to "
            f"{K2_MAX_BAND}")
    return use


def process_seqs(opt, engine, fm, reads: list[Read], n_processed: int = 0,
                 rg_id: str | None = None,
                 device_ext: bool | None = None) -> None:
    """mem_process_seqs for single-end reads: fills read.sam.
    device_ext: True/False forces device/host seed extension; None
    chooses by use_device_ext."""
    if opt.flag & MEM_F_PE:
        raise NotImplementedError("paired-end mem is not ported yet")
    if opt.flag & MEM_F_PRIMARY5:
        raise NotImplementedError("mem -5 is not ported yet")
    from bwa_tpu_torch.mem.batch_seed import (occurrence_positions,
                                              se_flat_buckets)
    from bwa_tpu_torch.mem.native_fin import (RefBlob, finalize_se_arrays,
                                              finalize_se_batch)

    codes = to_codes_batch(reads)
    ext = engine.device if use_device_ext(opt, engine, codes, device_ext) \
        else None
    if not hasattr(fm, "_ref_blob"):
        fm._ref_blob = RefBlob(fm)
    for lo, nb, flat in se_flat_buckets(opt, engine, fm, codes):
        rd = reads[lo:lo + nb]
        cd = codes[lo:lo + nb]
        ids = n_processed + np.arange(lo, lo + nb, dtype=np.int64)
        if flat is not None:
            sams = finalize_se_arrays(opt, fm, fm._ref_blob, rd, cd, *flat,
                                      0, rg_id, device_ext=ext, ids=ids)
        else:  # exactness fallback: seed-cap overflow at every device cap
            mems_list = [collect_intv(opt, engine, c) for c in cd]
            caches = occurrence_positions(opt, engine, mems_list)
            sams = finalize_se_batch(opt, fm, fm._ref_blob, rd, cd,
                                     mems_list, caches, 0, rg_id,
                                     device_ext=ext, ids=ids)
        for r, s in zip(rd, sams):
            r.sam = s

