"""The mem pipeline: mem_process_seqs (bwamem.c:1235-1264) through the
batched seeding engine and the C++ finalize (native/memfin.cpp).

Single-end seeding runs on the engine's device bucket by bucket; bucket
k's host finalize runs while bucket k+1 seeds (the kt_pipeline overlap,
kthread.c:119-147).  Paired-end seeds the whole batch, then runs one
finalize over it (insert-size estimate, mate rescue, pairing).
Single-end -5 (primary5) is not ported yet and raises
NotImplementedError.
"""

from __future__ import annotations

import copy

import numpy as np

from bwa_tpu_torch.index.pack import NT4_TABLE
from bwa_tpu_torch.mem.seeding import collect_intv
from bwa_tpu_torch.mem.types import Read
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
    of the time and stays on the host).  K2 takes every band width."""
    on_cuda = getattr(getattr(engine, "device", None), "type", None) == "cuda"
    if device_ext is not None:
        return bool(device_ext) and bool(codes)
    return on_cuda and bool(codes) and max(len(c) for c in codes) >= 512


def bseq_classify(reads: list[Read]):
    """bseq_classify (bwa.c:114-130): split a name-interleaved stream into
    unpaired reads and adjacent same-name pairs."""
    sep = [[], []]
    has_last = True
    n = len(reads)
    for i in range(1, n):
        if has_last:
            if reads[i].name == reads[i - 1].name:
                sep[1] += [reads[i - 1], reads[i]]
                has_last = False
            else:
                sep[0].append(reads[i - 1])
        else:
            has_last = True
    if has_last and n:
        sep[0].append(reads[n - 1])
    return sep


def process_seqs_smart(opt, engine, fm, reads, n_processed=0, pes0=None,
                       rg_id=None, device_ext=None):
    """The -p smart-pairing path (fastmap.c:90-109): unpaired reads go
    single-end, adjacent same-name pairs paired-end, in one batch each."""
    sep = bseq_classify(reads)
    if sep[0]:
        o = copy.copy(opt)
        o.flag = opt.flag & ~MEM_F_PE
        process_seqs(o, engine, fm, sep[0], n_processed, None, rg_id,
                     device_ext)
    if sep[1]:
        o = copy.copy(opt)
        o.flag = opt.flag | MEM_F_PE
        process_seqs(o, engine, fm, sep[1], n_processed + len(sep[0]),
                     pes0, rg_id, device_ext)


def process_seqs(opt, engine, fm, reads: list[Read], n_processed: int = 0,
                 pes0=None, rg_id: str | None = None,
                 device_ext: bool | None = None) -> None:
    """mem_process_seqs (bwamem.c:1235-1264): fills read.sam.
    Paired-end (MEM_F_PE) takes reads interleaved r1, r2 and runs one
    finalize over the whole batch (pes0: the -I insert-size statistics, or
    None to estimate them from the batch).  device_ext: True/False forces
    device/host seed extension; None chooses by use_device_ext."""
    if not reads:
        return
    if opt.flag & MEM_F_PRIMARY5 and not opt.flag & MEM_F_PE:
        raise NotImplementedError("single-end mem -5 is not ported yet")
    from bwa_tpu_torch.mem.batch_seed import (collect_se_flat,
                                              occurrence_positions,
                                              se_flat_buckets)
    from bwa_tpu_torch.mem.native_fin import (RefBlob, finalize_pe_arrays,
                                              finalize_se_arrays,
                                              flatten_tuple_seeds)

    def host_seeds(cd):
        """Exactness fallback for seed-cap overflow at every device cap:
        per-read seeding, flattened as the finalize takes it."""
        mems_list = [collect_intv(opt, engine, c) for c in cd]
        return flatten_tuple_seeds(
            opt, mems_list, occurrence_positions(opt, engine, mems_list))

    codes = to_codes_batch(reads)
    ext = engine.device if use_device_ext(opt, engine, codes, device_ext) \
        else None
    if not hasattr(fm, "_ref_blob"):
        fm._ref_blob = RefBlob(fm)
    if opt.flag & MEM_F_PE:
        # one finalize over the whole batch, in file order: the insert-size
        # estimate and the pair ids of hash_64 cover every pair
        flat = collect_se_flat(opt, engine, fm, codes) or host_seeds(codes)
        sams = finalize_pe_arrays(opt, fm, fm._ref_blob, reads, codes, *flat,
                                  n_processed, pes0, rg_id, device_ext=ext)
        for r, s in zip(reads, sams):
            r.sam = s
        return
    for lo, nb, flat in se_flat_buckets(opt, engine, fm, codes):
        rd = reads[lo:lo + nb]
        cd = codes[lo:lo + nb]
        ids = n_processed + np.arange(lo, lo + nb, dtype=np.int64)
        sams = finalize_se_arrays(opt, fm, fm._ref_blob, rd, cd,
                                  *(flat or host_seeds(cd)), 0, rg_id,
                                  device_ext=ext, ids=ids)
        for r, s in zip(rd, sams):
            r.sam = s
