"""The mem pipeline: mem_align1_core / mem_process_seqs
(bwamem.c:1081-1117, 1235-1264) through the batched seeding engine.

The default route hands the seeds to the C++ finalize
(native/memfin.cpp).  Single-end seeding runs on the engine's device
bucket by bucket; bucket k's host finalize runs while bucket k+1 seeds
(the kt_pipeline overlap, kthread.c:119-147).  Paired-end seeds the whole
batch, then runs one finalize over it (insert-size estimate, mate rescue,
pairing).  Either may seed in trip-sorted order (batch_seed.trip_order);
the output stays in file order.  Single-end -5 (primary5), and every read
under BWA_TPU_FINALIZE other than "native", take the Python route: the batch
seeds on the device one read a lane (batch_seed.collect_intv_batch), then
chaining, extension, primary marking and SAM run per read in Python
(chain.py, extend.py, primary.py, sam.py, pairing.py).
"""

from __future__ import annotations

import copy
import os

import numpy as np

from bwa_tpu_torch.index.pack import NT4_TABLE
from bwa_tpu_torch.mem import chain as chain_mod
from bwa_tpu_torch.mem.extend import chain2aln
from bwa_tpu_torch.mem.primary import (mark_primary_se, reorder_primary5,
                                       sort_dedup_patch)
from bwa_tpu_torch.mem.sam import reg2sam
from bwa_tpu_torch.mem.seeding import collect_intv
from bwa_tpu_torch.mem.types import MemAlnReg, Read
from bwa_tpu_torch.options import MEM_F_PE, MEM_F_PRIMARY5


def align1_core(opt, engine, fm, seq_codes: np.ndarray,
                mems=None) -> list[MemAlnReg]:
    """mem_align1_core (bwamem.c:1081-1117): one read -> alignment regions.
    mems may be precomputed by the batch seeder; engine provides .sa and
    .fetch_seq (and, when mems is None, the scalar seeding API)."""
    q = seq_codes
    if mems is None:
        mems = collect_intv(opt, engine, q)
    chains = chain_mod.chain(opt, engine, fm.bnt, q, mems)
    chains = chain_mod.chain_flt(opt, chains)
    chain_mod.flt_chained_seeds(opt, fm, q, chains)
    regs: list[MemAlnReg] = []
    for c in chains:
        chain2aln(opt, fm, q, c, regs)
    regs = sort_dedup_patch(opt, fm, q, regs)
    for p in regs:
        if p.rid >= 0 and fm.bnt.contigs[p.rid].is_alt:
            p.is_alt = 1
    return regs


def to_codes(seq: bytes) -> np.ndarray:
    return NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


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


def _batch_align(opt, engine, fm, codes):
    """worker1 over the batch: seeds (on the engine's device, batched),
    then per-read chaining and extension on the host.  An engine without
    collect_seeds seeds each read through its scalar API."""
    if not hasattr(engine, "collect_seeds"):
        return [align1_core(opt, engine, fm, c) for c in codes]
    from bwa_tpu_torch.mem.batch_seed import (CachedSeedEngine,
                                              collect_intv_batch,
                                              occurrence_positions)

    mems_list = collect_intv_batch(opt, engine, codes)
    caches = occurrence_positions(opt, engine, mems_list)
    return [align1_core(opt, CachedSeedEngine(fm, caches[i]), fm, codes[i],
                        mems=mems_list[i])
            for i in range(len(codes))]


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
    device/host seed extension on the C++ route; None chooses by
    use_device_ext.  The Python route (SE -5, BWA_TPU_FINALIZE other than
    "native") extends on the host, as bwa_tpu's does."""
    if not reads:
        return
    if os.environ.get("BWA_TPU_FINALIZE", "native") != "native" or (
            opt.flag & MEM_F_PRIMARY5 and not opt.flag & MEM_F_PE):
        _process_python(opt, engine, fm, reads, n_processed, pes0, rg_id)
        return
    from bwa_tpu_torch.mem.batch_seed import (collect_se_flat, host_reseed,
                                              occurrence_positions,
                                              se_flat_buckets, trip_order)
    from bwa_tpu_torch.mem.native_fin import (RefBlob, finalize_pe_arrays,
                                              finalize_se_arrays,
                                              flatten_tuple_seeds)

    def host_seeds(cd):
        """Exactness fallback for seed-cap overflow at every device cap:
        per-read seeding, flattened as the finalize takes it."""
        mems_list = [host_reseed(opt, engine, c) for c in cd]
        return flatten_tuple_seeds(
            opt, mems_list, occurrence_positions(opt, engine, mems_list))

    codes = to_codes_batch(reads)
    ext = engine.device if use_device_ext(opt, engine, codes, device_ext) \
        else None
    if not hasattr(fm, "_ref_blob"):
        fm._ref_blob = RefBlob(fm)
    # trip-sorted packing (batch_seed.trip_order): the reads seed in the
    # order of their predicted trips, so that packed lanes finish together
    order, qdev = trip_order(opt, engine, codes)
    if opt.flag & MEM_F_PE:
        # one finalize over the whole batch, in file order: the insert-size
        # estimate and the pair ids of hash_64 cover every pair
        flat = collect_se_flat(opt, engine, fm, codes, order=order,
                               qdev=qdev) or host_seeds(codes)
        sams = finalize_pe_arrays(opt, fm, fm._ref_blob, reads, codes, *flat,
                                  n_processed, pes0, rg_id, device_ext=ext)
        for r, s in zip(reads, sams):
            r.sam = s
        return
    # SE buckets finalize in seeding order; the SAM goes back to the file
    # order and hash_64 takes each read's index in the file
    src = codes if order is None else [codes[j] for j in order]
    for lo, nb, flat in se_flat_buckets(opt, engine, fm, src, row_ids=order,
                                        qdev=qdev):
        ix = (np.arange(lo, lo + nb, dtype=np.int64) if order is None
              else order[lo:lo + nb])
        rd = [reads[j] for j in ix]
        cd = [codes[j] for j in ix]
        sams = finalize_se_arrays(opt, fm, fm._ref_blob, rd, cd,
                                  *(flat or host_seeds(cd)), 0, rg_id,
                                  device_ext=ext, ids=n_processed + ix)
        for r, s in zip(rd, sams):
            r.sam = s


def _process_python(opt, engine, fm, reads, n_processed, pes0, rg_id):
    """process_seqs' Python route (bwamem.c:1235-1264 with worker2 in
    Python): batched device seeding, then per read (per pair under
    MEM_F_PE) primary marking, the -5 reorder and SAM."""
    codes = to_codes_batch(reads)
    regs = _batch_align(opt, engine, fm, codes)
    if opt.flag & MEM_F_PE:
        from bwa_tpu_torch.mem.pairing import pestat, sam_pe

        pes = pes0 if pes0 is not None else pestat(opt, fm.l_pac, regs)
        for i in range(len(reads) >> 1):
            sam_pe(opt, fm, pes, (n_processed >> 1) + i,
                   reads[i * 2:i * 2 + 2], codes[i * 2:i * 2 + 2],
                   regs[i * 2:i * 2 + 2], rg_id)
        return
    for i, r in enumerate(reads):
        mark_primary_se(opt, regs[i], n_processed + i)
        if opt.flag & MEM_F_PRIMARY5:
            reorder_primary5(opt.T, regs[i])
        r.sam = reg2sam(opt, fm, r, codes[i], regs[i], 0, None, rg_id)
