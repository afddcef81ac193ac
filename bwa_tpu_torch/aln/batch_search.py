"""Device-batched `bwa aln` search driver (BWA_TPU_ALN=device).

Feeds chunks of reads through ops/gap_machine.gap_machine (bwt_match_gap,
bwtgap.c:109-264: kernel K7 on a CUDA engine, its plain version on a CPU
engine) and returns the exact per-read alignment records the .sai writer
needs, in the reference's order.  Lanes whose stack/result buffers
overflow the device caps climb a retry ladder (cap 1024 -> 8192 -> 65536)
and finally fall back to the host executable spec (aln/search.py), so
every read's result is exact however pathological its search tree is.  A
rung reruns only the lanes that overflowed the one before it.  On an
engine with a mesh (parallel/mesh.py), a rung whose lane count the mesh's
size divides splits its lanes over the shards (gap_machine_sharded), K7
running once a shard on its device's tree; K7w runs once a chunk on the
engine's first device, as in the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from bwa_tpu_torch.aln.opts import (BWA_AVG_ERR, BWA_MODE_GAPE,
                                    BWA_MODE_LOGGAP, BWA_MODE_NONSTOP,
                                    GapOpt, cal_maxdiff)
from bwa_tpu_torch.ops import gap_machine as gm

# stack caps of the retry ladder when BWA_TPU_ALN_CAPS is not set: taller
# than the JAX package's 64,128,256, since a cap costs K7 only scratch
# memory (gap_machine.slot_bytes a slot a lane; a pop costs the same at any
# depth), a lane that overflows reruns from its start, and every read that
# overflows the last rung falls back to the Python spec
CAPS = "1024,8192,65536"
# the most bytes of stack slots one launch allocates (lanes x cap x a
# slot's bytes): an eighth of an H100's 80 GB.  A rung with more lanes
# runs in several launches (32-byte slots: 1024: 327,680 lanes a launch,
# a whole 0x40000-read chunk; 8192: 40,960; 65536: 5,120)
SCRATCH_BYTES = 10 << 30


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _prep_chunk(pk, opt: GapOpt):
    """Per-read parameter arrays, replicating bwtaln.c:88-117: fnr-derived
    max_diff, the STICKY max_gapo clamp (local_opt lives outside the read
    loop), complemented search codes, and the seed-region window."""
    n = pk.n
    lens = pk.lens.astype(np.int64)
    L = _pow2(int(lens.max()) if n else 32, 32)
    if opt.fnr > 0.0:
        uniq, inv = np.unique(pk.lens, return_inverse=True)
        md = np.array([cal_maxdiff(int(x), BWA_AVG_ERR, opt.fnr)
                       for x in uniq], np.int32)[inv]
    else:
        md = np.full(n, opt.max_diff, np.int32)
    mg = np.minimum(np.minimum.accumulate(md) if n else md,
                    np.int32(opt.max_gapo)).astype(np.int32)
    # p->seq is the REVERSED trimmed read (seqio.BtSeq; bwtaln.c stores
    # reads reversed): gather codes_flat back-to-front per read
    orig = np.full((n, L), 4, np.uint8)
    pos = np.arange(L)[None, :]
    valid = pos < lens[:, None]
    flat_idx = np.where(valid,
                        pk.codes_off[:-1, None] + lens[:, None] - 1 - pos,
                        0)
    orig[valid] = pk.codes_flat[flat_idx[valid]]
    qc = np.where(orig > 3, 4, 3 - orig.astype(np.int32)).astype(np.uint8)
    SL = int(opt.seed_len)
    seed_en = pk.lens.astype(np.int64) > SL
    use_seed = bool(seed_en.any()) and SL < L
    if use_seed:
        swin = np.full((n, SL), 4, np.uint8)
        spos = np.arange(SL)[None, :]
        src = np.clip(lens[:, None] - SL + spos, 0, None)
        rows = np.broadcast_to(np.arange(n)[:, None], (n, SL))
        sel = seed_en[:, None] & (src < lens[:, None])
        swin[sel] = orig[rows[sel], src[sel]]
    else:
        swin = np.zeros((n, 1), np.uint8)
    if n:
        n_amb = (orig > 3).sum(axis=1, where=valid).astype(np.int32)
    else:
        n_amb = np.zeros(0, np.int32)
    skip = n_amb > md          # bwtgap.c:131-135: too many Ns -> no alns
    return L, md, mg, orig, qc, seed_en, use_seed, swin, skip


def _run_lanes(engine, opt: GapOpt, lanes, dq, wb0, sb, use_seed, cap,
               cap_a, max_steps, n_lists, idx=None, trees=None):
    """One gap machine launch over the lanes `lanes` (indices into the
    chunk's device arrays dq) on the tree idx (the engine's by default),
    or with trees (device -> tree) one a shard of the engine's mesh, the
    lanes split in order; returns (rows, n_aln, ovf): rows [tot, 8] int64
    on the host, the records of every lane that did not overflow, lane by
    lane in lane order."""
    dev = engine.device
    li = torch.as_tensor(lanes, device=dev)
    scal = tuple(int(getattr(opt, k)) for k in gm.SCALARS)
    flags = dict(cap=cap, cap_a=cap_a, use_seed=use_seed,
                 f_gape=bool(opt.mode & BWA_MODE_GAPE),
                 f_nonstop=bool(opt.mode & BWA_MODE_NONSTOP),
                 f_loggap=bool(opt.mode & BWA_MODE_LOGGAP))
    args = (dq["qc"][li], dq["lens"][li], dq["md"][li], dq["mg"][li],
            dq["seed_en"][li], sb[li], wb0[li],
            torch.ones(len(lanes), dtype=torch.bool, device=dev), scal)
    if trees is not None:
        from bwa_tpu_torch.parallel.mesh import gap_machine_sharded

        out = gap_machine_sharded(engine.mesh, **flags)(
            trees, *args, max_steps=max_steps, n_lists=n_lists)
    else:
        out = gm.gap_machine(engine.idx if idx is None else idx, *args,
                             max_steps=max_steps, n_lists=n_lists, **flags)
    meta = torch.stack([out["n_aln"], out["ovf"].to(torch.int32)]).cpu() \
        .numpy()
    n_aln, ovf = meta[0], meta[1] != 0
    keep = (torch.arange(cap_a, device=dev)[None, :]
            < out["n_aln"][:, None]) & ~out["ovf"][:, None]
    rows = torch.cat([out["aln_m"].to(torch.int64),
                      out["aln_kl"].to(torch.int64)], dim=2)[keep]
    return rows.cpu().numpy(), n_aln, ovf


def _host_fallback(engine, opt: GapOpt, orig_row, qlen, md_i, mg_i):
    """Exactness fallback: the executable spec (aln/search.py) on one
    read, with the chunk-precomputed local opt values."""
    from bwa_tpu_torch.aln.search import cal_width, match_gap

    local = GapOpt(**{k: getattr(opt, k)
                      for k in opt.__dataclass_fields__})
    local.max_diff = int(md_i)
    local.max_gapo = int(mg_i)
    seq = orig_row[:qlen]
    local.seed_len = opt.seed_len if opt.seed_len < qlen else 0x7FFFFFFF
    host = engine.host if hasattr(engine, "host") else engine
    w = cal_width(host, seq)
    seed_w = None
    if qlen > opt.seed_len:
        seed_w = cal_width(host, seq[qlen - opt.seed_len:])
    q = np.where(seq > 3, 4, 3 - seq.astype(np.int32)).astype(np.uint8)
    return match_gap(host, q, w, seed_w, local)


def search_tree(engine, fm, device=None):
    """The index tree K7 and K7w read on a CUDA engine: the engine's (on a
    mesh, its tree on `device`), with an occtab of R = 1 rows (8 text
    words) where the engine's is re-tiled R = 4 (genomes past 2^16
    blocks, for the seeding kernel).  A lookup then reads 48 bytes, not
    144, and a group of 2 threads (not 8) makes it, so a warp carries 16
    searches (PERF.md §6).  Built once an engine and device; a CPU
    engine's tree is its own."""
    from bwa_tpu_torch.index.fmindex import _i32_bits, build_occtab

    idx = engine.idx if device is None else engine.trees[device]
    occ = idx.get("occtab")
    if occ is None or not occ.is_cuda or occ.shape[1] == 12:
        return idx
    trees = engine.__dict__.setdefault("k7_trees", {})
    tree = trees.get(occ.device)
    if tree is None:
        occ1 = build_occtab(fm, 1)
        if occ1 is None:
            return idx
        tree = dict(idx, occtab=torch.from_numpy(_i32_bits(occ1))
                    .to(occ.device))
        trees[occ.device] = tree
    return tree


def aln_batch_device(fm, engine, pk, opt: GapOpt):
    """bt_aln_batch's device twin: (out_n, rows) for SaiWriter.
    rows: [tot, 8] int64 = (n_mm, n_gapo, n_gape, score, n_ins, n_del,
    k, l) per alignment, reference order.  BWA_TPU_ALN_LANES, when set,
    cuts the chunk into buckets of that many reads; a rung's launches are
    cut to SCRATCH_BYTES, a device's budget: on a mesh, each launch gives
    every shard that many lanes."""
    n = pk.n
    idx = search_tree(engine, fm)
    mesh = getattr(engine, "mesh", None)
    trees = None if mesh is None else {
        d: search_tree(engine, fm, d) for d in mesh.distinct()}
    dev = engine.device
    cdt = idx["cdt"]
    L, md, mg, orig, qc, seed_en, use_seed, swin, skip = \
        _prep_chunk(pk, opt)
    B = int(os.environ.get("BWA_TPU_ALN_LANES", "0")) or max(n, 1)
    cap_a0 = int(os.environ.get("BWA_TPU_ALN_CAPA", "32"))
    caps = [int(c) for c in
            os.environ.get("BWA_TPU_ALN_CAPS", CAPS).split(",")]
    max_steps = int(os.environ.get("BWA_TPU_ALN_MAX_STEPS", "200000"))
    scal = tuple(int(getattr(opt, k)) for k in gm.SCALARS)
    lens32 = pk.lens.astype(np.int32)
    # every read's records, in parts: the reads they belong to and the rows
    out_n = np.zeros(n, np.int32)
    part_ids: list = []
    part_rows: list = []
    for lo in range(0, n, B):
        nb = min(B, n - lo)
        sl_ = slice(lo, lo + nb)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a[sl_])).to(dev)

        dq = dict(qc=up(qc), lens=up(lens32), md=up(md), mg=up(mg),
                  seed_en=up(seed_en))
        n_lists = gm.score_lists(md[sl_].max(), mg[sl_].max(), scal)
        wb0 = gm.cal_width(idx, up(orig))
        if use_seed:
            sb = gm.cal_width(idx, up(swin))
        else:
            sb = torch.zeros((nb, 1, 2), dtype=cdt, device=dev)
        todo = ~skip[sl_]
        wide = gm.wide_records(L, md[sl_].max(), mg[sl_].max(), scal,
                               n_lists)
        for ci, cap in enumerate(caps):
            lanes = np.flatnonzero(todo)
            todo = np.zeros(nb, bool)
            per = max(1, SCRATCH_BYTES // (cap * gm.slot_bytes(cdt, wide)))
            # on a mesh: shard s takes the s-th block of the rung's lanes,
            # `per` of them a launch (a launch's lanes, shard by shard)
            k = 1 if trees is None or lanes.size % mesh.size else mesh.size
            blk = lanes.reshape(k, -1)
            for g in range(0, blk.shape[1], per):
                part = blk[:, g:g + per].reshape(-1)
                rows, n_aln, ovf = _run_lanes(
                    engine, opt, part, dq, wb0, sb, use_seed, cap,
                    cap_a0 * (1 << ci), max_steps, n_lists, idx,
                    trees if k > 1 else None)
                done = lo + part[~ovf]
                out_n[done] = n_aln[~ovf]
                part_ids.append(np.repeat(done, n_aln[~ovf]))
                part_rows.append(rows)
                todo[part[ovf]] = True
        back = np.flatnonzero(todo)
        for bi in back:
            alns = _host_fallback(engine, opt, orig[lo + bi],
                                  int(lens32[lo + bi]), md[lo + bi],
                                  mg[lo + bi])
            out_n[lo + bi] = len(alns)
            part_ids.append(np.full(len(alns), lo + bi))
            part_rows.append(np.array(
                [[a.n_mm, a.n_gapo, a.n_gape, a.score, a.n_ins, a.n_del,
                  a.k, a.l] for a in alns], np.int64).reshape(-1, 8))
        if back.size:
            print(f"[aln_batch_device] {back.size} reads fell back to the "
                  f"host search", file=sys.stderr)
    if not part_rows:
        return out_n, np.zeros((0, 8), np.int64)
    # read order; a read's records keep their order (a stable sort)
    order = np.argsort(np.concatenate(part_ids), kind="stable")
    return out_n, np.concatenate(part_rows)[order]
