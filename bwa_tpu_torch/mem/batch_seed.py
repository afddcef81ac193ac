"""Batch seeding: mem_collect_intv (bwamem.c:140-188) over a whole
read batch, with the seeding machine on the engine's device.

The host packs reads into machine lanes (pack_k=2 N-separated short reads
per lane, or one long read sharded over several lanes with provenance),
climbs a device cap ladder when a bucket overflows, demuxes the lanes back
to per-read flat seed arrays, and batches the occurrence SA lookups.
trip_order sorts a big batch's short reads by K8's predicted trips before
they are packed (their lanes then gathered on the device);
BWA_TPU_SEED_REFILL seeds short reads on K1's retire-and-refill lanes.
collect_intv_batch is the per-read form of the same seeding, one read a
lane, for the Python mem path (-5, BWA_TPU_FINALIZE=python).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from bwa_tpu_torch import tracing

# Lanes per machine call.  The sizes are the JAX package's, where every
# shape was a separately compiled program (12288 lanes measured ~7% faster
# than 8192 on its TPU headline); K1 takes any shape, and keeping the
# sizes makes both packages build the same lanes, which the tests compare.
BATCH_BUCKET = 12288
MAX_SHARDS = 8  # lanes one long read is sharded over, at most


def _lane_bucket(L: int, nb: int | None = None) -> int:
    """Lanes per machine call: long reads carry many more steps per lane
    and wider q streams, so shrink the lane count with read length; a
    sub-bucket batch also shrinks to the next power of two."""
    if L <= 256:
        b = BATCH_BUCKET
    elif L <= 512:
        b = BATCH_BUCKET // 2
    elif L <= 1024:
        b = BATCH_BUCKET // 4
    else:
        b = BATCH_BUCKET // 8
    if nb is not None and nb < b:
        b = max(256, 1 << (nb - 1).bit_length())
    return b


def _len_bucket(L: int) -> int:
    return max(64, -(-L // 64) * 64)


def _pad_reads(chunk) -> tuple[np.ndarray, np.ndarray, int]:
    """One read a lane (the layout of collect_intv_batch and fastmap),
    rows as wide as the 64-multiple of the longest read.  (The JAX
    package pads the lanes to a power of two, for its compiled shapes; K1
    takes any.)  Returns (q, lens, L)."""
    L = _len_bucket(max(len(c) for c in chunk))
    q = np.full((len(chunk), L), 4, dtype=np.uint8)
    lens = np.zeros(len(chunk), dtype=np.int32)
    for i, c in enumerate(chunk):
        q[i, : len(c)] = c
        lens[i] = len(c)
    return q, lens, L


def _cap_ladder(pack_k: int, width: int) -> list[tuple[int, int]]:
    """The device rungs (seed cap, stack cap) an overflowing lane climbs
    before any host fallback -- on a GRCh38-scale repeat genome the
    host-spec redo was 90% of the whole alignment wall time.  A long-read
    lane can hold more seeds than the reference's top rung (a 10 kb pacbio
    read sharded over two lanes finds ~800), and the host fallback
    re-seeds one read at a time: one more rung, as wide as the lane
    (`width` columns), comes first."""
    ladder = [(96 * pack_k, 32), (256 * pack_k, 64)]
    lane_cap = -(-width // 64) * 64
    if lane_cap > ladder[-1][0]:
        ladder.append((lane_cap, 64))
    return ladder


def _mems_of(out, b: int) -> list[tuple]:
    """Lane b's seeds of a collect_seeds result as (x0, x1, x2, info)."""
    s0, s1, s2, ss, se, sn = out[:6]
    return [(int(s0[b, j]), int(s1[b, j]), int(s2[b, j]),
             (int(ss[b, j]) << 32) | int(se[b, j]))
            for j in range(int(sn[b]))]


def host_reseed(opt, engine, codes) -> list[tuple]:
    """The scalar host spec's seeds of one read (mem/seeding.py), for a
    read that overflows every device rung."""
    from bwa_tpu_torch.mem.seeding import collect_intv

    return collect_intv(opt, engine.host, codes)


def collect_intv_batch(opt, engine, codes_list, cap_s: int = 96):
    """mem_collect_intv (bwamem.c:140-188) over a batch, one read a lane:
    the seeding machine runs on the engine's device (kernel K1 on a CUDA
    engine).  A read whose seeds overflow cap_s climbs the rungs of the
    device cap ladder (_cap_ladder) wider than cap_s on its own lane; one
    that overflows every rung is re-seeded by the host spec (host_reseed).
    The seeds are exact either way.  Returns per-read [(x0, x1, x2, info)] sorted by info."""
    B = len(codes_list)
    if B == 0:
        return []
    mems: list[list[tuple]] = []
    bucket0 = _lane_bucket(_len_bucket(max(len(c) for c in codes_list)))
    for lo in range(0, B, bucket0):
        chunk = codes_list[lo:lo + bucket0]
        q, lens, L = _pad_reads(chunk)
        out = engine.collect_seeds(q, lens, opt, cap_s)
        got = {b: _mems_of(out, b) for b in range(len(chunk))
               if out[5][b] <= cap_s}
        over = np.nonzero(out[5] > cap_s)[0]
        for cs2, sc2 in _cap_ladder(1, L):
            if not over.size:
                break
            if cs2 <= cap_s:  # no wider than the launch that overflowed
                continue
            out = engine.collect_seeds(q[over], lens[over], opt, cs2,
                                       stack_cap=sc2)
            ok = out[5] <= cs2
            got.update((int(b), _mems_of(out, i))
                       for i, b in enumerate(over) if ok[i])
            over = over[~ok]
        got.update((int(b), host_reseed(opt, engine, chunk[b]))
                   for b in over)
        mems += [got[b] for b in range(len(chunk))]
    return mems


def _pack_bucket(opt, chunk, cap_s: int):
    """Pack a bucket's reads pack_k per machine lane, separated by an
    ambiguous base: the state machine treats N as a hard boundary in
    every pass, so a packed lane behaves exactly like pack_k independent
    reads while per-lane step totals average out.

    Long reads invert the packing: one read SHARDED over n_shard lanes,
    each covering a slice of the start-cursor range (exact -- see
    ops/fm_machine.py::seed_machine_seg's lane-sharding note), so one
    long read's serial SMEM walk is split over several threads.
    Returns (q, lens, L, B2, pack_k, cs, shard, n_shard);
    shard is None when unsharded."""
    nb = len(chunk)
    L = _len_bucket(max(len(c) for c in chunk))
    pack_k = 2
    n_shard = 1
    if L > 256:
        pack_k = 1  # long reads carry enough work per lane already
        n_shard = max(1, min(MAX_SHARDS, _lane_bucket(L) // max(nb, 1)))
    bucket = _lane_bucket(L, nb * n_shard)
    if nb < bucket // (2 * n_shard):
        pack_k = 1
    if n_shard > 1:
        B2 = bucket
        q = np.full((B2, L), 4, np.uint8)
        lens = np.zeros(B2, np.int32)
        job_lo = np.zeros(B2, np.int32)
        hi1 = np.zeros(B2, np.int32)
        hi3 = np.zeros(B2, np.int32)
        for r, c in enumerate(chunk):
            ln = len(c)
            step = -(-ln // n_shard)
            for s in range(n_shard):
                lane = r * n_shard + s
                q[lane, :ln] = c
                lens[lane] = ln
                job_lo[lane] = min(s * step, ln)
                hi1[lane] = min((s + 1) * step, ln) if s < n_shard - 1 \
                    else ln
                hi3[lane] = ln if s == 0 else 0
        return q, lens, L, B2, pack_k, cap_s, (job_lo, hi1, hi3), n_shard
    B2 = bucket // pack_k
    Lp = pack_k * (L + 1)
    q = np.full((B2, Lp), 4, np.uint8)
    lens = np.zeros(B2, np.int32)
    for r in range(pack_k):
        for i in range(B2):
            ridx = r * B2 + i
            if ridx < nb:
                c = chunk[ridx]
                q[i, r * (L + 1):r * (L + 1) + len(c)] = c
                lens[i] = r * (L + 1) + len(c)
    return q, lens, L, B2, pack_k, cap_s * pack_k, None, 1


def _demux_bucket(opt, sa_lookup, seeds_out, nb, L, B2, cs, n_shard=1):
    """Demux packed lanes back to per-read flat arrays (bucket-local
    offsets).  Rows are sorted by start within a lane, so a stable sort
    by read id keeps order.  SA lookups go through sa_lookup
    (_sa_route: the dense sidecar on small genomes, at scale K9 on a CUDA
    engine, else the native batch walker).

    Sharded long-read lanes (n_shard > 1) instead re-sort per read by
    (start, end, tag) and drop the cross-lane duplicates: rows equal in
    (read, start, end, provenance tag) are the same SMEM found from two
    shards' ranges; duplicates the reference itself produces differ in
    tag and are kept (ties of (start, end) denote the same interval, so
    any tie order is output-equivalent — ks_introsort on .info is
    unstable too)."""
    if n_shard > 1:
        s0, s1, s2, ss, se, sn, tg = seeds_out
        sn_l = sn.astype(np.int64)
        lmask = np.arange(s0.shape[1])[None, :] < sn_l[:, None]
        lane_id = np.broadcast_to(np.arange(B2)[:, None], lmask.shape)[lmask]
        rid_all = lane_id // n_shard
        start_a = ss[lmask].astype(np.int64)
        end_a = se[lmask].astype(np.int64)
        tag_a = tg[lmask].astype(np.int64)
        order = np.lexsort((tag_a, end_a, start_a, rid_all))
        order = order[rid_all[order] < nb]
        key = np.stack([rid_all[order], start_a[order], end_a[order],
                        tag_a[order]], axis=1)
        dup = np.zeros(len(order), bool)
        if len(order) > 1:
            dup[1:] = (key[1:] == key[:-1]).all(axis=1)
        order = order[~dup]
        rid_sorted = rid_all[order]
        k0 = s0[lmask][order].astype(np.int64)
        x2 = s2[lmask][order].astype(np.int64)
        start = start_a[order].astype(np.int32)
        end = end_a[order].astype(np.int32)
    else:
        s0, s1, s2, ss, se, sn = seeds_out
        sn_l = sn.astype(np.int64)
        # the seed arrays may come back narrower than cs (D2H width diet
        # slices to a bucketed max(sn)); mask by the actual width
        lmask = np.arange(s0.shape[1])[None, :] < sn_l[:, None]
        lane_id = np.broadcast_to(np.arange(B2)[:, None], lmask.shape)[lmask]
        start_p = ss[lmask].astype(np.int64)
        rslot = start_p // (L + 1)
        read_id = rslot * B2 + lane_id
        order = np.argsort(read_id, kind="stable")
        keep = read_id[order] < nb  # drop pad-lane rows
        order = order[keep]
        rid_sorted = read_id[order]
        k0 = s0[lmask][order].astype(np.int64)
        x2 = s2[lmask][order].astype(np.int64)
        off_p = (rslot * (L + 1))[order].astype(np.int64)
        start = (start_p[order] - off_p).astype(np.int32)
        end = (se[lmask].astype(np.int64)[order] - off_p).astype(np.int32)
    return _flat_seeds(opt, sa_lookup, rid_sorted, k0, x2, start, end, nb)


def _flat_seeds(opt, sa_lookup, rid, k0, x2, start, end, nb):
    """Per-read flat arrays from seed rows already in the reads' order
    (rid: each row's read): the occurrence SA rows of each seed
    (mem_chain's bwt_sa calls, bwamem.c:304-309) looked up in one batch
    through sa_lookup.  Returns (iv_off, x2, start, end, rbegs,
    rb_off), offsets local to the nb reads."""
    max_occ = opt.max_occ
    counts = np.where(x2 > max_occ, max_occ, x2)
    step = np.where(x2 > max_occ, x2 // max_occ, 1)
    tot = int(counts.sum())
    csum = np.cumsum(counts)
    grp = np.repeat(np.arange(len(counts)), counts)
    within = np.arange(tot, dtype=np.int64) - np.repeat(csum - counts, counts)
    rbegs = sa_lookup(k0[grp] + step[grp] * within)
    iv_off = np.zeros(nb + 1, np.int32)       # per READ
    iv_off[1:] = np.cumsum(np.bincount(rid, minlength=nb)[:nb])
    rb_off = np.zeros(len(counts) + 1, np.int32)  # per SEED
    rb_off[1:] = csum
    return (iv_off, x2, start, end, rbegs, rb_off)


def _demux_refill(opt, sa_lookup, seeds_out, nb):
    """Demux retire-and-refill lanes: the provenance column carries the
    read id, so one stable lexsort by (read, start, end) restores the
    static route's order of each read's seeds (a read lives in one lane,
    its rows leave the lane's sort_seeds in (start, end, emission) order,
    and the stable sort keeps that tie order)."""
    s0, s1, s2, ss, se, sn, tg = seeds_out
    lmask = np.arange(s0.shape[1])[None, :] < sn.astype(np.int64)[:, None]
    rid_all = tg[lmask].astype(np.int64)
    start_a = ss[lmask].astype(np.int64)
    end_a = se[lmask].astype(np.int64)
    order = np.lexsort((end_a, start_a, rid_all))
    return _flat_seeds(opt, sa_lookup, rid_all[order],
                       s0[lmask][order].astype(np.int64),
                       s2[lmask][order].astype(np.int64),
                       start_a[order].astype(np.int32),
                       end_a[order].astype(np.int32), nb)


def _sa_route(engine, fm):
    """The demux's SA lookup: fm.sa_lookup with the engine's walker on the
    card (K9 on a CUDA engine without the dense sidecar; None elsewhere)."""
    return functools.partial(fm.sa_lookup, card=engine.sa_card)


def _se_flat_refill(opt, engine, fm, codes_list, cap_s):
    """se_flat_buckets' retire-and-refill route (BWA_TPU_SEED_REFILL):
    chunks of BWA_TPU_REFILL_BUCKET reads (default 4 buckets' worth) feed
    a pool of lanes (the bucket's lane count, at most BWA_TPU_REFILL_LANES)
    that draw from a shared queue (engine.collect_seeds_refill).  The
    chunk climbs a ladder of 2x and 4x the seed store (stack caps 32, 64)
    when a lane overflows or the lanes filled before the queue drained;
    past it the chunk yields None (the per-read host route)."""
    B = len(codes_list)
    RB = int(os.environ.get("BWA_TPU_REFILL_BUCKET", str(4 * BATCH_BUCKET)))
    los = list(range(0, B, RB))
    pend = {}
    sa_lookup = _sa_route(engine, fm)

    def _dispatch(i):
        chunk = codes_list[los[i]:los[i] + RB]
        n = len(chunk)
        q, lens, L = _pad_reads(chunk)
        lanes = _lane_bucket(L, n)
        if os.environ.get("BWA_TPU_REFILL_LANES"):
            lanes = min(lanes, int(os.environ["BWA_TPU_REFILL_LANES"]))
        cs_tot = max(4 * cap_s, (-(-n // lanes) + 1) * cap_s)
        h = engine.collect_seeds_refill_dispatch(q, lens, opt, cs_tot,
                                                 cap_s, lanes)
        pend[i] = (h, n, q, lens, lanes, cs_tot)

    with tracing.span("seed.dispatch"):
        _dispatch(0)
    for i, lo in enumerate(los):
        tracing.count("seed", "buckets")
        if i + 1 < len(los):
            with tracing.span("seed.dispatch"):
                _dispatch(i + 1)
        h, n, q, lens, lanes, cs_tot = pend.pop(i)
        with tracing.span("seed.wait"):
            out, n_drawn = engine.collect_seeds_refill_wait(h)
        if (out[5] > cs_tot).any() or n_drawn < n:
            for mul, sc2 in ((2, 32), (4, 64)):
                cs_tot *= mul
                tracing.count("seed", "ladder_climbs")
                with tracing.span("seed.wait"):
                    out, n_drawn = engine.collect_seeds_refill(
                        q, lens, opt, cs_tot, cap_s, lanes, stack_cap=sc2)
                if not (out[5] > cs_tot).any() and n_drawn == n:
                    break
            else:
                tracing.count("seed", "host_fallbacks")
                yield lo, n, None  # exactness fallback (tuple path)
                continue
        with tracing.span("seed.demux"):
            flat = _demux_refill(opt, sa_lookup, out, n)
        yield lo, n, flat


def trip_order(opt, engine, codes_list):
    """Trip-sorted antithetic bucket packing (the kt_for work-stealing
    analog, kthread.c:25-61): the seeding machine runs every lane to its
    bucket's slowest one, so reads are ordered by K8's predicted trips
    (engine.probe_trips) and each bucket arranged so that _pack_bucket's
    pairing (slot 0 = chunk[i], slot 1 = chunk[B2 + i]) puts rank j beside
    rank nb - 1 - j, which evens the lanes' sums; with more than one
    bucket the sorted ranks are dealt round-robin over the buckets first,
    so that each holds an even mix.

    BWA_TPU_TRIP_SORT: off; force; auto (the default), which sorts only
    batches of 4,096 reads or more on genomes of 200 Mbp or more (below
    that the serial probe costs more than it saves).  Reads over 256 bp
    (lane-sharded) and engines on a mesh are never sorted.  Returns
    (order, qdev): a [B] permutation (position -> original read) and the
    batch's read matrix on the engine's device, which se_flat_buckets
    gathers the sorted lanes from; or (None, None).  Each read's seeds do
    not depend on its lane, so the output bytes never depend on it;
    callers keep the original read ids for hash_64."""
    mode = os.environ.get("BWA_TPU_TRIP_SORT", "auto")
    if mode == "off" or not hasattr(engine, "probe_trips"):
        return None, None
    if getattr(engine, "mesh", None) is not None:
        return None, None
    B = len(codes_list)
    if mode != "force" and B < 4096:
        return None, None
    if mode == "auto" and getattr(engine, "fm", None) is not None \
            and engine.fm.l_pac < 200_000_000:
        return None, None
    L = _len_bucket(max(len(c) for c in codes_list))
    if L > 256:
        return None, None
    with tracing.span("seed.trip_order"):
        with tracing.span("seed.probe"):
            pred, qdev = engine.probe_trips(codes_list)
        return _trip_perm(pred, L), qdev


def _trip_perm(pred, L):
    """trip_order's permutation of the reads from their predicted trips
    (L: the reads' padded length)."""
    B = len(pred)
    perm = np.argsort(pred, kind="stable").astype(np.int64)
    bucket0 = _lane_bucket(L)
    nbk = (B + bucket0 - 1) // bucket0
    if nbk > 1:
        sizes = [min(bucket0, B - b * bucket0) for b in range(nbk)]
        assign = [[] for _ in range(nbk)]
        bi = 0
        for r in range(B):
            while len(assign[bi]) >= sizes[bi]:
                bi = (bi + 1) % nbk
            assign[bi].append(perm[r])
            bi = (bi + 1) % nbk
        perm = np.concatenate([np.asarray(a, np.int64) for a in assign])
    out = np.empty(B, np.int64)
    for lo in range(0, B, bucket0):
        s = perm[lo:lo + bucket0]
        nb = len(s)
        bucket = _lane_bucket(L, nb)
        if nb >= bucket // 2:  # pack_k = 2, as _pack_bucket picks it
            B2 = bucket // 2
            n1 = min(B2, nb)
            out[lo:lo + n1] = s[:n1]
            if nb > B2:
                # slot-1 positions B2..nb-1 get ranks nb-1 down to B2
                out[lo + B2:lo + nb] = s[nb - 1:B2 - 1:-1]
        else:
            out[lo:lo + nb] = s
    return out


def se_flat_buckets(opt, engine, fm, codes_list, cap_s: int = 24,
                    row_ids=None, qdev=None):
    """Generator yielding (lo, nb, flat | None) per bucket, with the NEXT
    bucket's device seeding dispatched before this bucket's host demux —
    the kt_pipeline analog (kthread.c:119-147): the device seeds bucket k+1
    while the host demuxes/finalizes bucket k.  flat arrays use
    bucket-local offsets; None = exactness fallback (seed-cap overflow
    even at the roomy retry cap) — redo that bucket via the tuple path.

    row_ids, qdev: trip_order's permutation and read matrix (each entry's
    row of qdev).  Given them, a bucket of pack_k = 2 lanes is gathered
    from qdev on the device (collect_seeds_dispatch_gather) instead of
    packed and uploaded.  BWA_TPU_SEED_REFILL routes reads of 256 bp or
    less through _se_flat_refill.  The split and compaction routes
    (ops/fm.py::seed_route) pack every bucket on the host and seed it with
    the synchronous engine.collect_seeds, as bwa_tpu's do; lane-sharded
    long reads raise ValueError there, where bwa_tpu's demux fails."""
    B = len(codes_list)
    if B == 0:
        return
    Lg = _len_bucket(max(len(c) for c in codes_list))
    if (os.environ.get("BWA_TPU_SEED_REFILL") and Lg <= 256
            and hasattr(engine, "collect_seeds_refill_dispatch")
            and getattr(engine, "mesh", None) is None):
        yield from _se_flat_refill(opt, engine, fm, codes_list, cap_s)
        return
    from bwa_tpu_torch.ops.fm import ROUTE_SWITCH, seed_route

    # the split and compaction routes are synchronous (engine.collect_seeds)
    # and pack every bucket on the host, as bwa_tpu's se_flat_buckets
    route = seed_route()
    can_async = route == "unified"
    sa_lookup = _sa_route(engine, fm)
    bucket0 = _lane_bucket(Lg)
    los = list(range(0, B, bucket0))
    packed = {}

    def _dispatch(idx):
        lo = los[idx]
        chunk = codes_list[lo:lo + bucket0]
        nb = len(chunk)
        B2 = _lane_bucket(Lg, nb) // 2
        if qdev is not None and can_async and nb >= B2:  # pack_k = 2
            rid = np.asarray(row_ids[lo:lo + nb], np.int64)
            pb = np.full(B2, -1, np.int64)
            pb[:nb - B2] = rid[B2:nb]
            qlen = np.array([len(c) for c in chunk[:B2]], np.int32)
            qlen[:nb - B2] = (Lg + 1) + np.array(
                [len(c) for c in chunk[B2:nb]], np.int32)
            h = engine.collect_seeds_dispatch_gather(qdev, rid[:B2], pb,
                                                     qlen, opt, 2 * cap_s)
            # the host lanes are built only if the bucket climbs the ladder
            packed[idx] = (None, None, Lg, B2, 2, 2 * cap_s, None, 1, h, nb,
                           chunk)
            return
        q, lens, L, B2, pack_k, cs, shard, ns = _pack_bucket(opt, chunk,
                                                             cap_s)
        if shard is not None and not can_async:
            raise ValueError(
                f"the {route} seeding route ({ROUTE_SWITCH[route]}) does not "
                f"run lane-sharded long reads: its seed store has no "
                f"provenance column, which their demux needs (bwa_tpu's "
                f"_demux_bucket fails on these lanes too)")
        h = engine.collect_seeds_dispatch(q, lens, opt, cs, shard=shard) \
            if can_async else None
        packed[idx] = (q, lens, L, B2, pack_k, cs, shard, ns, h, nb, chunk)

    with tracing.span("seed.dispatch"):
        _dispatch(0)
    for idx, lo in enumerate(los):
        tracing.count("seed", "buckets")
        if idx + 1 < len(los):
            with tracing.span("seed.dispatch"):
                _dispatch(idx + 1)  # next bucket's seeding in flight
        q, lens, L, B2, pack_k, cs, shard, ns, h, nb, chunk = \
            packed.pop(idx)
        with tracing.span("seed.wait"):
            out = engine.collect_seeds_wait(h) if h is not None \
                else engine.collect_seeds(q, lens, opt, cs, shard=shard)
        if (out[5] > cs).any():
            # seed-rich / deep-stack bucket (repeat regions): the whole
            # bucket climbs the device cap ladder
            if q is None:  # a gathered bucket: build its host lanes
                q, lens, L, B2, pack_k, cs, shard, ns = _pack_bucket(
                    opt, chunk, cap_s)
            for cs2, sc2 in _cap_ladder(pack_k, q.shape[1]):
                cs = cs2
                tracing.count("seed", "ladder_climbs")
                with tracing.span("seed.wait"):
                    out = engine.collect_seeds(q, lens, opt, cs2,
                                               stack_cap=sc2, shard=shard)
                if not (out[5] > cs2).any():
                    break
            else:
                tracing.count("seed", "host_fallbacks")
                yield lo, nb, None  # exactness fallback (tuple path)
                continue
        with tracing.span("seed.demux"):
            flat = _demux_bucket(opt, sa_lookup, out, nb, L, B2, cs, ns)
        yield lo, nb, flat


def _reorder_flat(flat, order):
    """Gather the per-read segments of flat seed arrays made in the
    permuted order back into ORIGINAL read order (trip-sorted seeding,
    the PE finalize takes reads pairwise in file order)."""
    iv_off, x2, start, end, rbegs, rb_off = flat
    B = len(order)
    inv = np.empty(B, np.int64)
    inv[order] = np.arange(B)
    cnt_o = (iv_off[1:] - iv_off[:-1]).astype(np.int64)[inv]
    new_iv_off = np.zeros(B + 1, np.int32)
    new_iv_off[1:] = np.cumsum(cnt_o)
    tot = int(new_iv_off[-1])
    ramp = np.arange(tot, dtype=np.int64) - np.repeat(
        new_iv_off[:-1].astype(np.int64), cnt_o)
    g = np.repeat(iv_off[:-1].astype(np.int64)[inv], cnt_o) + ramp
    rb_cnt = (rb_off[1:] - rb_off[:-1]).astype(np.int64)[g]
    new_rb_off = np.zeros(tot + 1, np.int32)
    new_rb_off[1:] = np.cumsum(rb_cnt)
    rtot = int(new_rb_off[-1])
    rramp = np.arange(rtot, dtype=np.int64) - np.repeat(
        new_rb_off[:-1].astype(np.int64), rb_cnt)
    rg = np.repeat(rb_off[:-1].astype(np.int64)[g], rb_cnt) + rramp
    return (new_iv_off, x2[g], start[g], end[g], rbegs[rg], new_rb_off)


def collect_intv_batch_unfused(opt, engine, codes_list) -> list[list[tuple]]:
    """mem_collect_intv (bwamem.c:140-188) driven from the host, one device
    call a pass step: engine.smem_pass (bwt_smem1a a read; kernel K10a on a
    CUDA engine) until every read's cursor passes its end, one smem_pass
    over every pass-2 job, then engine.seed3_pass (K10b) for pass 3; each
    read's mems sorted by info with ks_introsort, as the reference does.
    A cross-check of the seeding machine: it shares none of its code.
    Returns per-read [(x0, x1, x2, info)]."""
    import torch

    from bwa_tpu_torch.mem.ksort import ks_introsort
    from bwa_tpu_torch.ops.fm import _skip_amb

    B = len(codes_list)
    if B == 0:
        return []
    L = max(len(c) for c in codes_list)
    cap = L + 2
    q = np.full((B, L), 4, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, c in enumerate(codes_list):
        q[i, :len(c)] = c
        lens[i] = len(c)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    mems: list[list[tuple]] = [[] for _ in range(B)]
    qt, lt = torch.from_numpy(q), torch.from_numpy(lens)

    def skip_amb(x):
        return _skip_amb(qt, lt, torch.from_numpy(x)).numpy()

    def take(b, out, t):
        """Call t's mems (reversed: the reference sorts them by start) of
        at least min_seed_len bases, onto read b's list."""
        m0, m1, m2, ms, me, mem_n = out[1:]
        for j in range(int(mem_n[t]) - 1, -1, -1):
            if int(me[t, j]) - int(ms[t, j]) >= opt.min_seed_len:
                mems[b].append((int(m0[t, j]), int(m1[t, j]), int(m2[t, j]),
                                (int(ms[t, j]) << 32) | int(me[t, j])))

    # ---- pass 1: every SMEM, each read's cursor advanced by ret ----
    x = np.zeros(B, dtype=np.int32)
    ones = np.ones(B, dtype=np.int64)
    while True:
        x = skip_amb(x)
        active = x < lens
        if not active.any():
            break
        out = engine.smem_pass(q, lens, x, ones, 0, active, cap)
        for b in np.nonzero(active)[0]:
            take(b, out, b)
        x = np.where(active, out[0], x).astype(np.int32)

    # ---- pass 2: re-seed long unique SMEMs from their midpoints ----
    jobs = [(b, ((iv[3] >> 32) + (iv[3] & 0xFFFFFFFF)) >> 1, iv[2] + 1)
            for b in range(B) for iv in list(mems[b])
            if (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32) >= split_len
            and iv[2] <= opt.split_width]
    if jobs:
        jb = np.array([j[0] for j in jobs], dtype=np.int32)
        out = engine.smem_pass(q[jb], lens[jb],
                               np.array([j[1] for j in jobs], np.int32),
                               np.array([j[2] for j in jobs], np.int64), 0,
                               np.ones(len(jobs), dtype=bool), cap)
        for t, b in enumerate(jb):
            take(b, out, t)

    # ---- pass 3: LAST-like seeding ----
    if opt.max_mem_intv > 0:
        x = np.zeros(B, dtype=np.int32)
        while True:
            x = skip_amb(x)
            active = x < lens
            if not active.any():
                break
            ret, found, r0, r1, r2, s0, s1 = engine.seed3_pass(
                q, lens, x, opt.min_seed_len, opt.max_mem_intv, active)
            for b in np.nonzero(active & found)[0]:
                if int(r2[b]) > 0:
                    mems[b].append((int(r0[b]), int(r1[b]), int(r2[b]),
                                    (int(s0[b]) << 32) | int(s1[b])))
            x = np.where(active, ret, x).astype(np.int32)

    for b in range(B):
        ks_introsort(mems[b], lambda a, c: a[3] < c[3])
    return mems


def occurrence_positions(opt, engine, mems_list):
    """For every read's intervals, the sampled occurrence SA rows and their
    reference positions (the bwt_sa calls of mem_chain, bwamem.c:304-309),
    batched flat across the batch.  Returns per-read {k: rbeg} dicts."""
    flat_ks = []
    owners = []
    for b, mems in enumerate(mems_list):
        for iv in mems:
            step = iv[2] // opt.max_occ if iv[2] > opt.max_occ else 1
            k = 0
            count = 0
            while k < iv[2] and count < opt.max_occ:
                flat_ks.append(iv[0] + k)
                owners.append(b)
                k += step
                count += 1
    if not flat_ks:
        return [dict() for _ in mems_list]
    ks = np.asarray(flat_ks, dtype=np.int64)
    pos = engine.sa_many(ks)
    caches = [dict() for _ in mems_list]
    for b, k, p in zip(owners, flat_ks, pos):
        caches[b][int(k)] = int(p)
    return caches


def collect_se_flat(opt, engine, fm, codes_list, cap_s: int = 24,
                    order=None, qdev=None):
    """Whole-batch flat seed arrays with batch-global offsets, for the PE
    finalize (one call over every read, in file order: its insert-size
    estimate and hash_64 ids cover the whole batch).  Built on
    se_flat_buckets, so it climbs the same cap ladder (lane-wide rung
    included); returns None if a bucket still overflows (the caller takes
    the tuple path).  order, qdev: what trip_order returned; the reads
    seed in that order and the arrays come back in file order."""
    if not codes_list:
        return None
    src = codes_list if order is None else [codes_list[j] for j in order]
    parts = []
    for _, _, flat in se_flat_buckets(opt, engine, fm, src, cap_s,
                                      row_ids=order, qdev=qdev):
        if flat is None:
            return None
        parts.append(flat)
    iv_off, rb_off = [np.zeros(1, np.int32)], [np.zeros(1, np.int32)]
    iv_base = rb_base = 0
    for o_iv, _, _, _, _, o_rb in parts:
        iv_off.append((iv_base + o_iv[1:]).astype(np.int32))
        rb_off.append((rb_base + o_rb[1:]).astype(np.int32))
        iv_base += int(o_iv[-1])
        rb_base += int(o_rb[-1])
    out = (np.concatenate(iv_off),
           *(np.concatenate([p[k] for p in parts]) for k in range(1, 5)),
           np.concatenate(rb_off))
    return out if order is None else _reorder_flat(out, order)


class CachedSeedEngine:
    """Per-read view consumed by the (host) chain stage: precomputed
    SA lookups + pass-through reference fetch."""

    def __init__(self, fm, sa_cache: dict):
        self.fm = fm
        self._sa = sa_cache

    def sa(self, k: int) -> int:
        return self._sa[int(k)]

    def fetch_seq(self, beg, mid, end):
        return self.fm.fetch_seq(beg, mid, end)
