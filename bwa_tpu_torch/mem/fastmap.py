"""`fastmap` — SMEM dumper, line-compatible with the reference
(main_fastmap, fastmap.c:408-483).  The minimal end-to-end slice of the
FM-index service: SMEM generation + SA lookup + coordinate mapping.
"""

from __future__ import annotations

import numpy as np

from bwa_tpu_torch.index.fmindex import FMIndex
from bwa_tpu_torch.index.pack import NT4_TABLE


def smem_iter(engine, q: np.ndarray, min_intv: int = 1, max_intv: int = 0,
              max_len: int = 2**31 - 1):
    """Yield SMEM batches like smem_next (bwamem_extra.c:86-96).

    engine: an object with .smem1a(q, x, min_intv, max_intv) — HostFM or the
    batched engine, whose scalar API is HostFM's.
    """
    start, length = 0, len(q)
    while True:
        while start < length and q[start] > 3:
            start += 1
        if start >= length:
            return
        start, mems = engine.smem1a(q, start, min_intv, max_intv)
        yield mems


def fastmap_batch(fm: FMIndex, engine, reads, min_iwidth: int = 20,
                  min_len: int = 17, print_seq: bool = False,
                  min_intv: int = 1, max_intv: int = 0):
    """Batched fastmap: one seeding-machine run (kernel K1 on a CUDA
    engine) for a whole read chunk, one read a lane (pass 1 only —
    min_seed_len=1, an unreachable split_len, and max_mem_intv=0 make
    passes 2/3 no-ops), + one SA lookup for all printed occurrences.
    Falls back per read for non-default -i/-I and for seed-overflow
    reads (seed cap 64, then min(192, L + 2) on the overflowing lanes
    alone).  Yields output lines in reference order (fastmap.c:408-483:
    SMEM print order is (start, end)-sorted because successive smem_next
    calls emit strictly later starts)."""
    from types import SimpleNamespace

    reads = list(reads)
    if (min_intv != 1 or max_intv != 0
            or not hasattr(engine, "collect_seeds")):
        for r in reads:
            for line in fastmap_lines(fm, engine, r.name, r.seq,
                                      min_iwidth, min_len, print_seq,
                                      min_intv, max_intv):
                yield line
        return
    from bwa_tpu_torch.mem.batch_seed import (_lane_bucket, _len_bucket,
                                              _pad_reads)

    opt = SimpleNamespace(min_seed_len=1, split_factor=float(1 << 30),
                          split_width=0, max_mem_intv=0)
    codes = [NT4_TABLE[np.frombuffer(r.seq, dtype=np.uint8)] for r in reads]
    l_pac, seq_len = fm.l_pac, fm.seq_len
    offs = np.array([c.offset for c in fm.bnt.contigs], dtype=np.int64)
    bucket0 = _lane_bucket(_len_bucket(max((len(c) for c in codes),
                                           default=1)))
    for lo in range(0, len(codes), bucket0):
        chunk = codes[lo:lo + bucket0]
        nb = len(chunk)
        q, lens, L = _pad_reads(chunk)
        cap = np.full(nb, 64)
        out = engine.collect_seeds(q, lens, opt, 64)
        over = np.nonzero(out[5] > 64)[0]
        if over.size:
            cap[over] = min(192, L + 2)
            out = _merge_rows(out, over, engine.collect_seeds(
                q[over], lens[over], opt, int(cap[over[0]])))
        s0, s1, s2, ss, se, sn = out
        # batch every printed occurrence's SA rank in one lookup
        W = s0.shape[1]
        col = np.arange(W)[None, :]
        ok = (sn[:nb] <= cap)  # overflow rows go the per-read path
        m_all = (col < np.minimum(sn[:nb, None], W)) & ok[:, None]
        printed = m_all & ((se[:nb] - ss[:nb]) >= min_len)
        narrow = printed & (s2[:nb] <= min_iwidth)
        cnt = np.where(narrow, s2[:nb], 0).astype(np.int64)
        flat_cnt = cnt[narrow]
        k0 = s0[:nb][narrow].astype(np.int64)
        tot = int(flat_cnt.sum())
        csum = np.cumsum(flat_cnt)
        grp = np.repeat(np.arange(len(flat_cnt)), flat_cnt)
        within = np.arange(tot, dtype=np.int64) - np.repeat(
            csum - flat_cnt, flat_cnt)
        pos = engine.sa_many(k0[grp] + within) if tot else np.zeros(
            0, np.int64)
        is_rev = pos >= l_pac
        pos_f = np.where(is_rev, seq_len - 1 - pos, pos)
        lens_per_occ = np.repeat(
            (se[:nb][narrow] - ss[:nb][narrow]).astype(np.int64), flat_cnt)
        pos_f = np.where(is_rev, pos_f - (lens_per_occ - 1), pos_f)
        rid = np.searchsorted(offs, pos_f, side="right") - 1
        occ_off = np.zeros(len(flat_cnt) + 1, np.int64)
        occ_off[1:] = csum
        names = [c.name for c in fm.bnt.contigs]
        coffs = offs
        oi = 0  # index into the narrow-EM stream
        for b in range(nb):
            r = reads[lo + b]
            if sn[b] > cap[b]:  # overflow: exact per-read fallback
                for line in fastmap_lines(fm, engine, r.name, r.seq,
                                          min_iwidth, min_len, print_seq,
                                          min_intv, max_intv):
                    yield line
                continue
            if print_seq:
                yield f"SQ\t{r.name}\t{len(r.seq)}\t{r.seq.decode()}"
            else:
                yield f"SQ\t{r.name}\t{len(r.seq)}"
            for j in range(int(min(sn[b], W))):
                if not printed[b, j]:
                    continue
                line = f"EM\t{ss[b, j]}\t{se[b, j]}\t{s2[b, j]}"
                if narrow[b, j]:
                    a, z = occ_off[oi], occ_off[oi + 1]
                    oi += 1
                    for t in range(a, z):
                        strand = "-" if is_rev[t] else "+"
                        line += (f"\t{names[rid[t]]}:{strand}"
                                 f"{pos_f[t] - coffs[rid[t]] + 1}")
                else:
                    line += "\t*"
                yield line
            yield "//"


def _merge_rows(out, rows, sub):
    """A collect_seeds result `out` with its lanes `rows` replaced by the
    rerun `sub` of those lanes, the seed rows padded to the wider (no
    column past a lane's seed_n is read)."""
    W = max(out[0].shape[1], sub[0].shape[1])
    merged = [np.pad(a, ((0, 0), (0, W - a.shape[1]))) for a in out[:5]]
    for m, a in zip(merged, sub[:5]):
        m[rows, :a.shape[1]] = a
    sn = out[5].copy()
    sn[rows] = sub[5]
    return (*merged, sn)


def fastmap_lines(fm: FMIndex, engine, name: str, seq: bytes,
                  min_iwidth: int = 20, min_len: int = 17, print_seq: bool = False,
                  min_intv: int = 1, max_intv: int = 0) -> list[str]:
    out = []
    if print_seq:
        out.append(f"SQ\t{name}\t{len(seq)}\t{seq.decode()}")
    else:
        out.append(f"SQ\t{name}\t{len(seq)}")
    q = NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]
    for mems in smem_iter(engine, q, min_intv, max_intv):
        for (x0, x1, x2, info) in mems:
            start, end = info >> 32, info & 0xFFFFFFFF
            if end - start < min_len:
                continue
            line = f"EM\t{start}\t{end}\t{x2}"
            if x2 <= min_iwidth:
                for k in range(x2):
                    length = end - start
                    pos = engine.sa(x0 + k)
                    pos_f, is_rev = fm.bnt.depos(pos)
                    if is_rev:
                        pos_f -= length - 1
                    rid = fm.bnt.pos2rid(pos_f)
                    strand = "-" if is_rev else "+"
                    line += (f"\t{fm.bnt.contigs[rid].name}:{strand}"
                             f"{pos_f - fm.bnt.contigs[rid].offset + 1}")
            else:
                line += "\t*"
            out.append(line)
    out.append("//")
    return out
