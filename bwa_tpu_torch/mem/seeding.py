"""Seed collection: the 3-pass SMEM strategy of mem_collect_intv
(bwamem.c:140-188), over an abstract FM engine (host scalar or batched
device)."""

from __future__ import annotations

from bwa_tpu_torch.mem.ksort import ks_introsort


def collect_intv(opt, engine, q) -> list[tuple]:
    """Returns list of intervals (x0, x1, x2, info), sorted by info with
    the reference's exact (unstable) sort."""
    length = len(q)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    mems: list[tuple] = []

    # pass 1: all SMEMs with start_width=1
    x = 0
    while x < length:
        if q[x] < 4:
            x, batch = engine.smem1a(q, x, 1, 0)
            for iv in batch:
                slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
                if slen >= opt.min_seed_len:
                    mems.append(iv)
        else:
            x += 1

    # pass 2: re-seed long unique SMEMs from their midpoint
    old_n = len(mems)
    for k in range(old_n):
        iv = mems[k]
        start, end = iv[3] >> 32, iv[3] & 0xFFFFFFFF
        if end - start < split_len or iv[2] > opt.split_width:
            continue
        _, batch = engine.smem1a(q, (start + end) >> 1, iv[2] + 1, 0)
        for jv in batch:
            if (jv[3] & 0xFFFFFFFF) - (jv[3] >> 32) >= opt.min_seed_len:
                mems.append(jv)

    # pass 3: LAST-like seeding (bwamem.c:170-185)
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = engine.seed_strategy1(q, x, opt.min_seed_len,
                                             opt.max_mem_intv)
                if m is not None and m[2] > 0:
                    mems.append(m)
            else:
                x += 1

    ks_introsort(mems, lambda a, b: a[3] < b[3])
    return mems
