"""Batched FM-index primitives (plain PyTorch) and the seeding engine.

  * _occ4: one gather of (checkpoint, text block) per position + SWAR
    popcounts on the 0x55555555-spaced match masks reproduces bwt_occ4
    (bwt.c:169-186) for a whole vector of positions.
  * _extend: two batched occ4 calls + prefix arithmetic = bwt_extend.
  * _occ1/_B0: single-base occ and BWT character (the SA walk's steps).

Bit patterns are uint32 held in int32 tensors (index/fmindex.py); they are
widened to int64 and masked before any shift or compare.  Coordinates are
int32 when 2*l_pac+2 < 2^31 and int64 otherwise.

BatchedFMEngine drives the seeding machine (ops/fm_machine.py) for
mem/batch_seed.py: a CUDA engine launches kernel K1, a CPU engine runs
its plain version; an engine on a mesh (parallel/mesh.py) splits each
batch's lanes over the mesh's devices.  Its collect_seeds also takes
bwa_tpu's other seeding routes (seed_route: the split route, K12, and
tail compaction, K13, on K1's state mode) and the fused cross-check
program (collect_intv_device, K11); smem_pass and seed3_pass run
bwt_smem1a and bwt_seed_strategy1 one read a lane (K10a, K10b), and
sa_batch bwt_sa (K9), all of them in csrc/smem_batch.cu beside their
plain versions here.  A CUDA engine without the dense SA sidecar takes
the SA lookup onto the card too (DeviceSA, K9, as FMIndex.sa_lookup's
card).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bwa_tpu_torch.index.fmindex import DeviceFMIndex, FMIndex

_M55 = 0x55555555
_MFF = 0xFFFFFFFF


def _u32(x):
    return x.to(torch.int64) & _MFF


def _popc32(x):
    """SWAR popcount of int64 tensors holding 32-bit values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MFF) >> 24


def _masks(kw, kb, nw: int):
    """Per-word keep masks for positions (word kw, base kb) of a block."""
    widx = torch.arange(nw, dtype=torch.int64, device=kw.device)
    nkeep = ((kw[:, None] - widx[None, :]) * 16 + kb[:, None] + 1).clamp(0, 16)
    shift = ((16 - nkeep) << 1).clamp(max=31)
    full = torch.full_like(shift, _MFF)
    return torch.where(nkeep > 0, (full << shift) & _MFF,
                       torch.zeros_like(shift))


def _occ_block(idx, kk):
    """The counts [N, 4] and text words [N, nw] (int64) of the block that
    holds each $-removed position kk, and nw: the fused occtab's row where
    the index has one (nw = 8R), else ckpt's and words' block (nw = 8)."""
    if "occtab" in idx:
        nw = idx["occtab"].shape[1] - 4          # 8R words per row
        rbits = (nw // 8).bit_length() - 1       # log2(R)
        row = idx["occtab"][kk >> (7 + rbits)]
        return _u32(row[:, :4]), _u32(row[:, 4:]), nw
    j = kk >> 7
    return idx["ckpt"][j].to(torch.int64), _u32(idx["words"][j]), 8


def _occ4(idx, k):
    """Counts of each base in B[0..k] inclusive; k: [N] coord ints.
    Handles k == -1 (zeros) and k == seq_len (L2 diffs) like bwt_occ4."""
    cdt = idx["cdt"]
    k = k.to(torch.int64)
    kk = k - (k >= idx["primary"]).to(torch.int64)
    kk_safe = kk.clamp(0, idx["seq_len"] - 1)
    base, blk, nw = _occ_block(idx, kk_safe)
    mask = _masks((kk_safe >> 4) & (nw - 1), kk_safe & 15, nw)
    w = blk & mask
    vm = mask & _M55
    hi = (w >> 1) & _M55
    lo = w & _M55
    c3 = _popc32(hi & lo)
    nhi = _popc32(hi)
    nlo = _popc32(lo)
    nv = _popc32(vm)
    cnt = torch.stack([nv - nhi - nlo + c3, nlo - c3, nhi - c3, c3], dim=-1)
    out = base + cnt.sum(dim=1)
    L2 = idx["L2"].to(torch.int64)
    L2d = (L2[1:5] - L2[0:4])[None, :]
    out = torch.where((k == idx["seq_len"])[:, None], L2d, out)
    out = torch.where((k == -1)[:, None], torch.zeros_like(out), out)
    return out.to(cdt)


def _extend(idx, x0, x1, x2, is_back: bool):
    """bwt_extend (bwt.c:262-275) batched; returns (ok0, ok1, ok2) each
    [N, 4] (indexed by extension base c)."""
    cdt = x0.dtype
    fwd = (x0 if is_back else x1).to(torch.int64)
    x2 = x2.to(torch.int64)
    tk = _occ4(idx, fwd - 1).to(torch.int64)
    tl = _occ4(idx, fwd - 1 + x2).to(torch.int64)
    ok_nb = idx["L2"][:4].to(torch.int64)[None, :] + 1 + tk
    ok_sz = tl - tk
    bk = (x1 if is_back else x0).to(torch.int64)
    span = ((fwd <= idx["primary"])
            & (fwd + x2 - 1 >= idx["primary"])).to(torch.int64)
    b3 = bk + span
    b2 = b3 + ok_sz[:, 3]
    b1 = b2 + ok_sz[:, 2]
    b0 = b1 + ok_sz[:, 1]
    bks = torch.stack([b0, b1, b2, b3], dim=-1)
    out = (ok_nb, bks, ok_sz) if is_back else (bks, ok_nb, ok_sz)
    return tuple(o.to(cdt) for o in out)


def _B0(idx, x):
    """BWT char at $-removed position x."""
    x = x.to(torch.int64)
    _, blk, nw = _occ_block(idx, x)
    word = blk.gather(1, ((x >> 4) & (nw - 1))[:, None])[:, 0]
    return ((word >> ((15 - (x & 15)) << 1)) & 3).to(torch.int32)


def _occ1(idx, k, c):
    """Single-base occ: count of base c in B[0..k] (bwt_occ semantics for
    k in [0, seq_len))."""
    cdt = idx["cdt"]
    k = k.to(torch.int64)
    c = c.to(torch.int64)
    kk = k - (k >= idx["primary"]).to(torch.int64)
    kk_safe = kk.clamp(0, idx["seq_len"] - 1)
    cnts, blk, nw = _occ_block(idx, kk_safe)
    base = cnts.gather(1, c[:, None])[:, 0]
    mask = _masks((kk_safe >> 4) & (nw - 1), kk_safe & 15, nw)
    w = blk & mask
    hi = (w >> 1) & _M55
    lo = w & _M55
    m55 = mask & _M55
    ca = c[:, None]
    sel_hi = torch.where((ca & 2) != 0, hi, ~hi & m55)
    sel_lo = torch.where((ca & 1) != 0, lo, ~lo & m55)
    out = base + _popc32(sel_hi & sel_lo).sum(dim=1)
    L2 = idx["L2"].to(torch.int64)
    out = torch.where(k == idx["seq_len"], L2[c + 1] - L2[c], out)
    out = torch.where(k == -1, torch.zeros_like(out), out)
    return out.to(cdt)


def _set_intv(idx, c):
    """bwt_set_intv for a vector of first bases c (clamped to [0,3])."""
    cc = c.to(torch.int64).clamp(0, 3)
    L2 = idx["L2"].to(torch.int64)
    cdt = idx["cdt"]
    return ((L2[cc] + 1).to(cdt), (L2[3 - cc] + 1).to(cdt),
            (L2[cc + 1] - L2[cc]).to(cdt))


def _pack_meta(seed_n, ovf, done_step, steps):
    """The machine's small outputs stacked into one [4, B] int32 so the
    host pulls them in a single transfer."""
    i32 = torch.int32
    st = torch.as_tensor(steps, device=seed_n.device).to(i32).reshape(-1)[:1]
    return torch.stack([seed_n.to(i32), ovf.to(i32), done_step.to(i32),
                        st.expand(seed_n.shape[0])])


def _next_valid_device(q, qlen):
    """nv[b, p] = min over p' >= p of (p' if q[b,p'] < 4 else L), capped
    at qlen; one extra column (p = L) holds L."""
    B, L = q.shape
    pos = torch.arange(L, dtype=torch.int32, device=q.device)[None, :]
    val = torch.where(q < 4, pos, torch.full_like(pos, L))
    suf = torch.flip(torch.cummin(torch.flip(val, [1]), dim=1).values, [1])
    nv = torch.cat([suf, torch.full((B, 1), L, dtype=torch.int32,
                                    device=q.device)], dim=1)
    return torch.minimum(nv, qlen.to(torch.int32)[:, None])


def _gather_pack(q_all, pa, pb):
    """The pack_k=2 lane layout built on the device from a batch-resident
    read matrix: lane i = q_all[pa[i]] | 4 | q_all[pb[i]] | 4, pb = -1
    giving an all-N slot 1 (the exact batch_seed._pack_bucket layout)."""
    sep = torch.full((pa.shape[0], 1), 4, dtype=q_all.dtype,
                     device=q_all.device)
    qb = q_all[pb.clamp(min=0)]
    qb = torch.where((pb >= 0)[:, None], qb, torch.full_like(qb, 4))
    return torch.cat([q_all[pa], sep, qb, sep], dim=1)


def _refill_table(q, qlen):
    """The retire-and-refill machine's per-read table: one int32 row a
    read = qlen | chars[L] | next-valid[L+1]."""
    nv = _next_valid_device(q, qlen)
    return torch.cat([qlen.to(torch.int32)[:, None], q.to(torch.int32), nv],
                     dim=1)


def _top_bits(bits):
    """The top `bits` bits of a 32-bit word (none for bits <= 0, all for
    bits >= 32), as int64."""
    b = bits.clamp(0, 32)
    return (_MFF << (32 - b)) & _MFF


def _quad_bits(words, c):
    """A thread's four words [N, G, 4] as glookup pairs them: bit 2f set
    where field f holds base c (eq) or a base above it (gt), word 2v in the
    even bits and word 2v + 1 in the odd bits.  Returns (e01, e23, g01,
    g23), each [N, G]."""
    w = _u32(words)
    c = c[:, None, None]
    x = ~(w ^ (c * 0x55555555)) & _MFF
    e = x & (x >> 1) & _M55
    gx, gy, gz = (torch.where(m, _MFF, 0) for m in (c < 2, c == 0, c == 2))
    g = (((w >> 1) & (gx | (w & gz))) | (w & gy)) & _M55
    return (e[..., 0] | (e[..., 1] << 1), e[..., 2] | (e[..., 3] << 1),
            g[..., 0] | (g[..., 1] << 1), g[..., 2] | (g[..., 3] << 1))


def _quad_count(q, bits, above):
    """Each thread's count of base c (low 16 bits) and, with above, of the
    bases above it (high 16 bits) among its first bits / 2 positions."""
    e01, e23, g01, g23 = q
    m01 = (_top_bits(bits) & _M55) | (_top_bits(bits - 32) & ~_M55 & _MFF)
    m23 = (_top_bits(bits - 64) & _M55) | (_top_bits(bits - 96) & ~_M55
                                            & _MFF)
    n = _popc32(e01 & m01) + _popc32(e23 & m23)
    if above:
        n = n | ((_popc32(g01 & m01) + _popc32(g23 & m23)) << 16)
    return n


def group_lookup(idx, k1, k2, c, above: bool = True):
    """glookup of csrc/seed_machine.cu (K8 and K1's refill mode) in plain
    PyTorch, the way the G = 2R threads of a group do it: thread g holds
    text words 4g..4g+3 of a row and loads them only where one of them lies
    at or below its end (a row that holds both ends is loaded once, for
    both); words not loaded count as zeros.  Each thread counts base c
    (and, with above, the bases above it) in its words up to each end, by
    top-bit masks and popcounts of two words a register; the group sums by
    shuffles.  k1, k2 [N] coordinates, c [N] bases.  Returns o1, o2 [N]
    (occ(k1)[c], occ(k2)[c]), ab [N] (the sum over c' > c of occ(k2)[c']
    - occ(k1)[c'], zeros without above) and loads [N, G, 2] (thread g
    loaded its words of k1's row, of k2's), all int64.  Nothing on the
    main path calls it; the tests hold it to _occ4."""
    i64 = torch.int64
    occ = idx["occtab"]
    nw = occ.shape[1] - 4
    G = nw // 4
    rb = (nw // 8).bit_length() - 1
    pr = 128 << rb
    seq_len, primary = idx["seq_len"], idx["primary"]
    L2 = idx["L2"].to(i64)
    k1, k2, c = k1.to(i64), k2.to(i64), c.to(i64)
    z1 = (k1 == -1) | (k1 == seq_len)
    z2 = (k2 == -1) | (k2 == seq_len)

    def pos(k):
        return (k - (k >= primary).to(i64)).clamp(0, seq_len - 1)

    kk1, kk2 = pos(k1), pos(k2)
    r1, r2 = kk1 >> (7 + rb), kk2 >> (7 + rb)
    same = (r1 == r2) & ~z1 & ~z2
    row1, row2 = occ[r1], occ[r2]
    g = torch.arange(G, device=k1.device)[None, :]
    b1 = 2 * ((kk1 & (pr - 1))[:, None] + 1 - 64 * g)
    b2 = 2 * ((kk2 & (pr - 1))[:, None] + 1 - 64 * g)
    ld1 = ~z1[:, None] & ((b1 > 0) | (same[:, None] & (b2 > 0)))
    ld2 = ~z2[:, None] & ~same[:, None] & (b2 > 0)
    w1 = torch.where(ld1[..., None], row1[:, 4:].reshape(-1, G, 4), 0)
    w2 = torch.where(ld2[..., None], row2[:, 4:].reshape(-1, G, 4), 0)
    q1 = _quad_bits(w1, c)
    # the group's sums (the shuffles)
    n1 = torch.where(z1, 0, _quad_count(q1, b1, above).sum(dim=1))
    n2 = torch.where(same, _quad_count(q1, b2, above).sum(dim=1),
                     torch.where(z2, 0, _quad_count(_quad_bits(w2, c), b2,
                                                    above).sum(dim=1)))
    cnt1 = torch.where(z1[:, None], 0, _u32(row1[:, :4]))
    cnt2 = torch.where(same[:, None], cnt1,
                       torch.where(z2[:, None], 0, _u32(row2[:, :4])))
    col = torch.arange(4, device=k1.device)[None, :]

    def of_c(cnt):
        return cnt.gather(1, c[:, None]).squeeze(1)

    def over_c(cnt):
        return (cnt * (col > c[:, None])).sum(dim=1)

    tot_c = L2[c + 1] - L2[c]
    tot_above = L2[4] - L2[c + 1]
    o1 = torch.where(k1 == seq_len, tot_c, of_c(cnt1) + (n1 & 0xFFFF))
    o2 = torch.where(k2 == seq_len, tot_c, of_c(cnt2) + (n2 & 0xFFFF))
    if above:
        a1 = torch.where(k1 == seq_len, tot_above, over_c(cnt1) + (n1 >> 16))
        a2 = torch.where(k2 == seq_len, tot_above, over_c(cnt2) + (n2 >> 16))
        ab = a2 - a1
    else:
        ab = torch.zeros_like(o1)
    return o1, o2, ab, torch.stack([ld1, ld2], dim=2)


def narrow_ends(idx, x1, x2):
    """Where K8 takes glookup_narrow (csrc/seed_machine.cu): a one-row
    interval (x2 == 1) whose ends k1 = x1 - 1 and k2 = x1 are neighbouring
    text positions of one occtab row (k2 neither the $ row nor seq_len)."""
    pr = 16 * (idx["occtab"].shape[1] - 4)
    primary, seq_len = idx["primary"], idx["seq_len"]
    kk2 = x1 - (x1 > primary).to(x1.dtype)
    return (x2 == 1) & (x1 != primary) & (x1 != seq_len) \
        & ((kk2 & (pr - 1)) != 0)


def group_lookup_narrow(idx, k1, c):
    """glookup_narrow of csrc/seed_machine.cu in plain PyTorch: for ends
    k1 and k1 + 1 that narrow_ends admits, the group counts base c up to
    k1 as group_lookup does and reads the code at k1 + 1 from the eq bits
    of the thread whose words hold it.  Returns o1 = occ(k1)[c] and
    sz = occ(k1 + 1)[c] - o1, [N] int64."""
    i64 = torch.int64
    occ = idx["occtab"]
    nw = occ.shape[1] - 4
    G = nw // 4
    rb = (nw // 8).bit_length() - 1
    pr = 128 << rb
    k1, c = k1.to(i64), c.to(i64)
    kk1 = k1 - (k1 >= idx["primary"]).to(i64)
    p1 = kk1 & (pr - 1)
    p2 = p1 + 1
    row = occ[kk1 >> (7 + rb)]
    g = torch.arange(G, device=k1.device)[None, :]
    b1 = 2 * (p1[:, None] + 1 - 64 * g)
    owner = (p2 >> 6)[:, None] == g
    w = torch.where(((b1 > 0) | owner)[..., None],
                    row[:, 4:].reshape(-1, G, 4), 0)
    q = _quad_bits(w, c)
    n = _quad_count(q, b1, False).sum(dim=1)
    u, f = ((p2 >> 4) & 3)[:, None], (p2 & 15)[:, None]
    bit = (torch.where(u < 2, q[0], q[1]) >> (2 * (15 - f) + (u & 1))) & 1
    o1 = _u32(row[:, :4]).gather(1, c[:, None]).squeeze(1) + n
    return o1, (bit * owner).sum(dim=1)


def probe_breaks_group(idx, q):
    """K8's loop (csrc/seed_machine.cu, probe_breaks_kernel) in plain
    PyTorch: a lookup (group_lookup, base 3 - c's count only, or
    group_lookup_narrow where every extending row's ends are neighbours,
    as a warp's are when all its reads' are) only where the interval
    extends, the reverse start never formed, 16 codes at a time with a run
    of no base only ending the interval.  Nothing on the
    main path calls it; the tests hold it to probe_breaks_plain."""
    B, L = q.shape
    i64 = torch.int64
    L2 = idx["L2"].to(i64)
    x1 = torch.ones(B, dtype=i64, device=q.device)
    x2 = torch.zeros(B, dtype=i64, device=q.device)
    started = torch.zeros(B, dtype=torch.bool, device=q.device)
    brk = torch.zeros(B, dtype=torch.int32, device=q.device)
    qpad = torch.full((B, -(-L // 16) * 16), 4, dtype=q.dtype,
                      device=q.device)
    qpad[:, :L] = q
    for x0 in range(0, qpad.shape[1], 16):
        chunk = qpad[:, x0:x0 + 16].to(i64)
        live = (chunk < 4).any(dim=1)
        started = started & live
        for t in range(16):
            c = chunk[:, t]
            good = live & (c < 4)
            ext = started & good
            restart = good.clone()
            e = ext.nonzero().flatten()
            if e.numel():
                ce = c[e]
                if bool(narrow_ends(idx, x1[e], x2[e]).all()):
                    o1, sz = group_lookup_narrow(idx, x1[e] - 1, 3 - ce)
                else:
                    o1, o2, _, _ = group_lookup(idx, x1[e] - 1,
                                                x1[e] - 1 + x2[e], 3 - ce,
                                                above=False)
                    sz = o2 - o1
                ok = sz >= 1
                brk[e[~ok]] += 1
                x1[e[ok]] = L2[3 - ce[ok]] + 1 + o1[ok]
                x2[e[ok]] = sz[ok]
                restart[e[ok]] = False
            cr = c.clamp(0, 3)
            x1 = torch.where(restart, L2[3 - cr] + 1, x1)
            x2 = torch.where(restart, L2[cr + 1] - L2[cr], x2)
            started = torch.where(live, good, started)
    return brk


# launches of kernel K8 (the CUDA wrapper of probe_breaks adds one a launch)
probe_launches = 0


def probe_breaks(idx, q, qlen):
    """[B] int32 break counts of kernel K8, the trip-count predictor of
    trip-sorted bucket packing (mem/batch_seed.py::trip_order): one
    forward interval scanned over x = 0..L-1, restarted where an extension
    fails; a read's machine trips follow its restart count (corr 0.97 in
    the JAX package's measurements).  A CUDA q launches K8
    (csrc/seed_machine.cu); a CPU q runs probe_breaks_plain.  qlen is not
    read: the pad codes (4) end an interval as an N does, and K8 passes a
    run of 16 codes with no base without a lookup."""
    if q.is_cuda:
        return _probe_breaks_cuda(idx, q)
    return probe_breaks_plain(idx, q, qlen)


def probe_breaks_plain(idx, q, qlen=None):
    """The plain version of K8, a line-for-line port of the JAX package's
    ops/fm.py::probe_breaks: each step extends the interval forwards by
    base c (the backward extension of the reverse complement, bwt_extend
    with is_back = 0), counts a break where a started interval fails, and
    restarts on c (bwt_set_intv) wherever c is a base and the extension
    did not hold."""
    B, L = q.shape
    dev = q.device
    i64 = torch.int64
    L2 = idx["L2"].to(i64)
    primary = idx["primary"]
    x0 = torch.ones(B, dtype=i64, device=dev)
    x1 = torch.ones(B, dtype=i64, device=dev)
    x2 = torch.zeros(B, dtype=i64, device=dev)
    started = torch.zeros(B, dtype=torch.bool, device=dev)
    breaks = torch.zeros(B, dtype=torch.int32, device=dev)
    bidx = torch.arange(B, device=dev)
    for x in range(L):
        c = q[:, x].to(i64)
        good = c < 4
        tk = _occ4(idx, x1 - 1).to(i64)
        tl = _occ4(idx, x1 - 1 + x2).to(i64)
        ok_sz = tl - tk
        cf = (3 - c).clamp(0, 3)
        span = ((x1 <= primary) & (x1 + x2 - 1 >= primary)).to(i64)
        above = (ok_sz * (torch.arange(4, device=dev)[None, :]
                          > cf[:, None])).sum(dim=1)
        of0 = x0 + span + above
        of1 = L2[cf] + 1 + tk[bidx, cf]
        of2 = ok_sz[bidx, cf]
        ext_ok = started & good & (of2 >= 1)
        breaks += (started & good & (of2 < 1)).to(torch.int32)
        s0, s1, s2 = (s.to(i64) for s in _set_intv(idx, c))
        restart = good & ~ext_ok
        x0 = torch.where(ext_ok, of0, torch.where(restart, s0, x0))
        x1 = torch.where(ext_ok, of1, torch.where(restart, s1, x1))
        x2 = torch.where(ext_ok, of2, torch.where(restart, s2, x2))
        started = good
    return breaks


def _check_occtab(idx, name):
    """idx's occtab as every kernel reads it: contiguous int32 rows of 8 or
    32 text words (R = 1 or 4) at a 16-byte address; else ValueError."""
    occtab = idx.get("occtab")
    if occtab is None:
        raise ValueError(f"{name} reads the fused occtab; this index has "
                         f"none")
    if occtab.dtype != torch.int32 or not occtab.is_contiguous() \
            or occtab.data_ptr() % 16 or occtab.shape[1] - 4 not in (8, 32):
        raise ValueError(f"{name} reads a contiguous int32 occtab of 8 or "
                         f"32 text words a row (R = 1 or 4), aligned to 16 "
                         f"bytes")
    return occtab


def _probe_breaks_cuda(idx, q):
    """Kernel K8 launch: a group of 2R threads a read, a lookup only where
    the read's interval extends."""
    global probe_launches
    from bwa_tpu_torch.ops import cuda_kernels

    occtab = _check_occtab(idx, "K8")
    if not (q.is_cuda and occtab.is_cuda):
        raise ValueError("K8 reads the fused occtab and CUDA codes")
    q8 = q.to(torch.uint8).contiguous()
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    cuda_kernels.probe_breaks(
        occtab, idx["L2"].to(torch.int64).contiguous(), idx["primary"],
        idx["seq_len"], idx["cdt"] == torch.int64, q8, out)
    probe_launches += 1
    return out


# ---------------------------------------------------------------------------
# The cross-check programs: bwt_sa (K9), bwt_smem1a and bwt_seed_strategy1
# one read a lane (K10), and mem_collect_intv's three passes fused (K11).
# Plain versions first (line-for-line ports of the JAX package's
# ops/fm.py functions of the same names), then the dispatchers: a CUDA
# tensor launches csrc/smem_batch.cu, a CPU tensor takes the plain version.
# ---------------------------------------------------------------------------

def sa_batch_plain(idx, k, work=None):
    """bwt_sa (bwt.c:86-96) over a vector of SA rows k: the inverse-Psi walk
    (the BWT base at the row, _B0, and its count, _occ1, both from the
    fused occtab where the index has one) until the row is a multiple of
    sa_intv, then the sampled position plus the steps taken.  Returns
    positions in the coordinate dtype.  work: an int64 [2] tensor to whose
    [0] the walk steps are added and whose [1] is raised to the longest
    walk, as K9 does."""
    _check_ssa(idx)
    i64 = torch.int64
    cdt = idx["cdt"]
    primary = idx["primary"]
    L2 = idx["L2"].to(i64)
    k = k.to(i64).clone()
    mask = idx["sa_intv"] - 1
    steps = torch.zeros_like(k)
    while True:
        lv = ((k & mask) != 0).nonzero().flatten()
        if not lv.numel():
            break
        kl = k[lv]
        x = kl - (kl > primary).to(i64)
        c = _B0(idx, x).to(i64)
        occ = _occ1(idx, kl, c).to(i64)
        k[lv] = torch.where(kl == primary, torch.zeros_like(kl), L2[c] + occ)
        steps[lv] += 1
    if work is not None and steps.numel():
        work[0] += int(steps.sum())
        work[1] = max(int(work[1]), int(steps.max()))
    return (steps + idx["ssa"][k >> 5].to(i64)).to(cdt)


def _push(bufs, n, mask, vals):
    """Conditional append into per-lane lists bufs[f] [B, C] (the last slot
    is overwritten once full; n keeps counting).  In place; returns n."""
    B, C = bufs[0].shape
    b = torch.arange(B, device=n.device)
    slot = n.clamp(max=C - 1)
    for buf, v in zip(bufs, vals):
        buf[b, slot] = torch.where(mask, v.to(buf.dtype), buf[b, slot])
    return n + mask.to(n.dtype)


def _pick(ok, c):
    b = torch.arange(c.shape[0], device=c.device)
    return tuple(o.to(torch.int64)[b, c] for o in ok)


def smem1a_batch_plain(idx, q, qlen, x, min_intv, max_intv, active,
                       cap: int):
    """bwt_smem1a (bwt.c:289-351) lock-step over B reads: q [B, L] codes
    (>= 4 past qlen), x [B] start positions, min_intv [B], max_intv an
    int, active [B] bool.  Returns (ret [B] int32, m0, m1, m2 [B, cap]
    coord, ms, me [B, cap] int32, mem_n [B] int32): the mems in the
    reference's pre-reversal order, a list outgrowing cap overwriting its
    last slot."""
    i64 = torch.int64
    dev = q.device
    B, L = q.shape
    bidx = torch.arange(B, device=dev)
    W = torch.where
    q = q.to(i64)
    qlen = qlen.to(i64)
    x = x.to(i64)
    active = active.to(torch.bool)
    max_intv = int(max_intv)
    qx = q[bidx, x.clamp(0, L - 1)]
    valid = active & (qx < 4) & (x < qlen)
    minv = min_intv.to(i64).clamp(min=1)
    ik0, ik1, ik2 = (t.to(i64) for t in _set_intv(idx, qx))
    info_end = x + 1
    z = lambda: torch.zeros((B, cap), dtype=i64, device=dev)  # noqa: E731
    curr = [z(), z(), z(), z()]  # x0 x1 x2 end
    cn = torch.zeros(B, dtype=i64, device=dev)

    # ---- forward pass ----
    i = x + 1
    done = ~valid
    while True:
        act = ~done & (i < qlen)
        if not bool(act.any()):
            break
        qi = q[bidx, i.clamp(0, L - 1)]
        small = act & (ik2 < max_intv)
        amb = act & ~small & (qi >= 4)
        ext = act & ~small & ~amb
        okc0, okc1, okc2 = _pick(_extend(idx, ik0, ik1, ik2, False),
                                 (3 - qi).clamp(0, 3))
        changed = ext & (okc2 != ik2)
        cn = _push(curr, cn, small | amb | changed,
                   (ik0, ik1, ik2, info_end))
        stop = small | amb | (changed & (okc2 < minv))
        adv = ext & ~stop
        ik0, ik1, ik2 = W(adv, okc0, ik0), W(adv, okc1, ik1), \
            W(adv, okc2, ik2)
        info_end = W(adv, i + 1, info_end)
        i = W(adv, i + 1, i)
        done = done | stop
    # the final push of lanes that ran off the end
    cn = _push(curr, cn, valid & ~done, (ik0, ik1, ik2, info_end))
    # reverse curr so that longer matches come first (bwt_reverse_intvs)
    ridx = (cn[:, None] - 1 - torch.arange(cap, device=dev)[None, :]) \
        .clamp(0, cap - 1)
    prevs = [c.gather(1, ridx) for c in curr]
    ret = W(valid, prevs[3][:, 0], x + 1)

    # ---- backward pass ----
    mems = [z(), z(), z(), z(), z()]  # x0 x1 x2 start end
    mem_n = torch.zeros(B, dtype=i64, device=dev)
    ik_x2 = ik2  # the forward pass's last size (the reference reuses ik)
    pn = cn
    i = x - 1
    done = ~valid
    while True:
        act_l = ~done & (i >= -1)
        if not bool(act_l.any()):
            break
        qi = W(i >= 0, q[bidx, i.clamp(0, L - 1)], torch.full_like(i, 4))
        c = W((i >= 0) & (qi < 4), qi, torch.full_like(qi, -1))
        cc = c.clamp(0, 3)
        n0 = torch.zeros(B, dtype=i64, device=dev)
        cur = [z(), z(), z(), z()]
        last_x2 = torch.zeros(B, dtype=i64, device=dev)
        for j in range(int(W(act_l, pn, torch.zeros_like(pn)).max())):
            jact = act_l & (j < pn)
            jj = min(j, cap - 1)
            px0, px1, px2, pinfo = (p[:, jj] for p in prevs)
            okc0, okc1, okc2 = _pick(_extend(idx, px0, px1, px2, True), cc)
            keep = jact & ((c < 0) | (ik_x2 < max_intv) | (okc2 < minv))
            # mem emission: only while curr is empty and not contained
            m_last = mems[3][bidx, (mem_n - 1).clamp(0, cap - 1)]
            can_emit = keep & (n0 == 0) & ((mem_n == 0) | ((i + 1) < m_last))
            mem_n = _push(mems, mem_n, can_emit,
                          (px0, px1, px2, i + 1, pinfo))
            ik_x2 = W(can_emit, px2, ik_x2)
            push_c = jact & ~keep & ((n0 == 0) | (okc2 != last_x2))
            n0 = _push(cur, n0, push_c, (okc0, okc1, okc2, pinfo))
            last_x2 = W(push_c, okc2, last_x2)
        done = done | (act_l & (n0 == 0))
        prevs = [W(act_l[:, None], a, p) for a, p in zip(cur, prevs)]
        pn = W(act_l, n0, pn)
        i = W(act_l, i - 1, i)
    cdt, i32 = idx["cdt"], torch.int32
    return (ret.to(i32), *(m.to(cdt) for m in mems[:3]),
            *(m.to(i32) for m in mems[3:]), mem_n.to(i32))


def seed_strategy1_batch_plain(idx, q, qlen, x, min_len, max_intv, active):
    """bwt_seed_strategy1 (bwt.c:358-379) lock-step over B reads.  Returns
    (ret [B] int32, found [B] bool, r0, r1, r2 [B] coord, start [B],
    end [B] int32)."""
    i64 = torch.int64
    dev = q.device
    B, L = q.shape
    bidx = torch.arange(B, device=dev)
    W = torch.where
    q = q.to(i64)
    qlen = qlen.to(i64)
    x = x.to(i64)
    min_len, max_intv = int(min_len), int(max_intv)
    qx = q[bidx, x.clamp(0, L - 1)]
    valid = active.to(torch.bool) & (qx < 4) & (x < qlen)
    ik0, ik1, ik2 = (t.to(i64) for t in _set_intv(idx, qx))
    i = x + 1
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    r0 = r1 = r2 = torch.zeros(B, dtype=i64, device=dev)
    ret = W(valid, qlen, x + 1)
    done = ~valid
    while True:
        act = ~done & (i < qlen)
        if not bool(act.any()):
            break
        qi = q[bidx, i.clamp(0, L - 1)]
        amb = act & (qi >= 4)
        ext = act & ~amb
        okc0, okc1, okc2 = _pick(_extend(idx, ik0, ik1, ik2, False),
                                 (3 - qi).clamp(0, 3))
        hit = ext & (okc2 < max_intv) & ((i - x) >= min_len)
        found = found | hit
        r0, r1, r2 = W(hit, okc0, r0), W(hit, okc1, r1), W(hit, okc2, r2)
        ret = W(amb | hit, i + 1, ret)
        done = done | amb | hit
        adv = ext & ~hit
        ik0, ik1, ik2 = W(adv, okc0, ik0), W(adv, okc1, ik1), \
            W(adv, okc2, ik2)
        i = W(adv, i + 1, i)
    cdt, i32 = idx["cdt"], torch.int32
    return (ret.to(i32), found & valid, r0.to(cdt), r1.to(cdt), r2.to(cdt),
            x.to(i32), ret.to(i32))


def _skip_amb(q, qlen, x):
    """Advance x past ambiguous bases (mem_collect_intv's `else ++x`)."""
    bidx = torch.arange(q.shape[0], device=q.device)
    L = q.shape[1]
    while True:
        amb = (x < qlen) & (q[bidx, x.clamp(0, L - 1)] >= 4)
        if not bool(amb.any()):
            return x
        x = x + amb.to(x.dtype)


def _append_filtered(seeds, seed_n, mems, mem_n, min_seed_len, lane_mask):
    """Append a call's mems of at least min_seed_len bases to the seed
    store, oldest first (the backward pass emits them newest first)."""
    cap = mems[0].shape[1]
    bidx = torch.arange(seed_n.shape[0], device=seed_n.device)
    mem_n = mem_n.to(torch.int64)
    for j in range(int(torch.where(lane_mask, mem_n,
                                   torch.zeros_like(mem_n)).max())):
        jj = (mem_n - 1 - j).clamp(0, cap - 1)
        row = [m.to(torch.int64)[bidx, jj] for m in mems]
        ok = lane_mask & (j < mem_n) & ((row[4] - row[3]) >= min_seed_len)
        seed_n = _push(seeds, seed_n, ok, row)
    return seed_n


def collect_intv_device_plain(idx, q, qlen, min_seed_len, split_len,
                              split_width, max_mem_intv, cap: int,
                              cap_s: int, key64: bool):
    """All three passes of mem_collect_intv (bwamem.c:140-188), lock-step
    over B reads, one bwt_smem1a / bwt_seed_strategy1 call a lane at a
    time; seeds sorted by (start, end), the reference's .info order.
    Returns (s0, s1, s2 [B, cap_s] coord, ss, se [B, cap_s] int32,
    seed_n [B] int32)."""
    i64 = torch.int64
    dev = q.device
    B = q.shape[0]
    W = torch.where
    qlen = qlen.to(i64)
    min_seed_len, split_len = int(min_seed_len), int(split_len)
    split_width = int(split_width)
    seeds = [torch.zeros((B, cap_s), dtype=i64, device=dev)
             for _ in range(5)]
    seed_n = torch.zeros(B, dtype=i64, device=dev)
    ones = torch.ones(B, dtype=i64, device=dev)

    # ---- pass 1 ----
    x = _skip_amb(q, qlen, torch.zeros(B, dtype=i64, device=dev))
    while bool((x < qlen).any()):
        x = _skip_amb(q, qlen, x)
        active = x < qlen
        ret, *mems, mem_n = smem1a_batch_plain(idx, q, qlen, x, ones, 0,
                                               active, cap)
        seed_n = _append_filtered(seeds, seed_n, mems, mem_n, min_seed_len,
                                  active)
        x = W(active, ret.to(i64), x)

    # ---- pass 2: re-seed long low-occurrence SMEMs from their midpoints
    old_n = seed_n.clone()
    for k in range(int(old_n.max()) if B else 0):
        kk = min(k, cap_s - 1)
        start, end, x2 = seeds[3][:, kk], seeds[4][:, kk], seeds[2][:, kk]
        need = (k < old_n) & ((end - start) >= split_len) \
            & (x2 <= split_width)
        ret, *mems, mem_n = smem1a_batch_plain(
            idx, q, qlen, (start + end) >> 1, x2 + 1, 0, need, cap)
        seed_n = _append_filtered(seeds, seed_n, mems, mem_n, min_seed_len,
                                  need)

    # ---- pass 3: LAST-like seeding ----
    x = _skip_amb(q, qlen, torch.zeros(B, dtype=i64, device=dev))
    while bool((x < qlen).any()):
        x = _skip_amb(q, qlen, x)
        active = x < qlen
        ret, found, r0, r1, r2, rs, re_ = seed_strategy1_batch_plain(
            idx, q, qlen, x, min_seed_len, max_mem_intv, active)
        seed_n = _push(seeds, seed_n, active & found & (r2 > 0),
                       (r0, r1, r2, rs, re_))
        x = W(active, ret.to(i64), x)

    # ---- stable sort by info == (start, end) ----
    shift = 32 if key64 else 16
    key = (seeds[3] << shift) | seeds[4]
    if not key64:  # the reference implementation's int32 key
        key = key.to(torch.int32).to(i64)
    big = (1 << 63) - 1 if key64 else (1 << 31) - 1
    pad = torch.arange(cap_s, device=dev)[None, :] >= seed_n[:, None]
    order = torch.sort(W(pad, torch.full_like(key, big), key), dim=1,
                       stable=True).indices
    out = [s.gather(1, order) for s in seeds]
    cdt, i32 = idx["cdt"], torch.int32
    return (*(s.to(cdt) for s in out[:3]), out[3].to(i32), out[4].to(i32),
            seed_n.to(i32))


# launches of each kernel of csrc/smem_batch.cu (its wrapper adds one a
# launch): K9 sa_batch, K10a smem1a_batch, K10b seed_strategy1_batch, K11
# collect_intv_device
sa_launches = 0
smem1a_launches = 0
strategy1_launches = 0
collect_launches = 0


def _check_ssa(idx):
    if "ssa" not in idx:
        raise ValueError("sa_batch needs the sampled suffix array (ssa), "
                         "which this index tree does not hold")


def sa_form(idx) -> str:
    """K9's form for an index tree: "ckpt" where ckpt and words cover the
    text (a full index), else "occtab", the fused table K1 reads (a light
    index uploads only a one-row stub of ckpt and words)."""
    if idx["words"].shape[0] > (idx["seq_len"] - 1) >> 7:
        return "ckpt"
    _check_occtab(idx, "K9's occtab form")
    return "occtab"


def sa_batch(idx, k, work=None):
    """bwt_sa over the SA rows k [N]: kernel K9 (csrc/smem_batch.cu, a
    thread a row) for a CUDA k, in the form sa_form picks from idx;
    sa_batch_plain for a CPU k.  work: an int64 [2] tensor on k's device:
    [0] gains the walk steps taken, [1] is raised to the longest walk."""
    global sa_launches
    if work is not None and work.shape != (2,):
        raise ValueError("sa_batch's work is an int64 [2] tensor")
    if not k.is_cuda:
        return sa_batch_plain(idx, k, work)
    from bwa_tpu_torch.ops import cuda_kernels

    occtab, ckpt, words = _k9_tables(idx)
    cdt = idx["cdt"]
    kk = k.to(cdt).contiguous()
    out = torch.empty_like(kk)
    ssa, L2 = idx["ssa"].contiguous(), idx["L2"].to(torch.int64).contiguous()
    coord64 = cdt == torch.int64
    if occtab is not None:
        cuda_kernels.sa_occ(occtab, ssa, L2, idx["primary"], idx["seq_len"],
                            coord64, kk, out, work)
    else:
        cuda_kernels.sa_batch(ckpt, words, ssa, L2, idx["primary"],
                              idx["seq_len"], coord64, kk, out, work)
    sa_launches += 1
    return out


def _k9_tables(idx):
    """What K9 reads of idx besides ssa, in the form sa_form picks:
    (occtab, None, None), or (None, ckpt, words); ValueError where K9
    cannot walk idx."""
    _check_ssa(idx)
    if idx["sa_intv"] != 32:
        raise ValueError("K9 walks to multiples of 32 (sa_intv 32)")
    if sa_form(idx) == "occtab":
        return idx["occtab"], None, None
    ckpt, words = idx["ckpt"].contiguous(), idx["words"].contiguous()
    if ckpt.dtype != idx["cdt"] or ckpt.data_ptr() % 16 \
            or words.data_ptr() % 16:
        raise ValueError("K9 reads a block's counts and text words as "
                         "16-byte vectors: ckpt in the coordinate dtype, "
                         "both aligned to 16 bytes")
    return None, ckpt, words


class DeviceSA:
    """The SA lookup on the card, FMIndex.sa_lookup's `card` on a CUDA
    engine: takes int64 ranks, returns their positions (int64) and the
    walk's steps.  K9, in the form sa_form picks for the tree, runs on a
    high-priority stream of its own, so that it does not queue behind the
    next bucket's K1 (se_flat_buckets dispatches it on the current stream
    before it demuxes this bucket); the ranks go up from a pinned buffer,
    and the positions and the steps come down into pinned buffers, all in
    one C call (cuda_kernels.sa_round_trip); the buffers are kept and
    grown."""

    def __init__(self, idx: dict, device):
        self.idx = idx
        self.device = torch.device(device)
        self.tables = _k9_tables(idx)
        self.ssa = idx["ssa"].contiguous()
        self.L2 = idx["L2"].to(torch.int64).contiguous()
        self.bufs = None
        self.stream = torch.cuda.Stream(self.device, priority=-1)
        # the index's uploads, on the current stream, come first
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _grow(self, n: int) -> dict:
        cdt, dev = self.idx["cdt"], self.device
        cap = max(n, 1 << 17)
        with torch.cuda.stream(self.stream):
            b = dict(cap=cap, k=torch.empty(cap, dtype=cdt, device=dev),
                     out=torch.empty(cap, dtype=cdt, device=dev),
                     work=torch.empty(2, dtype=torch.int64, device=dev))
        for key, dt, m in (("k_h", cdt, cap), ("out_h", cdt, cap),
                           ("work_h", torch.int64, 2)):
            b[key] = torch.empty(m, dtype=dt, pin_memory=True)
            b[key + "_np"] = b[key].numpy()
        self.bufs = b
        return b

    def __call__(self, ranks: np.ndarray) -> tuple[np.ndarray, int]:
        global sa_launches
        from bwa_tpu_torch.ops import cuda_kernels

        n = len(ranks)
        b = self.bufs
        if b is None or b["cap"] < n:
            b = self._grow(n)
        b["k_h_np"][:n] = ranks
        idx = self.idx
        cuda_kernels.sa_round_trip(
            *self.tables, self.ssa, self.L2, idx["primary"],
            idx["seq_len"], idx["cdt"] == torch.int64, b["k_h"], b["k"],
            b["out"], b["out_h"], n, b["work"], b["work_h"], self.stream)
        sa_launches += 1
        return b["out_h_np"][:n].astype(np.int64), int(b["work_h_np"][0])


def _occ_tensors(idx, name):
    return _check_occtab(idx, name), idx["L2"].to(torch.int64).contiguous()


# the forms of K10a (csrc/smem_batch.cu, design items 1 and 3): "group", a
# group of 2R threads a read, 32 / 2R reads a warp, a backward row one
# entry a lookup; "warp", a read a warp, its forward steps one group's
# lookup, a backward row 32 / 2R entries a round, its rules by ballot.
# K10b runs in the group form, K11 in the warp form.
SMEM_FORMS = ("group", "warp")


def smem1a_form(x, active) -> str:
    """K10a's form for a call: "group" when no active read starts past 0,
    else "warp".  From x = 0 the backward pass is the one row at i = -1,
    which needs no lookup, so the reads of a warp step in lockstep through
    their forward passes, one lookup each; from inside a read, backward
    rows diverge the reads of a warp, and a read a warp takes a row's
    entries 32 / 2R at a time (PERF.md section 6: on an H100 the group
    form is 2.3x faster from x = 0 and 1.0-4.0x slower elsewhere).  x,
    active: the host's arrays (numpy, or CPU tensors) of the call, before
    they are uploaded: the rule never reads a card's memory."""
    starts = np.asarray(active, bool) & (np.asarray(x) != 0)
    return "warp" if bool(starts.any()) else "group"


SMEM_BLOCK_BYTES = 232448  # a block's shared memory at most (227 KB)
SCRATCH_WARPS = 4  # warps a block, and an SM, on the global-scratch plan
# the last launch's plan of each kernel of csrc/smem_batch.cu
smem_plans: dict = {}
_occupancy: dict = {}


def _smem_plan(idx, q, kernel: str, per_read: int, form: str) -> dict:
    """How a kernel of csrc/smem_batch.cu (K10a, K10b, K11) runs the
    q.shape[0] = B reads: in `form` (SMEM_FORMS), E reads a warp (32 / 2R,
    or 1); of 1, 2, 4 or 8 warps a block, the fewest that keep the most
    reads resident at once (the blocks an SM from the card's occupancy at
    that block's shared memory), and blocks enough for every read.  A
    read's lists (per_read bytes) lie in the block's shared memory or,
    where one warp's would pass a block's 227 KB, in a global scratch for
    a block of 4 warps on each SM, each warp taking its reads in turn.
    Returns the plan as a dict (also in smem_plans[kernel])."""
    from bwa_tpu_torch.ops import cuda_kernels

    if form not in SMEM_FORMS:
        raise ValueError(f"{kernel}: form {form!r} is not one of "
                         f"{SMEM_FORMS}")
    B = q.shape[0]
    nw = int(idx["occtab"].shape[1] - 4)
    E = 32 // (nw // 4) if form == "group" else 1
    warps = -(-B // E)
    coord64 = idx["cdt"] == torch.int64
    warp = form == "warp"
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def occupancy(wpb, smem):
        key = (kernel, coord64, nw, warp, wpb, smem, dev.index)
        if key not in _occupancy:
            _occupancy[key] = cuda_kernels.smem_occupancy(
                kernel, coord64, nw, warp, wpb, smem, device=dev)
        return _occupancy[key]

    best = None
    for wpb in (1, 2, 4, 8):
        smem = wpb * E * per_read
        if smem > SMEM_BLOCK_BYTES:
            break
        occ = occupancy(wpb, smem)
        resident = min(B, occ["blocks_per_sm"] * sms * wpb * E)
        if best is None or resident > best["resident_reads"]:
            best = dict(warps_per_block=wpb, blocks=-(-warps // wpb),
                        smem=smem, scratch=None, resident_reads=resident,
                        lists="shared" if per_read else "none",
                        registers=occ["registers"])
    if best is None:  # one warp's lists past a block's shared memory
        wpb = SCRATCH_WARPS
        blocks = min(-(-warps // wpb), sms)
        occ = occupancy(wpb, 0)
        best = dict(warps_per_block=wpb, blocks=blocks, smem=0,
                    scratch=torch.empty(blocks * wpb * E * per_read,
                                        dtype=torch.uint8, device=dev),
                    resident_reads=min(B, blocks * wpb * E),
                    lists="scratch", registers=occ["registers"])
    plan = dict(form=form, reads_per_warp=E, per_read=per_read, **best)
    smem_plans[kernel] = {k: v for k, v in plan.items() if k != "scratch"}
    return plan


def smem1a_batch(idx, q, qlen, x, min_intv, max_intv, active, cap: int,
                 work=None, form: str = "warp"):
    """bwt_smem1a one read a lane: kernel K10a (csrc/smem_batch.cu) for
    CUDA codes, smem1a_batch_plain for CPU ones; same arguments and
    outputs.  form: K10a's form (SMEM_FORMS); "warp" is right for every
    x, and callers that hold the call's x and active on the host pick it
    by smem1a_form before they upload them, so that the wrapper never
    waits for the card.  work: an int64 [1] CUDA tensor to which K10a adds
    the intervals it extended."""
    global smem1a_launches
    if not q.is_cuda:
        return smem1a_batch_plain(idx, q, qlen, x, min_intv, max_intv,
                                  active, cap)
    from bwa_tpu_torch.ops import cuda_kernels

    occtab, L2 = _occ_tensors(idx, "K10a")
    cdt, i32 = idx["cdt"], torch.int32
    B = q.shape[0]
    dev = q.device
    ret = torch.empty(B, dtype=i32, device=dev)
    mem_n = torch.empty(B, dtype=i32, device=dev)
    m = [torch.zeros((B, cap), dtype=t, device=dev)
         for t in (cdt, cdt, cdt, i32, i32)]
    plan = _smem_plan(idx, q, "K10a", 2 * cap * 4 * cdt.itemsize, form)
    cuda_kernels.smem1a(occtab, L2, idx["primary"], idx["seq_len"],
                        cdt == torch.int64, q.to(torch.uint8).contiguous(),
                        qlen.to(i32).contiguous(), x.to(i32).contiguous(),
                        min_intv.to(cdt).contiguous(), int(max_intv),
                        active.to(torch.uint8).contiguous(), cap, ret, *m,
                        mem_n, plan, work)
    smem1a_launches += 1
    return (ret, *m, mem_n)


def seed_strategy1_batch(idx, q, qlen, x, min_len, max_intv, active,
                         work=None):
    """bwt_seed_strategy1 one read a lane: kernel K10b (csrc/smem_batch.cu,
    a group of 2R threads a read) for CUDA codes,
    seed_strategy1_batch_plain for CPU ones; same arguments and outputs."""
    global strategy1_launches
    if not q.is_cuda:
        return seed_strategy1_batch_plain(idx, q, qlen, x, min_len,
                                          max_intv, active)
    from bwa_tpu_torch.ops import cuda_kernels

    occtab, L2 = _occ_tensors(idx, "K10b")
    cdt, i32 = idx["cdt"], torch.int32
    B = q.shape[0]
    dev = q.device
    ret = torch.empty(B, dtype=i32, device=dev)
    found = torch.empty(B, dtype=torch.uint8, device=dev)
    r = [torch.empty(B, dtype=cdt, device=dev) for _ in range(3)]
    xx = x.to(i32).contiguous()
    plan = _smem_plan(idx, q, "K10b", 0, "group")
    cuda_kernels.strategy1(occtab, L2, idx["primary"], idx["seq_len"],
                           cdt == torch.int64, q.to(torch.uint8).contiguous(),
                           qlen.to(i32).contiguous(), xx, int(min_len),
                           int(max_intv), active.to(torch.uint8).contiguous(),
                           ret, found, *r, plan, work)
    strategy1_launches += 1
    return (ret, found.bool(), *r, xx.clone(), ret.clone())


def collect_intv_device(idx, q, qlen, min_seed_len, split_len, split_width,
                        max_mem_intv, cap: int, cap_s: int, key64: bool,
                        work=None):
    """mem_collect_intv's three passes fused, one read a lane: kernel K11
    (csrc/smem_batch.cu, a read a warp on K10's device routines: K10a's
    warp form; it shares only the group lookup with K1's kernels, whose
    cross-check it is) for CUDA codes,
    collect_intv_device_plain for CPU ones; same arguments and outputs."""
    global collect_launches
    if not q.is_cuda:
        return collect_intv_device_plain(idx, q, qlen, min_seed_len,
                                         split_len, split_width,
                                         max_mem_intv, cap, cap_s, key64)
    from bwa_tpu_torch.ops import cuda_kernels

    occtab, L2 = _occ_tensors(idx, "K11")
    cdt, i32 = idx["cdt"], torch.int32
    B = q.shape[0]
    dev = q.device
    # the seeds as appended (zeros past seed_n, as the plain version's),
    # then sorted into the outputs
    raw = torch.zeros((B, cap_s, 5), dtype=cdt, device=dev)
    out = [torch.empty((B, cap_s), dtype=t, device=dev)
           for t in (cdt, cdt, cdt, i32, i32)]
    seed_n = torch.empty(B, dtype=i32, device=dev)
    plan = _smem_plan(idx, q, "K11", 13 * cap * cdt.itemsize, "warp")
    cuda_kernels.collect_intv(
        occtab, L2, idx["primary"], idx["seq_len"], cdt == torch.int64,
        q.to(torch.uint8).contiguous(), qlen.to(i32).contiguous(),
        int(min_seed_len), int(split_len), int(split_width),
        int(max_mem_intv), cap, cap_s, bool(key64), raw, *out, seed_n, plan,
        work)
    collect_launches += 1
    return (*out, seed_n)


# the switch that selects each seeding route other than the default
ROUTE_SWITCH = {"split": "BWA_TPU_SEED_MACHINE=split",
                "compact": "BWA_TPU_SEED_COMPACT"}


def seed_route() -> str:
    """The seeding route collect_seeds takes, as bwa_tpu reads it from the
    environment: "split" (BWA_TPU_SEED_MACHINE=split: three calls, one a
    pass, on K1's state mode), "compact" (BWA_TPU_SEED_COMPACT: the
    machine in segments, finished lanes compacted away between them) or
    "unified" (the default)."""
    if os.environ.get("BWA_TPU_SEED_MACHINE", "unified") == "split":
        return "split"
    if os.environ.get("BWA_TPU_SEED_COMPACT"):
        return "compact"
    return "unified"


class BatchedFMEngine:
    """Batched device engine with the method set mem/batch_seed.py calls,
    on one device, or with `mesh` (parallel/mesh.py) over its devices: one
    index tree a distinct device (`trees`; two shards on one card share
    its tree), each batch of lanes that the mesh's size divides split
    over the shards (others run on the first device), and `device` the
    mesh's first device, where the seed extension and the per-batch
    tensors of the other routes stay."""

    def __init__(self, fm: FMIndex, device: str | torch.device = "cuda",
                 mesh=None):
        self.fm = fm
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else torch.device(device)
        devices = mesh.distinct() if mesh is not None else (self.device,)
        if any(d.type == "cuda" for d in devices) \
                and not torch.cuda.is_available():
            raise RuntimeError("BatchedFMEngine: CUDA device requested but "
                               "torch.cuda.is_available() is false")
        light = fm.words.shape[0] > (1 << 20)
        self.trees = {}
        for d in devices:
            dv = DeviceFMIndex(fm, light=light, device=d)
            if d == self.device:
                self.dev = dv
            self.trees[d] = dv.tree()
        self.idx = self.trees[self.device]
        # the SA lookup's route (FMIndex.sa_lookup): the dense sidecar
        # where the index has one, else K9 on a CUDA engine, else the
        # host's walk
        self.sa_card = (DeviceSA(self.idx, self.device)
                        if self.device.type == "cuda" and fm.sad is None
                        and fm.sa_intv == 32 else None)
        self._host = None

    @property
    def host(self):
        if self._host is None:
            from bwa_tpu_torch.ops.fm_host import HostFM

            self._host = HostFM(self.fm)
        return self._host

    # scalar API (the per-read host fallback of mem/seeding.py)
    def smem1a(self, q, x, min_intv, max_intv):
        return self.host.smem1a(q, x, min_intv, max_intv)

    def seed_strategy1(self, q, x, min_len, max_intv):
        return self.host.seed_strategy1(q, x, min_len, max_intv)

    def sa(self, k):
        return self.host.sa(k)

    def fetch_seq(self, beg, mid, end):
        return self.fm.fetch_seq(beg, mid, end)

    def sa_many(self, ks: np.ndarray) -> np.ndarray:
        if len(ks) == 0:
            return np.zeros(0, dtype=np.int64)
        return self.fm.sa_lookup(ks, card=self.sa_card)

    # ---- seeding ----

    def _consts(self, opt, L: int, stack_cap):
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        if stack_cap is None:
            stack_cap = int(os.environ.get("BWA_TPU_STACK_CAP", "16"))
        return split_len, min(stack_cap, L + 2), bool(opt.max_mem_intv > 0)

    def _run_machine(self, qd, qld, opt, cap_s, stack_cap, use_p3,
                     split_len, shard, key64):
        nvd = _next_valid_device(qd, qld)
        from bwa_tpu_torch.ops import fm_machine

        seeds, seed_n, st1, ovf, ds1 = fm_machine.seed_machine(
            self.idx, qd, qld, nvd, opt.min_seed_len, split_len,
            opt.split_width, opt.max_mem_intv, cap=stack_cap, cap_s=cap_s,
            use_p3=use_p3, shard=shard)
        meta = _pack_meta(seed_n, ovf, ds1, st1)
        seeds = fm_machine.sort_seeds(seeds, seed_n, key64=key64)
        return seeds, meta

    def collect_seeds_dispatch(self, q_pad: np.ndarray, qlen: np.ndarray,
                               opt, cap_s: int, stack_cap: int | None = None,
                               shard=None):
        """Upload a bucket and queue the seeding machine + sort on the
        device's current stream without waiting; a CUDA event marks the
        end.  On a mesh whose size divides the lanes, each shard's block
        goes to its own device (parallel/mesh.machine_sharded), with an
        event a shard.  Pair with collect_seeds_wait; the host is free in
        between."""
        B, L = q_pad.shape
        split_len, stack_cap, use_p3 = self._consts(opt, L, stack_cap)
        if self.mesh is not None and B % self.mesh.size == 0:
            from bwa_tpu_torch.parallel.mesh import guard, machine_sharded

            fn = machine_sharded(
                self.trees, self.mesh, opt.min_seed_len, split_len,
                opt.split_width, opt.max_mem_intv, cap=stack_cap,
                cap_s=cap_s, use_p3=use_p3, tagged=shard is not None)
            seeds, metas, evs = [], [], []
            for dev, (sd, seed_n, ovf, ds, st) in zip(
                    self.mesh.devices,
                    fn.launch(q_pad, qlen.astype(np.int32), *(shard or ()))):
                with guard(dev):
                    seeds.append(sd)
                    metas.append(_pack_meta(seed_n, ovf, ds, st))
                    evs.append(self._event(dev))
            return (seeds, metas, cap_s, evs)
        qd = torch.from_numpy(np.ascontiguousarray(q_pad)).to(self.device)
        qld = torch.from_numpy(qlen.astype(np.int32)).to(self.device)
        seeds, meta = self._run_machine(qd, qld, opt, cap_s, stack_cap,
                                        use_p3, split_len, shard,
                                        key64=bool(L >= 32768))
        return (seeds, meta, cap_s, self._event())

    def probe_trips(self, codes_list):
        """[B] predicted machine trips of each read (K8's break counts,
        probe_breaks) for trip-sorted bucket packing, and the batch's read
        matrix on the device, from which collect_seeds_dispatch_gather
        packs each bucket's lanes instead of uploading them."""
        from bwa_tpu_torch.mem.batch_seed import _pad_reads

        q, lens, _ = _pad_reads(codes_list)
        qd = torch.from_numpy(q).to(self.device)
        br = probe_breaks(self.idx, qd, torch.from_numpy(lens).to(
            self.device))
        return br.cpu().numpy(), qd

    def collect_seeds_dispatch_gather(self, q_all, pa, pb, qlen, opt,
                                      cap_s: int,
                                      stack_cap: int | None = None):
        """collect_seeds_dispatch for a bucket whose pack_k=2 lanes are
        gathered on the device from q_all, the read matrix probe_trips
        returned (_gather_pack): pa/pb are its row indices a lane (pb = -1:
        an all-N slot 1), qlen the packed lane lengths."""
        Lp = 2 * (q_all.shape[1] + 1)
        split_len, stack_cap, use_p3 = self._consts(opt, Lp, stack_cap)
        dev = self.device
        qd = _gather_pack(q_all, torch.from_numpy(pa.astype(np.int64)).to(
            dev), torch.from_numpy(pb.astype(np.int64)).to(dev))
        qld = torch.from_numpy(qlen.astype(np.int32)).to(dev)
        seeds, meta = self._run_machine(qd, qld, opt, cap_s, stack_cap,
                                        use_p3, split_len, None,
                                        key64=bool(Lp >= 32768))
        return (seeds, meta, cap_s, self._event())

    def collect_seeds_refill_dispatch(self, q_all: np.ndarray,
                                      qlen_all: np.ndarray, opt, cap_s: int,
                                      cap_r: int, lanes: int,
                                      stack_cap: int | None = None):
        """Retire-and-refill seeding, queued without waiting: the bucket's
        reads go up as one per-read table (_refill_table) and `lanes`
        machine lanes draw reads from a shared queue as they finish
        theirs (fm_machine.seed_machine_refill; kernel K1's refill mode
        on a CUDA engine), so a launch lasts about total work / lanes
        rather than its unluckiest lane.  Seeds carry the read id in the
        provenance column; cap_s is a lane's seed store, cap_r one read's
        share of it (a lane stops drawing without that much room)."""
        from bwa_tpu_torch.ops import fm_machine

        N, L = q_all.shape
        split_len, stack_cap, use_p3 = self._consts(opt, L, stack_cap)
        qd = torch.from_numpy(np.ascontiguousarray(q_all)).to(self.device)
        qld = torch.from_numpy(qlen_all.astype(np.int32)).to(self.device)
        table = _refill_table(qd, qld)
        seeds, seed_n, st, ovf, ds, qctr = fm_machine.seed_machine_refill(
            self.idx, table, lanes, opt.min_seed_len, split_len,
            opt.split_width, opt.max_mem_intv, cap=stack_cap, cap_s=cap_s,
            use_p3=use_p3, cap_r=cap_r)
        # the kernel's cursor passes N by the draws that found the queue
        # empty: the reads drawn are min(qctr, N)
        drawn = qctr.clamp(max=N).to(torch.int32).reshape(1, 1)
        meta = torch.cat([_pack_meta(seed_n, ovf, ds, st),
                          drawn.expand(1, lanes)])
        seeds = fm_machine.sort_seeds(seeds, seed_n, key64=False)
        return (seeds, meta, cap_s, self._event())

    def collect_seeds_refill_wait(self, handle):
        """Blocking half of the refill dispatch: the usual seed tuple (tag
        column = read id) and n_drawn, the reads the lanes started; fewer
        than the bucket's means every lane filled its seed store."""
        seeds, meta, cap_s, ev = handle
        if ev is not None:
            ev.synchronize()
        meta = meta.cpu().numpy()
        return (self._fetch_seeds([seeds], meta[0], meta[1] != 0, cap_s),
                int(meta[4, 0]))

    def collect_seeds_refill(self, q_all, qlen_all, opt, cap_s: int,
                             cap_r: int, lanes: int,
                             stack_cap: int | None = None):
        h = self.collect_seeds_refill_dispatch(q_all, qlen_all, opt, cap_s,
                                               cap_r, lanes, stack_cap)
        return self.collect_seeds_refill_wait(h)

    def _event(self, device=None):
        device = self.device if device is None else device
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    def collect_seeds_wait(self, handle):
        """Blocking half: wait for the dispatch's event (on a mesh, every
        shard's), pull the packed small outputs in one copy (a shard),
        then the seed rows narrowed to the batch's need, joined in shard
        order."""
        seeds, meta, cap_s, ev = handle
        if not isinstance(seeds, list):  # one device
            seeds, meta, ev = [seeds], [meta], [ev]
        for e in ev:
            if e is not None:
                e.synchronize()
        meta = np.concatenate([m.cpu().numpy() for m in meta], axis=1)
        self.last_done = (meta[2],)
        self.last_steps = (int(meta[3].max(initial=0)),)
        return self._fetch_seeds(seeds, meta[0], meta[1] != 0, cap_s)

    def collect_seeds(self, q_pad: np.ndarray, qlen: np.ndarray, opt,
                      cap_s: int, fused: bool = False,
                      stack_cap: int | None = None, shard=None):
        """3-pass seed collection on the device.  Returns numpy (s0, s1,
        s2, ss, se, seed_n[, tag]).

        Default: the unified machine, dispatch + wait back to back.
        fused=True: collect_intv_device (kernel K11 on a CUDA engine), the
        lock-step cross-check program, lists of L + 2 rows, seed_n as it
        counted.  seed_route() "split": pass 1, pass 2 and pass 3 as three
        runs of the machine on one typed state (smem_pass, seed3_pass;
        K12); "compact": the machine in segments, the lanes still running
        gathered into fewer between them (_compact; K13).  The split and
        compact routes run on the engine's first device even on a mesh,
        take their stack cap from BWA_TPU_STACK_CAP alone and do not read
        shard (their seed store has no tag column), as bwa_tpu's do; every
        route leaves last_done and last_steps as bwa_tpu's engine does."""
        B, L = q_pad.shape
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        route = seed_route()
        if not fused and route == "unified":
            h = self.collect_seeds_dispatch(q_pad, qlen, opt, cap_s,
                                            stack_cap, shard=shard)
            return self.collect_seeds_wait(h)
        qd = _to_dev(q_pad, self.device)
        qld = _to_dev(qlen, self.device, np.int32)
        if fused:
            out = collect_intv_device(
                self.idx, qd, qld, opt.min_seed_len, split_len,
                opt.split_width, opt.max_mem_intv, cap=L + 2, cap_s=cap_s,
                key64=bool(L >= 32768))
            return [o.cpu().numpy() for o in out]
        from bwa_tpu_torch.ops import fm_machine

        nvd = _next_valid_device(qd, qld)
        # a step's cost follows the stacks' size; a deeper read is flagged
        # and climbs the caller's ladder or goes to the host spec
        stack_cap = min(int(os.environ.get("BWA_TPU_STACK_CAP", "16")),
                        L + 2)
        run = self._split if route == "split" else self._compact
        seeds, seed_n, ovf = run(qd, qld, nvd, opt, split_len, stack_cap,
                                 cap_s)
        seeds = fm_machine.sort_seeds(seeds, seed_n, key64=bool(L >= 32768))
        return self._fetch_seeds([seeds], seed_n.cpu().numpy(),
                                 ovf.cpu().numpy(), cap_s)

    def _split(self, qd, qld, nvd, opt, split_len, cap, cap_s):
        """The three-call route (bwa_tpu's BWA_TPU_SEED_MACHINE=split): pass
        1, pass 2 from pass 1's rows, then pass 3 when max_mem_intv > 0
        (its own overflow flag dropped, as bwa_tpu's), all on one typed
        state, with no host read between them.  Returns (seeds, seed_n,
        ovf); last_done holds each SMEM pass's done_step, last_steps the
        three runs' steps (0 for a pass 3 not run), from one copy at the
        end."""
        from bwa_tpu_torch.ops import fm_machine as fmm

        st = fmm.typed_state(qd.shape[0], cap, cap_s, self.idx["cdt"],
                             qd.device)
        r_ovf = fmm.INT_FIELDS.index("ovf")  # ovf, done_step
        consts = (opt.min_seed_len, split_len, opt.split_width)
        fmm.smem_pass(st, self.idx, qd, qld, nvd, *consts, cap=cap,
                      cap_s=cap_s, pass2=False)
        p1 = [st["steps"].clone(), st["ints"][r_ovf:r_ovf + 2].clone()]
        fmm.smem_pass(st, self.idx, qd, qld, nvd, *consts, cap=cap,
                      cap_s=cap_s, pass2=True)
        ovf = (p1[1][0] | st["ovf"]) != 0
        p2 = [st["steps"].clone(), st["done_step"].clone()]
        p3 = [torch.zeros_like(p2[0])]
        if opt.max_mem_intv > 0:
            fmm.seed3_pass(st, self.idx, qd, qld, nvd, opt.min_seed_len,
                           opt.max_mem_intv, cap_s=cap_s)
            p3 = [st["steps"]]
        meta = torch.cat([p1[0], p2[0], p3[0], p1[1][1], p2[1]]).cpu() \
            .numpy()
        B = qd.shape[0]
        self.last_done = (meta[3:3 + B], meta[3 + B:])
        self.last_steps = tuple(int(s) for s in meta[:3])
        return st["seeds"], st["seed_n"], ovf

    def _compact(self, qd, qld, nvd, opt, split_len, cap, cap_s):
        """Tail compaction (bwa_tpu's BWA_TPU_SEED_COMPACT): a first segment
        of BWA_TPU_SEED_SEG (448) steps, later ones of BWA_TPU_SEED_SEG2
        (256), each lane's results written home after every segment (a
        scatter a tensor); then the lanes still running are gathered into
        max(256, next power of two) lanes (one index_select a tensor of
        the typed state; the rest parked, writing to a junk row B), or, if
        that would not shrink the launch, run out in place; at 256 lanes or
        fewer a segment runs to the end.  One host read a segment (steps
        and phases).  Returns (seeds, seed_n, ovf); last_done is zeros,
        last_steps the run's steps, last_levels (lanes, steps so far,
        lanes still running) after each segment.

        Unlike bwa_tpu's, a segment to the end runs to the end whatever
        steps came before: bwa_tpu adds its 0x7fffffff budget to the step
        count in int32, which wraps once a segment has run, so that there
        such a segment runs no step and its lanes keep part of their
        seeds."""
        from bwa_tpu_torch.ops import fm_machine as fmm

        B = qd.shape[0]
        dev = qd.device
        use_p3 = bool(opt.max_mem_intv > 0)
        consts = (opt.min_seed_len, split_len, opt.split_width,
                  opt.max_mem_intv)
        seg0 = int(os.environ.get("BWA_TPU_SEED_SEG", "448"))
        seg = int(os.environ.get("BWA_TPU_SEED_SEG2", "256"))
        min_b = 256
        cdt = self.idx["cdt"]
        state = fmm.typed_state(B, cap, cap_s, cdt, dev)
        out_seeds = torch.zeros((B + 1, cap_s, 5), dtype=cdt, device=dev)
        out_sn = torch.zeros(B + 1, dtype=torch.int32, device=dev)
        out_ovf = torch.zeros(B + 1, dtype=torch.int32, device=dev)
        orig = torch.arange(B, device=dev)
        q_l, ql_l, nv_l = qd, qld, nvd
        B_l, ms = B, seg0
        levels = []
        while True:
            if B_l <= min_b:
                ms = fmm.BIG_STEPS
            state = fmm.segment(state, self.idx, q_l, ql_l, nv_l, *consts,
                                ms, cap, cap_s, use_p3)
            # this level's results home (a running lane's are overwritten
            # by a later level's)
            out_seeds[orig] = state["seeds"]
            out_sn[orig] = state["seed_n"]
            out_ovf[orig] = state["ovf"]
            steps, phase = _steps_phase(state)
            alive = np.nonzero(phase != fmm.P_DONE)[0]
            levels.append((B_l, steps, int(alive.size)))
            if alive.size == 0 or ms == fmm.BIG_STEPS:
                break
            B2 = max(min_b, 1 << int(alive.size - 1).bit_length())
            if B2 >= B_l:  # too few lanes retired to shrink: run out
                ms = fmm.BIG_STEPS
                continue
            pad = np.zeros(B2, np.int64)
            pad[:alive.size] = alive
            pidx = torch.from_numpy(pad).to(dev)
            parked = torch.arange(B2, device=dev) >= alive.size
            state = fmm.gather_state(state, pidx)
            state["phase"].masked_fill_(parked, fmm.P_DONE)
            orig = orig[pidx].masked_fill_(parked, B)
            q_l, ql_l, nv_l = q_l[pidx], ql_l[pidx], nv_l[pidx]
            B_l, ms = B2, seg
        self.last_done = (np.zeros(B, np.int32),)
        self.last_steps = (levels[-1][1],)
        self.last_levels = levels
        return out_seeds[:B], out_sn[:B], out_ovf[:B] != 0

    def smem_pass(self, q_pad: np.ndarray, qlen: np.ndarray, x: np.ndarray,
                  min_intv: np.ndarray, max_intv: int, active: np.ndarray,
                  cap: int):
        """One bwt_smem1a call a read on the engine's device (smem1a_batch;
        K10a on a CUDA engine): numpy in, numpy [ret, m0, m1, m2, ms, me,
        mem_n] out."""
        dev = self.device
        out = smem1a_batch(
            self.idx, _to_dev(q_pad, dev), _to_dev(qlen, dev, np.int32),
            _to_dev(x, dev, np.int32),
            _to_dev(min_intv, dev, self.fm.coord_dtype), int(max_intv),
            _to_dev(active, dev, bool), cap, form=smem1a_form(x, active))
        return [o.cpu().numpy() for o in out]

    def seed3_pass(self, q_pad, qlen, x, min_len: int, max_intv: int,
                   active):
        """One bwt_seed_strategy1 call a read on the engine's device
        (seed_strategy1_batch; K10b on a CUDA engine): numpy [ret, found,
        r0, r1, r2, start, end] out."""
        dev = self.device
        out = seed_strategy1_batch(
            self.idx, _to_dev(q_pad, dev), _to_dev(qlen, dev, np.int32),
            _to_dev(x, dev, np.int32), int(min_len), int(max_intv),
            _to_dev(active, dev, bool))
        return [o.cpu().numpy() for o in out]

    def _fetch_seeds(self, seeds, sn, ovf, cap_s: int):
        """Seed transfer (seeds: one array a shard) narrowed to a bucketed
        max(seed_n); an overflowing lane reports seed_n = cap_s + 1 to
        force the caller's retry."""
        m = int(sn.max(initial=0))
        lvl = cap_s
        for cand in (4, 8, 12, 16, 24, 32):
            if m <= cand < cap_s:
                lvl = cand
                break
        sd = np.concatenate([s[:, :lvl].cpu().numpy() for s in seeds])
        sn = np.where(ovf, cap_s + 1, sn)
        out = (sd[:, :, 0], sd[:, :, 1], sd[:, :, 2],
               sd[:, :, 3].astype(np.int32), sd[:, :, 4].astype(np.int32),
               sn)
        if sd.shape[2] > 5:  # sharded run: provenance column last
            out = out + (sd[:, :, 5],)
        return out


def _to_dev(a, dev, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    return torch.from_numpy(a).to(dev)


def _steps_phase(state) -> tuple[int, np.ndarray]:
    """A typed state's steps and per-lane phases on the host, in one
    copy."""
    both = torch.cat([state["steps"], state["phase"]]).cpu().numpy()
    return int(both[0]), both[1:]
