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
batch's lanes over the mesh's devices.
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


def _occ4(idx, k):
    """Counts of each base in B[0..k] inclusive; k: [N] coord ints.
    Handles k == -1 (zeros) and k == seq_len (L2 diffs) like bwt_occ4."""
    cdt = idx["cdt"]
    k = k.to(torch.int64)
    kk = k - (k >= idx["primary"]).to(torch.int64)
    kk_safe = kk.clamp(0, idx["seq_len"] - 1)
    if "occtab" in idx:
        nw = idx["occtab"].shape[1] - 4          # 8R words per row
        rbits = (nw // 8).bit_length() - 1       # log2(R)
        row = idx["occtab"][kk_safe >> (7 + rbits)]
        base = _u32(row[:, :4])
        blk = _u32(row[:, 4:])
    else:
        nw = 8
        j = kk_safe >> 7
        base = idx["ckpt"][j].to(torch.int64)
        blk = _u32(idx["words"][j])
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
    word = _u32(idx["words"][x >> 7, (x >> 4) & 7])
    return ((word >> ((15 - (x & 15)) << 1)) & 3).to(torch.int32)


def _occ1(idx, k, c):
    """Single-base occ: count of base c in B[0..k] (bwt_occ semantics for
    k in [0, seq_len))."""
    cdt = idx["cdt"]
    k = k.to(torch.int64)
    c = c.to(torch.int64)
    kk = k - (k >= idx["primary"]).to(torch.int64)
    kk_safe = kk.clamp(0, idx["seq_len"] - 1)
    j = kk_safe >> 7
    base = idx["ckpt"][j, c].to(torch.int64)
    mask = _masks((kk_safe >> 4) & 7, kk_safe & 15, 8)
    w = _u32(idx["words"][j]) & mask
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


def _probe_breaks_cuda(idx, q):
    """Kernel K8 launch: a group of 2R threads a read, a lookup only where
    the read's interval extends."""
    global probe_launches
    from bwa_tpu_torch.ops import cuda_kernels

    occtab = idx.get("occtab")
    if occtab is None or not (q.is_cuda and occtab.is_cuda):
        raise ValueError("K8 reads the fused occtab and CUDA codes")
    if occtab.dtype != torch.int32 or occtab.data_ptr() % 16 \
            or occtab.shape[1] - 4 not in (8, 32):
        raise ValueError("K8 reads an int32 occtab of 8 or 32 text words a "
                         "row (R = 1 or 4), aligned to 16 bytes")
    q8 = q.to(torch.uint8).contiguous()
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    cuda_kernels.probe_breaks(
        occtab, idx["L2"].to(torch.int64).contiguous(), idx["primary"],
        idx["seq_len"], idx["cdt"] == torch.int64, q8, out)
    probe_launches += 1
    return out


def unported_routes() -> None:
    """Raise on the JAX package's seeding routes that the port does not
    have yet, rather than take the default route without a word."""
    if os.environ.get("BWA_TPU_SEED_MACHINE", "unified") == "split":
        raise NotImplementedError(
            "BWA_TPU_SEED_MACHINE=split (the three-call seeding route) is "
            "not ported yet; unset it for the unified machine")
    if os.environ.get("BWA_TPU_SEED_COMPACT"):
        raise NotImplementedError(
            "BWA_TPU_SEED_COMPACT (K1's tail-compaction mode) is not ported "
            "yet; unset it")


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
        return self.fm.sa_lookup(ks)

    # ---- seeding ----

    def _consts(self, opt, L: int, stack_cap):
        unported_routes()
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
        return self._fetch_seeds(seeds, meta[0], meta[1] != 0, cap_s)

    def collect_seeds(self, q_pad: np.ndarray, qlen: np.ndarray, opt,
                      cap_s: int, stack_cap: int | None = None, shard=None):
        """3-pass seed collection on the device, dispatch + wait back to
        back.  Returns numpy (s0, s1, s2, ss, se, seed_n[, tag])."""
        h = self.collect_seeds_dispatch(q_pad, qlen, opt, cap_s, stack_cap,
                                        shard=shard)
        return self.collect_seeds_wait(h)

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
