"""Device bounded-difference gapped backward search (bwa aln): the plain
PyTorch versions and their kernels.

Each lane runs ONE read's best-first search (bwt_match_gap, bwtgap.c:
109-264): pop the lowest-score, most recently pushed stack entry, expand
it with one occ4 pair, push up to 9 children.  aln/search.py match_gap is
the executable spec; this machine reproduces its result lists exactly
(same aln order, same early stops), because every observable of the
search depends on the pop order:

- the score-indexed LIFO discipline (gap_stack_t, bwtgap.c:17-84) is a
  per-lane key array: key = score * 2^18 + (2^18-1 - seqno), so the
  minimum key is "lowest score, most recently pushed" and a free slot
  holds SENT;
- seqnos are given in the reference's push call order within a step
  (ins/gape-ext, 4 deletions, 4 substitutions, bwtgap.c:178-253);
- the hit bookkeeping (first-hit max_diff narrowing, best_cnt/max_top2
  stop, tandem duplicate test, gap_shadow width mutation bwtgap.c:86-96)
  runs in the same step as the pop or walk that produced the hit;
- bwt_match_exact_alt (bwt.c:241-256), the m == 0 shortcut, is a per-lane
  walk sub-phase consuming one character a step.

gap_machine_plain and cal_width_plain are line-for-line translations of
the JAX package's ops/gap_machine.py::gap_machine and cal_width_device,
one step of every lane per loop iteration as masked tensor ops, with the
initial state of its driver (aln/batch_search.py::_init_state) folded in.
The CUDA kernels (csrc/gap_machine.cu) run the same machine with a group
of 2R threads per lane until the lane is done: K7 (bwa_gap_machine) the
search, K7w (bwa_cal_width) the width table.  gap_machine and cal_width
dispatch: a CUDA tensor launches the kernel, a CPU tensor takes the plain
version.  The end of this module models the kernels' parts in plain
PyTorch (the group occ4, the stack's bookkeeping, the packed record, the
strided hit bookkeeping) for the CPU tests
(tests/test_torch_gap_rows.py); no search runs them.

Exactness risks that cannot be represented (stack deeper than `cap`, more
than cap_a hits, score/seqno key overflow, max_steps) flag `ovf`; the
driver (aln/batch_search.py) reruns those lanes up a cap ladder and falls
back to the host spec, so every read's result is exact.
"""

from __future__ import annotations

import torch

from bwa_tpu_torch.ops.fm import (_M55, _MFF, _check_occtab, _occ4, _popc32,
                                  _u32)

P_RUN = 0
P_WALK = 1
P_DONE = 2

STATE_M = 0
STATE_I = 1
STATE_D = 2

SENT = 0x7FFFFFFF             # free-slot / empty-stack key sentinel
SEQ_BITS = 18                 # seqno field width inside the pop key
SEQ_CAP = 1 << SEQ_BITS
SCORE_CAP = (SENT >> SEQ_BITS) - 1  # scores >= this overflow the key

# stk_m fields
F_I, F_MM, F_GO, F_GE, F_INS, F_DEL, F_ST, F_LDP = range(8)
NF = 8

# the integer options in the order gap_machine takes them
SCALARS = ("s_mm", "s_gapo", "s_gape", "max_gape", "max_seed_diff",
           "max_entries", "max_del_occ", "indel_end_skip", "max_top2",
           "seed_len")

# launches of K7 and K7w (the CUDA wrappers below add one per launch)
launches = 0
width_launches = 0
# a list to time each K7 launch alone: (start, end) CUDA events around the
# kernel, beside the wrapper's allocations (set by chip_smoke.py)
kernel_events = None

# K7's compact 32-byte record (csrc/gap_machine.cu mirrors these): reads up
# to PACK_L (i, ldp in 10 bits), md + 1, mg and max_gape up to PACK_D (8
# bits), at most PACK_LISTS score lists (a register bitmap); any other
# launch takes the wide-record variant.  FREE_SLOTS freed slots are cached
# a lane, and past them CHUNK at a time go into a freed slot
PACK_L = 512
PACK_D = 255
PACK_LISTS = 128
FREE_SLOTS = 16
CHUNK = 7


def _col4(mat, c):
    """mat[b, c[b]] for a [B, 4] matrix."""
    return mat.gather(1, c[:, None]).squeeze(1)


def _vec_read(vec, pos):
    """vec[b, pos[b]] (vec: [B, L])."""
    return vec.gather(1, pos[:, None]).squeeze(1)


def _read2(wb, p0, p1):
    """(w, bid) rows of wb [B, L, 2] at positions p0 and p1: [B, 2, 2]."""
    pos = torch.stack([p0, p1], dim=1)[:, :, None].expand(-1, -1, 2)
    return wb.gather(1, pos)


def _ilog2(v):
    """aln_score's int_log2 (bwtgap.c:99-107), elementwise on nonnegative
    values."""
    c = torch.zeros_like(v)
    m = v
    for sh, bits in ((16, 0xFFFF0000), (8, 0xFF00), (4, 0xF0), (2, 0xC)):
        t = (m & bits) != 0
        m = torch.where(t, m >> sh, m)
        c = c | torch.where(t, sh, 0)
    return c | torch.where((m & 0x2) != 0, 1, 0)


# --------------------------------------------------------------------------
# K7w: bwt_cal_width
# --------------------------------------------------------------------------

def cal_width(idx, q):
    """bwt_cal_width (bwtaln.c:57-81) batched: per-position (w, bid) lower
    bounds over the ORIGINAL read codes q [B, L].  Returns [B, L, 2] in
    the coordinate dtype; rows past a read's length are garbage (the
    search never reads them).  A CUDA q launches K7w, a CPU q runs the
    plain version."""
    if q.is_cuda:
        return _cal_width_cuda(idx, q)
    return cal_width_plain(idx, q)


def cal_width_plain(idx, q):
    """The plain version of K7w: a scan over the read's positions."""
    cdt = idx["cdt"]
    i64 = torch.int64
    B, L = q.shape
    dev = q.device
    seq_len = idx["seq_len"]
    L2r = idx["L2"][:4].to(i64)[None, :].expand(B, 4)
    k = torch.zeros(B, dtype=i64, device=dev)
    l = torch.full((B,), seq_len, dtype=i64, device=dev)
    bid = torch.zeros(B, dtype=i64, device=dev)
    out = torch.empty((B, L, 2), dtype=i64, device=dev)
    q = q.to(i64)
    for t in range(L):
        c_t = q[:, t]
        cnt = _occ4(idx, torch.cat([k - 1, l])).to(i64)
        okv, olv = cnt[:B], cnt[B:]
        cc = c_t.clamp(0, 3)
        ok = _col4(okv, cc)
        ol = _col4(olv, cc)
        l2c = _col4(L2r, cc)
        good = c_t < 4
        k2 = torch.where(good, l2c + ok + 1, k)
        l2 = torch.where(good, l2c + ol, l)
        reset = (k2 > l2) | ~good
        bid = bid + reset.to(i64)
        k = torch.where(reset, 0, k2)
        l = torch.where(reset, seq_len, l2)
        out[:, t, 0] = l - k + 1
        out[:, t, 1] = bid
    return out.to(cdt)


def _cal_width_cuda(idx, q):
    """Kernel K7w launch: a thread per lane scans its read."""
    global width_launches
    from bwa_tpu_torch.ops import cuda_kernels

    occtab = _check_occtab(idx, "K7w")
    q8 = q.to(torch.uint8).contiguous()
    if not (q8.is_cuda and occtab.is_cuda):
        raise ValueError("K7w inputs must be CUDA tensors")
    B, L = q8.shape
    out = torch.empty((B, L, 2), dtype=idx["cdt"], device=q.device)
    cuda_kernels.cal_width(occtab, idx["L2"].to(torch.int64).contiguous(),
                           idx["primary"], idx["seq_len"], q8, out)
    width_launches += 1
    return out


def _aligned(t):
    """t contiguous at a 16-byte address (K7 reads its (width, bid) pairs
    whole)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


# --------------------------------------------------------------------------
# K7: bwt_match_gap
# --------------------------------------------------------------------------

def gap_machine(idx, q, qlen, md, mg, seed_en, sb, wb, active, scal, *,
                cap: int, cap_a: int, use_seed: bool, f_gape: bool,
                f_nonstop: bool, f_loggap: bool, max_steps: int,
                n_lists: int | None = None) -> dict:
    """Run every active lane's bwt_match_gap to its end.

    q: [B, L] complemented read codes (bwtaln.c:116-117; the search
    consumes q[i-1], q[i-2], ... going backward); qlen, md, mg: per-read
    length, max_diff and (sticky) max_gapo; seed_en [B] bool; sb: [B, SL,
    2] seed-region width table (cal_width over the last seed_len original
    codes), or a [B, 1, 2] dummy when use_seed is False; wb: [B, L, 2]
    width table (cal_width of the read; not modified); active [B] bool
    (an inactive lane ends at once with no hits); scal: the ints named in
    SCALARS.  Returns aln_m [B, cap_a, 6] int32 (mm, go, ge, score, ins,
    del), aln_kl [B, cap_a, 2] coord dtype, n_aln, n_stk, done_step,
    n_occ, n_walk [B] int32 (n_occ: the lane's steps that read an occ4
    pair, its walk and expansion steps; n_walk: its walk steps, which
    need one base's count), ovf [B] bool and steps [1] int32 (the
    longest lane's).

    A CUDA q launches kernel K7, with n_lists stack lists (score_lists of
    the launch's md and mg, computed here when None); a CPU q runs the
    plain version."""
    kw = dict(cap=cap, cap_a=cap_a, use_seed=use_seed, f_gape=f_gape,
              f_nonstop=f_nonstop, f_loggap=f_loggap, max_steps=max_steps)
    if q.is_cuda:
        if n_lists is None:
            n_lists = score_lists(int(md.max()) if md.numel() else 0,
                                  int(mg.max()) if mg.numel() else 0, scal)
        return _gap_machine_cuda(idx, q, qlen, md, mg, seed_en, sb, wb,
                                 active, scal, n_lists=n_lists, **kw)
    return gap_machine_plain(idx, q, qlen, md, mg, seed_en, sb, wb, active,
                             scal, **kw)


def gap_machine_plain(idx, q, qlen, md, mg, seed_en, sb, wb, active, scal,
                      *, cap: int, cap_a: int, use_seed: bool, f_gape: bool,
                      f_nonstop: bool, f_loggap: bool,
                      max_steps: int) -> dict:
    """The plain version of K7, on q's device."""
    (s_mm, s_gapo, s_gape, max_gape, max_seed_diff, max_entries,
     max_del_occ, ies, max_top2, seed_len) = (int(x) for x in scal)
    cdt = idx["cdt"]
    i64 = torch.int64
    dev = q.device
    B, L = q.shape
    SL = sb.shape[1]
    seq_len = idx["seq_len"]
    bidx = torch.arange(B, device=dev)
    q = q.to(i64)
    qlen = qlen.to(i64)
    md = md.to(i64)
    mg = mg.to(i64)
    seed_en = seed_en.to(torch.bool)
    active = active.to(torch.bool)
    sb = sb.to(i64)
    wb = wb.to(i64).clone()
    L2r = idx["L2"][:4].to(i64)[None, :]
    z = lambda *s: torch.zeros(s, dtype=i64, device=dev)  # noqa: E731
    W = torch.where

    def asc(mm, go, ge):
        return mm * s_mm + go * s_gapo + ge * s_gape

    # the driver's initial state: one (i=len, k=0, l=seq_len, STATE_M)
    # entry per active lane (bwtgap.c:136), the local-opt best_score bound
    keys = torch.full((B, cap), SENT, dtype=i64, device=dev)
    keys[:, 0] = W(active, SEQ_CAP - 1, SENT)
    stk_m = z(B, cap, NF)
    stk_m[:, 0, F_I] = qlen
    stk_kl = z(B, cap, 2)
    stk_kl[:, 0, 1] = seq_len
    n_stk = active.to(i64)
    seqc = torch.ones(B, dtype=i64, device=dev)
    best_score = (md + 1) * s_mm + (mg + 1) * s_gapo + (max_gape + 1) * s_gape
    mdc = md.clone()
    phase = W(active, P_RUN, P_DONE)
    wk, wl, wi = z(B), z(B), z(B)
    wmeta = z(B, 7)          # score, mm, go, ge, ins, del, ldp
    best_cnt = torch.zeros(B, dtype=cdt, device=dev)
    aln_m = z(B, cap_a, 6)
    aln_kl = z(B, cap_a, 2)
    n_aln = z(B)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    done_step = z(B)
    n_occ = z(B)
    n_walk = z(B)
    steps = 0
    ar_L = torch.arange(L, device=dev)[None, :]
    jv4 = torch.arange(1, 5, device=dev)[None, :]
    ins9 = torch.tensor([1] + [0] * 8, device=dev)[None, :]
    del9 = torch.tensor([0, 1, 1, 1, 1, 0, 0, 0, 0], device=dev)[None, :]
    st9 = torch.tensor([STATE_I] + [STATE_D] * 4 + [STATE_M] * 4,
                       device=dev)[None, :]
    ar_a = torch.arange(cap_a, device=dev)[None, :]

    while steps < max_steps and bool((phase != P_DONE).any()):
        run = phase == P_RUN
        wstep = phase == P_WALK

        # ---- stack-size stop (bwtgap.c:143: checked before the pop) ----
        brk0 = run & (n_stk > max_entries)
        run = run & ~brk0

        # ---- pop: lowest score, most recent (score-indexed LIFO) ----
        pk, slot = keys.min(dim=1)
        empty = pk == SENT
        do_pop = run & ~empty
        done_empty = run & empty
        keys[bidx, slot] = W(do_pop, SENT, keys[bidx, slot])
        n_stk = n_stk - do_pop.to(i64)
        ent_m = stk_m[bidx, slot]
        ent_kl = stk_kl[bidx, slot]
        e_i = ent_m[:, F_I]
        e_mm, e_go, e_ge = ent_m[:, F_MM], ent_m[:, F_GO], ent_m[:, F_GE]
        e_ins, e_del = ent_m[:, F_INS], ent_m[:, F_DEL]
        e_st, e_ldp = ent_m[:, F_ST], ent_m[:, F_LDP]
        e_k, e_l = ent_kl[:, 0], ent_kl[:, 1]
        score = asc(e_mm, e_go, e_ge)

        # ---- best-first stop (bwtgap.c:146) ----
        brk1 = do_pop & (score > best_score + s_mm)
        if f_nonstop:
            brk1 = torch.zeros_like(brk1)
        alive = do_pop & ~brk1

        m = mdc - (e_mm + e_go) - (e_ge if f_gape else 0)
        cont1 = m < 0
        m_seed = max_seed_diff - (e_mm + e_go) - (e_ge if f_gape else 0)

        # width rows at i-2 and i-1 (post-decrement i2-1 and i2)
        p1 = (e_i - 1).clamp(0, L - 1)
        p0 = (e_i - 2).clamp(0, L - 1)
        wv = _read2(wb, p0, p1)
        ww0, wbid0 = wv[:, 0, 0], wv[:, 0, 1]
        ww1, wbid1 = wv[:, 1, 0], wv[:, 1, 1]
        cont2 = alive & ~cont1 & (e_i > 0) & (m < wbid1)
        live = alive & ~cont1 & ~cont2

        hit0 = live & (e_i == 0)
        exact_c = live & ~hit0 & (m == 0) & \
            ((e_st == STATE_M) | (e_ge == max_gape))
        if f_gape:
            exact_c = live & ~hit0 & (m == 0)
        exp = live & ~hit0 & ~exact_c
        n_occ = n_occ + (wstep | exp).to(i64)
        n_walk = n_walk + wstep.to(i64)

        # start the exact-match walk next step (bwt.c:241-256)
        wk = W(exact_c, e_k, wk)
        wl = W(exact_c, e_l, wl)
        wi = W(exact_c, e_i, wi)
        wmeta_new = torch.stack([score, e_mm, e_go, e_ge, e_ins, e_del,
                                 e_ldp], dim=1)
        wmeta = W(exact_c[:, None], wmeta_new, wmeta)

        # ---- the step's one occ4 pair (expansion OR walk char) ----
        a = W(wstep, wk, e_k)
        b = W(wstep, wl, e_l)
        cnt = _occ4(idx, torch.cat([a - 1, b])).to(i64)
        kk4 = L2r + cnt[:B] + 1
        ll4 = L2r + cnt[B:]

        # ---- walk micro-op: one character of bwt_match_exact_alt ----
        # (the masked blocks below are skipped when no lane is in them)
        j = wi - 1
        i2 = e_i - 1
        walk_done = walk_back = torch.zeros_like(wstep)
        if bool(wstep.any()):
            qpos = W(wstep, j.clamp(0, L - 1), i2.clamp(0, L - 1))
            qc = _vec_read(q, qpos)
            wamb = wstep & (qc > 3)
            qcc = qc.clamp(0, 3)
            wkn = _col4(kk4, qcc)
            wln = _col4(ll4, qcc)
            wfail = wstep & ~wamb & (wkn > wln)
            wok = wstep & ~wamb & ~wfail
            wk = W(wok, wkn, wk)
            wl = W(wok, wln, wl)
            wi = W(wok, j, wi)
            walk_done = wok & (j == 0)
            walk_back = wamb | wfail | walk_done      # -> P_RUN
        else:
            qc = _vec_read(q, i2.clamp(0, L - 1))

        # ---- hit processing (same step; one event per lane) ----
        hit = hit0 | walk_done
        brk2 = torch.zeros_like(hit)
        if bool(hit.any()):
            hsc = W(walk_done, wmeta[:, 0], score)
            hmm = W(walk_done, wmeta[:, 1], e_mm)
            hgo = W(walk_done, wmeta[:, 2], e_go)
            hge = W(walk_done, wmeta[:, 3], e_ge)
            hins = W(walk_done, wmeta[:, 4], e_ins)
            hdel = W(walk_done, wmeta[:, 5], e_del)
            hldp = W(walk_done, wmeta[:, 6], e_ldp)
            hk = W(walk_done, wk, e_k)
            hl = W(walk_done, wl, e_l)

            first = hit & (n_aln == 0)
            best_score = W(first, hsc, best_score)
            bd = hmm + hgo + (hge if f_gape else 0)
            if not f_nonstop:
                mdc = W(first, torch.minimum(md, bd + 1), mdc)
            same_best = hsc == best_score
            brk2 = hit & ~same_best & (best_cnt > max_top2)
            best_cnt = best_cnt + W(hit & same_best, hl - hk + 1, 0).to(cdt)
            # tandem-repeat duplicate (bwtgap.c:166-169)
            aslot = ar_a < n_aln[:, None]
            dup = (hgo > 0) & (aslot & (aln_kl[:, :, 0] == hk[:, None])
                               & (aln_kl[:, :, 1] == hl[:, None])).any(dim=1)
            add = hit & ~brk2 & ~dup
            ai = add.nonzero().flatten()
            if ai.numel():
                # gap_shadow (bwtgap.c:86-96) over width[0:ldp]
                x = (hl - hk + 1)[ai, None]
                w0 = wb[ai, :, 0]
                tmask = ar_L < hldp[ai, None]
                weq = tmask & (w0 == x)
                wgt = tmask & (w0 > x)
                jj = torch.cumsum(weq.to(i64), dim=1)
                wb[ai, :, 0] = W(wgt, w0 - x, W(weq, seq_len - jj, w0))
                wb[ai, :, 1] = W(weq, 1, wb[ai, :, 1])
                # append the hit (the last slot is overwritten once full;
                # n_aln keeps counting)
                aslot_i = n_aln[ai].clamp(max=cap_a - 1)
                aln_m[ai, aslot_i] = torch.stack(
                    [hmm, hgo, hge, hsc, hins, hdel], dim=1)[ai]
                aln_kl[ai, aslot_i] = torch.stack([hk, hl], dim=1)[ai]
                ovf = ovf | (add & (n_aln >= cap_a))
                n_aln = n_aln + add.to(i64)

        # ---- expansion: allow gates (bwtgap.c:186-199) ----
        occv = e_l - e_k + 1
        ii = i2 - (qlen - seed_len)
        in_band = i2 > 0
        w_block = in_band & (wbid0 > m - 1)
        allow_diff = ~w_block
        allow_M = ~(in_band & ~w_block & (wbid0 == m - 1)
                    & (wbid1 == m - 1) & (ww0 == ww1))
        if use_seed:
            sv = _read2(sb, (ii - 1).clamp(0, SL - 1), ii.clamp(0, SL - 1))
            sw0, sbid0 = sv[:, 0, 0], sv[:, 0, 1]
            sw1, sbid1 = sv[:, 1, 0], sv[:, 1, 1]
            sgate = seed_en & in_band & (ii > 0)
            s_block = sgate & (sbid0 > m_seed - 1)
            allow_diff = allow_diff & ~s_block
            allow_M = allow_M & ~(sgate & ~s_block & (sbid0 == m_seed - 1)
                                  & (sbid1 == m_seed - 1) & (sw0 == sw1))

        tmp = _ilog2(e_ge + e_go) // 2 + 1 if f_loggap else e_go + e_ge
        ggate = exp & allow_diff & (i2 >= ies + tmp) & \
            (qlen - i2 >= ies + tmp)

        # ---- the 9 push candidates, in the reference's push order ----
        # [B, 9] per field: slot 0 an M-state gap open (insertion) or an
        # I-state gap extension; slots 1-4 deletions (M-state open / D-state
        # extension) by base; slots 5-8 substitutions j = 1..4 (bwtgap.c:
        # 232-246), where, when allow_M is off but the exact char exists,
        # only the j = 4 match push happens (the elif at bwtgap.c:247-253)
        stM = e_st == STATE_M
        stI = e_st == STATE_I
        stD = e_st == STATE_D
        v0 = ggate & ((stM & (e_go < mg)) | (stI & (e_ge < max_gape)))
        dM = stM & (e_go < mg)
        dD = stD & (e_ge < max_gape) & \
            ((e_ge + e_go < mdc) | (occv < max_del_occ))
        vd = (ggate & (dM | dD))[:, None] & (kk4 <= ll4)
        both = allow_diff & allow_M
        cj = (qc[:, None] + jv4) & 3
        kkj = kk4.gather(1, cj)
        llj = ll4.gather(1, cj)
        is_mm = torch.cat([torch.ones_like(kkj[:, :3], dtype=torch.bool),
                           (qc > 3)[:, None]], dim=1)
        vs = exp[:, None] & (kkj <= llj) & torch.cat(
            [both[:, None].expand(-1, 3), (both | (qc < 4))[:, None]], dim=1)
        valid = torch.cat([v0[:, None], vd, vs], dim=1)   # [B, 9]

        def c9(first, dels, subs):
            return torch.cat([first[:, None], dels[:, None].expand(-1, 4),
                              subs], dim=1)

        i2b = i2[:, None].expand(-1, 4)
        z4 = torch.zeros_like(kkj)
        rows_m = torch.stack([
            c9(i2, e_i, i2b),
            c9(e_mm, e_mm, e_mm[:, None] + is_mm.to(i64)),
            c9(e_go + stM.to(i64), e_go + dM.to(i64), e_go[:, None] + z4),
            c9(e_ge + stI.to(i64), e_ge + dD.to(i64), e_ge[:, None] + z4),
            e_ins[:, None] + ins9, e_del[:, None] + del9,
            st9.expand(B, -1), c9(i2, e_i, W(is_mm, i2b, 0))],
            dim=2)                                         # [B, 9, NF]
        rows_kl = torch.stack([torch.cat([e_k[:, None], kk4, kkj], dim=1),
                               torch.cat([e_l[:, None], ll4, llj], dim=1)],
                              dim=2)                       # [B, 9, 2]
        scs = asc(rows_m[:, :, F_MM], rows_m[:, :, F_GO], rows_m[:, :, F_GE])

        vi = valid.to(i64)
        rank = torch.cumsum(vi, dim=1) - vi               # exclusive
        seqno = seqc[:, None] + rank
        keys_p = scs * SEQ_CAP + (SEQ_CAP - 1 - seqno)
        n_push = vi.sum(dim=1)
        ovf = ovf | (exp & (((scs * vi).max(dim=1).values >= SCORE_CAP)
                            | (seqc + n_push >= SEQ_CAP)))
        seqc = seqc + n_push

        # candidate with valid-rank r -> the (r+1)-th free slot
        cumfree = torch.cumsum((keys == SENT).to(i64), dim=1)  # [B, cap]
        nfree = cumfree[:, -1]
        ovf = ovf | (n_push > nfree)
        put = valid & (rank < nfree[:, None])
        if bool(put.any()):
            # the first slot where cumfree reaches rank + 1
            tgt = torch.searchsorted(cumfree, rank + 1).clamp(max=cap - 1)
            pb = bidx[:, None].expand(-1, 9)[put]
            ps = tgt[put]
            keys[pb, ps] = keys_p[put]
            stk_m[pb, ps] = rows_m[put]
            stk_kl[pb, ps] = rows_kl[put]
        n_stk = n_stk + torch.minimum(n_push, nfree)

        # ---- phase transitions ----
        done = brk0 | done_empty | brk1 | brk2 | ovf
        phase = W(done, P_DONE, W(exact_c, P_WALK,
                                  W(walk_back, P_RUN, phase)))
        newly = done & (done_step == 0)
        done_step = W(newly, steps + 1, done_step)
        steps += 1

    # lanes stopped by max_steps: results incomplete -> host fallback
    ovf = ovf | (phase != P_DONE)
    i32 = torch.int32
    return dict(aln_m=aln_m.to(i32), aln_kl=aln_kl.to(cdt),
                n_aln=n_aln.to(i32), n_stk=n_stk.to(i32),
                done_step=done_step.to(i32), n_occ=n_occ.to(i32),
                n_walk=n_walk.to(i32), ovf=ovf,
                steps=torch.tensor([steps], dtype=i32, device=dev))


def score_lists(md_max: int, mg_max: int, scal) -> int:
    """The number of score lists K7's stack needs for lanes whose md and
    mg are at most md_max and mg_max: one a score up to the most a pushed
    entry can have, (md_max + 1) * s_mm + mg_max * s_gapo + max_gape *
    s_gape (a child adds a mismatch only to a parent with m >= 0, a gap
    open only below mg, a gap extension only below max_gape), or up to
    SCORE_CAP, past which the key overflows (ovf)."""
    s_mm, s_gapo, s_gape, max_gape = (int(x) for x in scal[:4])
    if min(s_mm, s_gapo, s_gape, max_gape) < 0:
        raise ValueError("K7 takes non-negative penalties and max_gape")
    top = (int(md_max) + 1) * s_mm + int(mg_max) * s_gapo \
        + max_gape * s_gape
    return min(top, SCORE_CAP) + 1


def slot_bytes(cdt, wide: bool = False) -> int:
    """Bytes of one K7 stack slot: k, l, a list link and the eight small
    fields packed into 32 bytes, or in the wide-record variant the eight
    fields as int32, padded to 16-byte vectors (48, or 64 with int64
    coordinates)."""
    if not wide:
        return 32
    return 48 if cdt == torch.int32 else 64


def wide_records(L: int, md_max: int, mg_max: int, scal,
                 n_lists: int) -> bool:
    """Whether a K7 launch takes the wide-record variant: a read longer
    than PACK_L, md + 1, mg or max_gape past PACK_D, or more than
    PACK_LISTS score lists."""
    return not (L <= PACK_L and int(md_max) + 1 <= PACK_D
                and int(mg_max) <= PACK_D and int(scal[3]) <= PACK_D
                and n_lists <= PACK_LISTS)


def overflow_causes(out, cap: int, cap_a: int) -> dict:
    """Why a K7 launch's lanes overflowed, from its outputs: max_steps (the
    lane never ended), cap_a (more hits than cap_a), stack (the pool
    full: n_stk == cap), other (a score or seqno past the key)."""
    ovf = out["ovf"].bool()
    steps = ovf & (out["done_step"] == 0)
    hits = ovf & ~steps & (out["n_aln"] > cap_a)
    stack = ovf & ~steps & ~hits & (out["n_stk"] == cap)
    return dict(stack=int(stack.sum()), cap_a=int(hits.sum()),
                max_steps=int(steps.sum()),
                other=int((ovf & ~steps & ~hits & ~stack).sum()))


def _gap_machine_cuda(idx, q, qlen, md, mg, seed_en, sb, wb, active, scal,
                      *, cap, cap_a, use_seed, f_gape, f_nonstop, f_loggap,
                      max_steps, n_lists) -> dict:
    """Kernel K7 launch: a group of 2R threads per lane runs its search to
    its end (or to max_steps), a persistent grid taking lanes from a
    counter; its stack (the reference's one LIFO list a score over a pool
    of `cap` slots) keeps its bookkeeping in registers and shared memory
    and its slots in global scratch allocated here."""
    global launches
    from bwa_tpu_torch.ops import cuda_kernels

    occtab = _check_occtab(idx, "K7")
    cdt = idx["cdt"]
    dev = q.device
    B, L = q.shape
    i32 = torch.int32
    if cap < 1 or cap_a < 1:
        raise ValueError("K7 needs cap >= 1 and cap_a >= 1")
    if sb.dtype != cdt or wb.dtype != cdt or wb.shape != (B, L, 2):
        raise ValueError("K7's width tables must be [B, *, 2] in the "
                         "coordinate dtype")
    for t in (q, qlen, md, mg, seed_en, sb, wb, active, occtab):
        if not t.is_cuda:
            raise ValueError("K7 inputs must be CUDA tensors")
    wide = wide_records(L, int(md.max()) if B else 0,
                        int(mg.max()) if B else 0, scal, n_lists)
    q8 = q.to(torch.uint8).contiguous()
    # the search rewrites its width table (gap_shadow): a copy per launch
    wb_run = wb.clone().contiguous()
    nbw = (n_lists + 31) // 32
    heads = torch.empty((B, n_lists) if wide else (1,), dtype=i32,
                        device=dev)
    bits = torch.empty((B, nbw) if wide else (1,), dtype=i32, device=dev)
    pool = torch.empty((B, cap, slot_bytes(cdt, wide) // 4), dtype=i32,
                       device=dev)
    aln_m = torch.zeros((B, cap_a, 6), dtype=i32, device=dev)
    aln_kl = torch.zeros((B, cap_a, 2), dtype=cdt, device=dev)
    n_aln = torch.empty(B, dtype=i32, device=dev)
    n_stk = torch.empty(B, dtype=i32, device=dev)
    done_step = torch.empty(B, dtype=i32, device=dev)
    n_occ = torch.empty(B, dtype=i32, device=dev)
    n_walk = torch.empty(B, dtype=i32, device=dev)
    ovf = torch.empty(B, dtype=torch.uint8, device=dev)
    steps = torch.zeros(2, dtype=i32, device=dev)  # + the lane counter
    ev = kernel_events is not None
    if ev:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    cuda_kernels.gap_machine(
        occtab, idx["L2"].to(torch.int64).contiguous(), idx["primary"],
        idx["seq_len"], q8, qlen.to(i32).contiguous(),
        md.to(i32).contiguous(), mg.to(i32).contiguous(),
        seed_en.to(torch.uint8).contiguous(), _aligned(sb), wb_run,
        active.to(torch.uint8).contiguous(), [int(x) for x in scal],
        min(int(max_steps), 2**31 - 1), cap, cap_a, bool(use_seed),
        bool(f_gape), bool(f_nonstop), bool(f_loggap), wide, n_lists, heads,
        bits, pool, aln_m, aln_kl, n_aln, n_stk, done_step, n_occ, n_walk,
        ovf, steps)
    if ev:
        e1.record()
        kernel_events.append((e0, e1))
    launches += 1
    return dict(aln_m=aln_m, aln_kl=aln_kl, n_aln=n_aln, n_stk=n_stk,
                done_step=done_step, n_occ=n_occ, n_walk=n_walk,
                ovf=ovf.bool(),
                steps=steps[:1])


# --------------------------------------------------------------------------
# K7 and K7w's parts in plain PyTorch (tests/test_torch_gap_rows.py): what
# each thread of a group holds, step by step as csrc/gap_machine.cu does it
# --------------------------------------------------------------------------

def group_occ4_pair(idx, ka, kb, G: int):
    """occ4_pair of csrc/gap_machine.cu: the G = 2H threads of a group look
    up occ4 at ka and kb [N] (threads [0, H) count B[0..ka], [H, 2H)
    B[0..kb], 8 text words each), sum packed 10-bit counts of bases 1-3 by
    xor shuffles within each half, and exchange the four counts between
    the halves.  Returns oa, ob [N, G, 4] int64: what each thread holds."""
    i64 = torch.int64
    occ = idx["occtab"]
    nw = occ.shape[1] - 4
    H = G // 2
    if nw != 8 * H:
        raise ValueError("a group has 2R threads, 8 text words each")
    rb = (nw // 8).bit_length() - 1
    seq_len, primary = idx["seq_len"], idx["primary"]
    L2 = idx["L2"].to(i64)
    ka, kb = ka.to(i64), kb.to(i64)
    packed, base, k_of = [], [], []
    for gl in range(G):
        half = gl >= H
        h = gl - H if half else gl
        k = kb if half else ka
        kk = (k - (k >= primary).to(i64)).clamp(0, seq_len - 1)
        row = occ[kk >> (7 + rb)]
        kw, kbit = (kk >> 4) & (nw - 1), kk & 15
        p = torch.zeros_like(k)
        for t in range(8):
            nkeep = (kw - (h * 8 + t)) * 16 + kbit + 1
            shift = (16 - nkeep.clamp(1, 15)) << 1
            mask = torch.where(nkeep <= 0, 0, torch.where(
                nkeep >= 16, _MFF, (_MFF << shift) & _MFF))
            word = _u32(row[:, 4 + h * 8 + t]) & mask
            hi, lo = (word >> 1) & _M55, word & _M55
            n3 = _popc32(hi & lo)
            p = p + ((_popc32(lo) - n3) | ((_popc32(hi) - n3) << 10)
                     | (n3 << 20))
        packed.append(p)
        base.append((_u32(row[:, :4]), kw * 16 + kbit + 1))
        k_of.append(k)
    off = 1
    while off < H:  # __shfl_xor_sync within each half
        packed = [packed[gl] + packed[gl ^ off] for gl in range(G)]
        off <<= 1
    o = []
    L2d = (L2[1:5] - L2[:4])[None, :]
    for gl in range(G):
        p, (cnt, npos), k = packed[gl], base[gl], k_of[gl]
        n1, n2, n3 = p & 1023, (p >> 10) & 1023, p >> 20
        v = cnt + torch.stack([npos - n1 - n2 - n3, n1, n2, n3], dim=1)
        v = torch.where((k == seq_len)[:, None], L2d, v)
        o.append(torch.where((k == -1)[:, None], 0, v))
    oa = torch.stack([o[gl ^ H] if gl >= H else o[gl] for gl in range(G)],
                     dim=1)
    ob = torch.stack([o[gl] if gl >= H else o[gl ^ H] for gl in range(G)],
                     dim=1)
    return oa, ob


def pack_record(e: dict, nxt: int, cdt, wide: bool) -> list:
    """A stack entry (k, l, i, mm, go, ge, ins, del, st, ldp) and its list
    link as the int32 words of K7's slot (slot_bytes(cdt, wide) / 4)."""
    w = [0] * (slot_bytes(cdt, wide) // 4)
    if cdt == torch.int64:
        w[:4] = [_s32(e["k"]), _s32(e["k"] >> 32), _s32(e["l"]),
                 _s32(e["l"] >> 32)]
        o = 4
    else:
        w[:2] = [_s32(e["k"]), _s32(e["l"])]
        o = 2
    w[o] = nxt
    if wide:
        w[o + 1:o + 9] = [e[f] for f in ("i", "ldp", "st", "mm", "go", "ge",
                                         "ins", "del")]
    else:
        w[o + 1] = _s32(e["i"] | e["ldp"] << 10 | e["st"] << 20)
        w[o + 2] = _s32(e["mm"] | e["go"] << 8 | e["ge"] << 16)
        w[o + 3] = _s32(e["ins"] | e["del"] << 16)
    return w


def unpack_record(w: list, cdt, wide: bool):
    """pack_record's inverse: (entry, link)."""
    if cdt == torch.int64:
        k = _s64(w[0] & _MFF | (w[1] & _MFF) << 32)
        l_ = _s64(w[2] & _MFF | (w[3] & _MFF) << 32)
        o = 4
    else:
        k, l_, o = w[0], w[1], 2
    e = dict(k=k, l=l_)
    if wide:
        e.update(zip(("i", "ldp", "st", "mm", "go", "ge", "ins", "del"),
                     w[o + 1:o + 9]))
    else:
        a, b, c = (x & _MFF for x in w[o + 1:o + 4])
        e.update(i=a & 1023, ldp=(a >> 10) & 1023, st=(a >> 20) & 3,
                 mm=b & 255, go=(b >> 8) & 255, ge=(b >> 16) & 255,
                 ins=c & 0xFFFF)
        e["del"] = c >> 16
    return e, w[o]


def _s32(x: int) -> int:
    x &= _MFF
    return x - (1 << 32) if x >> 31 else x


def _s64(x: int) -> int:
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


class StackModel:
    """K7's stack for one lane as csrc/gap_machine.cu keeps it: score lists
    whose heads and non-empty bitmap are on chip, the next pop in
    registers (the newest child an expansion pushes onto the list it
    popped from), freed slots in a stack of FREE_SLOTS and past it in
    chunks of CHUNK in the pool, and the pool's packed records.  step()
    takes one pop and its children as the kernel does; the plain
    version's key array is the reference (tests/test_torch_gap_rows.py)."""

    def __init__(self, cap: int, nb: int, cdt=torch.int32,
                 wide: bool = False):
        self.cap, self.nb, self.cdt, self.wide = cap, nb, cdt, wide
        self.pool = [[0] * (slot_bytes(cdt, wide) // 4) for _ in range(cap)]
        self.heads = [0] * nb
        self.bits = 0
        self.lo = nb
        self.fs, self.hw, self.gfree = [], 0, -1
        self.nx = None
        self.n_stk = 0
        self.loads = 0  # loads of the pool's free list (chunk refills)

    def root(self, e: dict) -> None:
        self.nx, self.n_stk = dict(e), 1

    def _first(self) -> int:
        b = self.bits
        return (b & -b).bit_length() - 1 if b else self.nb

    def pop(self):
        """The least entry, and the slot it freed (-1 for the next pop kept
        in registers)."""
        if self.nx is not None:
            e, self.nx, fslot = self.nx, None, -1
        else:
            sel = self.heads[self.lo]
            e, nxt = unpack_record(self.pool[sel], self.cdt, self.wide)
            self.heads[self.lo] = nxt
            if nxt < 0:
                self.bits &= ~(1 << self.lo)
                self.lo = self._first()
            fslot = sel
        self.n_stk -= 1
        return e, fslot

    def push(self, bkp: int, kids: list, fslot: int):
        """The children of the entry popped from list bkp, in push order:
        (valid, score, entry); returns (n_push, nfree, the slot freed and
        not taken, or -1)."""
        nb, nfree = self.nb, self.cap - self.n_stk
        bk = [min(max(sc, 0), nb - 1) for _, sc, _ in kids]
        pushed, n_push, cc = [], 0, -1
        for c, (v, _, _) in enumerate(kids):
            pushed.append(v and n_push < nfree)
            n_push += v
            if pushed[c] and bk[c] == bkp:
                cc = c
        st = [p and c != cc for c, p in enumerate(pushed)]
        n_st, have_f = sum(st), int(fslot >= 0)
        while have_f + len(self.fs) + self.cap - self.hw < n_st:
            ch = self.pool[self.gfree]
            self.loads += 1
            self.fs += ch[:CHUNK] + [self.gfree]
            self.gfree = ch[CHUNK]
        slot, link, r = [], [], 0
        for c in range(len(kids)):
            s = -1
            if st[c]:
                r2 = r - have_f
                s = fslot if r2 < 0 else (
                    self.fs[-1 - r2] if r2 < len(self.fs)
                    else self.hw + r2 - len(self.fs))
                r += 1
            slot.append(s)
            lk = self.heads[bk[c]] if self.bits >> bk[c] & 1 else -1
            for d in range(c):
                if st[d] and bk[d] == bk[c]:
                    lk = slot[d]
            link.append(lk)
        used_f = min(n_st, have_f)
        from_fs = min(n_st - used_f, len(self.fs))
        self.hw += n_st - used_f - from_fs
        del self.fs[len(self.fs) - from_fs:]
        for c, (_, _, e) in enumerate(kids):
            if c == cc:
                self.nx = dict(e)
            if st[c]:
                self.pool[slot[c]] = pack_record(e, link[c], self.cdt,
                                                 self.wide)
                if not any(st[d] and bk[d] == bk[c]
                           for d in range(c + 1, len(kids))):
                    self.heads[bk[c]] = slot[c]
                    self.bits |= 1 << bk[c]
                    self.lo = min(self.lo, bk[c])
        self.n_stk += min(n_push, nfree)
        assert self.hw <= self.cap
        return n_push, nfree, -1 if used_f else fslot

    def free(self, fslot: int) -> None:
        """The popped slot no child took: onto the stack, or spill CHUNK of
        the stack into it."""
        if fslot < 0:
            return
        if len(self.fs) < FREE_SLOTS:
            self.fs.append(fslot)
            return
        self.pool[fslot][:CHUNK + 1] = self.fs[-CHUNK:] + [self.gfree]
        del self.fs[-CHUNK:]
        self.gfree = fslot


def shadow_strided(w, x: int, tn: int, seq_len: int, G: int):
    """gap_shadow (bwtgap.c:86-96) over w[:tn] ([L, 2] int64, modified in
    place) as a group of G threads does it: G positions a round, each
    equal width's rank in the running count from a ballot and a
    popcount."""
    jj = 0
    for t0 in range(0, tn, G):
        t = torch.arange(t0, t0 + G)
        inn = t < tn
        tt = t.clamp(max=max(tn - 1, 0))
        wv = torch.where(inn, w[tt, 0], 0)
        eq = inn & (wv == x)
        rank = torch.cumsum(eq.to(torch.int64), 0) - eq.to(torch.int64)
        for g in range(G):
            if eq[g]:
                w[t0 + g, 0] = seq_len - (jj + int(rank[g]) + 1)
                w[t0 + g, 1] = 1
            elif inn[g] and wv[g] > x:
                w[t0 + g, 0] = wv[g] - x
        jj += int(eq.sum())
    return w


def dup_strided(akl, na: int, hk: int, hl: int, G: int) -> bool:
    """The tandem duplicate test (bwtgap.c:166-169) over the first na hits
    (akl [cap_a, 2]) by G threads, hit s by thread s mod G, then a vote."""
    votes = [any(int(akl[s, 0]) == hk and int(akl[s, 1]) == hl
                 for s in range(g, na, G)) for g in range(G)]
    return any(votes)
