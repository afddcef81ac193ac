"""Per-lane SMEM seeding machine: the plain PyTorch version and its kernel.

Each lane runs its own state machine -- acquire the next start, forward
pass, backward pass, chain to the next start -- through all three seeding
passes of mem_collect_intv (bwamem.c:140-188): pass 1 SMEMs (bwt_smem1a,
bwt.c:289-351), pass 2 re-seeding from the midpoints of long unique SMEMs,
pass 3 LAST-like seeds (bwt_seed_strategy1, bwt.c:358-379).

seed_machine_seg is the plain version: one machine step of every lane per
loop iteration as masked tensor ops, a line-for-line port of the JAX
package's ops/fm_machine.py::seed_machine_seg, retire-and-refill mode and
segmented runs (max_steps, resumed from the state it returns) included;
a stage range (last_stage, and a fixed pass-2 job table) runs one pass
alone, as the JAX package's smem_machine and seed3_machine do.  The CUDA
kernel (csrc/seed_machine.cu, kernel K1) runs the same machine with a warp
per lane until the lane is done, extending all entries of a backward row
at once; bwd_row_resolve is the plain form of how it orders that row's
pushes and emit.  Its refill mode runs a warp a lane below twice the lanes
resident at once, and from there in a group form, 2R threads a lane
taking one plain step at a time (a backward row one entry a step:
bwd_row_serial).  Its state mode (segment: the per-lane state loaded from
and stored to the state dict, a step budget, a stage range) runs the
split route's passes (smem_machine, seed3_machine: K12) and the tail
compaction's segments (K13).
seed_machine, seed_machine_refill, segment, smem_machine and seed3_machine
dispatch: a CUDA tensor launches the kernel, a CPU tensor takes the plain
version.

Emission order within a lane differs from the reference's collection
order; sort_seeds (stable by (start, end)) makes the result identical.
"""

from __future__ import annotations

import numpy as np
import torch

from bwa_tpu_torch.ops.fm import _check_occtab, _occ4, _set_intv

P_NEXT = 0
P_FWD = 1
P_BWD = 2
P_DONE = 3

S_P1, S_P2, S_P3 = 0, 1, 2


def _push_row(buf, n, mask, row, cap):
    """buf: [B, cap, W]; row: [B, W]; conditional append per lane (the
    last slot is overwritten once full; n keeps counting).  In place."""
    bidx = torch.arange(buf.shape[0], device=buf.device)
    slot = torch.clamp(n, max=cap - 1)
    cur = buf[bidx, slot]
    buf[bidx, slot] = torch.where(mask[:, None], row.to(buf.dtype), cur)
    return buf, n + mask.to(n.dtype), mask & (n >= cap)


def _row_read(buf, pos):
    return buf[torch.arange(buf.shape[0], device=buf.device), pos]


def seed_state_init(B: int, cap: int, cap_s: int, device,
                    tagged: bool = False,
                    job_lo: np.ndarray | None = None) -> dict:
    """Fresh per-lane machine state (lanes start in P_NEXT/pass-1).  All
    coordinates are held as int64 here; seeds leave in the coord dtype.

    tagged: seeds get a 6th provenance column (0 = pass-1, -1 = pass-3,
    else the pass-2 source seed's (start<<15)|end).  job_lo: per-lane
    initial start-position cursor (lane sharding of one long read)."""
    i64 = torch.int64
    z = lambda *s: torch.zeros(s, dtype=i64, device=device)  # noqa: E731
    b = lambda v: torch.full((B,), v, dtype=torch.bool, device=device)  # noqa: E731
    return dict(
        phase=torch.full((B,), P_NEXT, dtype=i64, device=device),
        stage=z(B), old_n=z(B),
        job=(torch.as_tensor(job_lo.astype(np.int64), device=device)
             if job_lo is not None else z(B)),
        x=z(B), minv=torch.ones(B, dtype=i64, device=device), ik=z(B, 3),
        info_end=z(B), i=z(B), j=z(B),
        stkA=z(B, cap, 4), an=z(B), stkB=z(B, cap, 4), bn=z(B),
        cur_is_a=b(True), rev_read=b(True), last_x2=z(B),
        call_last_start=z(B), call_mem_n=z(B), ret=z(B),
        seeds=z(B, cap_s, 6 if tagged else 5), seed_n=z(B),
        qmask=torch.zeros((B, cap_s), dtype=torch.bool, device=device),
        cur_tag=z(B), steps=0, ovf=b(False), done_step=z(B),
        # refill mode: each lane's current read, the first seed slot of that
        # read, and the shared queue cursor
        read_idx=z(B), seed_base=z(B), qctr=0)


def seed_machine_seg(d: dict, idx: dict, q, qlen, next_valid, min_seed_len,
                     split_len, split_width, max_intv3, max_steps: int,
                     cap: int, cap_s: int, use_p3: bool, hi1=None, hi3=None,
                     tagged: bool = False, refill: bool = False,
                     n_queue: int = 0, cap_r: int = 0,
                     last_stage: int = S_P3, jobs=None) -> dict:
    """Run at most max_steps more machine steps over every lane (the plain
    version of kernel K1; K13 in its state mode).  q: [B, L] codes; qlen,
    hi1, hi3: [B]; nv: [B, L+1] next-valid table.  Updates and returns the
    state dict; a later call with the same inputs resumes it exactly.

    Stage range: a lane starts in the stage its state holds and is done
    when it exhausts last_stage's jobs.  jobs: a fixed [B, cap_s, 5] table
    of pass-2 jobs (the rows of a finished pass 1), read in place of the
    live seed store and its qualification bits (the JAX package's
    smem_machine(pass2=True) fixes its job tables at entry).

    Lane sharding (long reads): hi1/hi3 bound the pass-1/pass-3 start
    cursors per lane (defaults: qlen).  With K lanes per read, lane k
    takes pass-1 starts in [job_lo_k, hi1_k) -- exact because every
    maximal exact match starting in a lane's range passes through one of
    that lane's visited positions (the bwt_smem1 chain argument,
    bwt.c:289-351, per range) -- and runs pass 2 for the seeds it found;
    the `tagged` provenance column lets the demux drop cross-lane
    duplicates exactly.  Pass 3's seeds depend on the visit sequence
    (bwt.c:358-379), so only lane 0 of a read runs it (hi3 = qlen there,
    0 elsewhere).

    Retire-and-refill (refill=True, tagged): q is instead the per-read
    table [N, 2L+2] of ops/fm.py::_refill_table (qlen | chars | next
    valid) and qlen, next_valid are unused; each lane reads the row of its
    read_idx, and a lane whose read is done draws the next read from the
    shared cursor qctr (same-step finishers in lane order) while its seed
    store holds cap_r more rows, else it goes P_DONE; its pass 2 scans only
    the current read's seeds (from seed_base), and the provenance column
    carries the read id."""
    dev = q.device
    i64 = torch.int64
    if refill:
        table = q.to(i64)
        L = (table.shape[1] - 2) // 2
        B = d["phase"].shape[0]
    else:
        B, L = q.shape
        q = q.to(i64)
        qlen = qlen.to(i64)
        nv = next_valid.to(i64)
        hi1 = qlen if hi1 is None else hi1.to(i64)
        hi3 = qlen if hi3 is None else hi3.to(i64)
    sidx = torch.arange(cap_s, dtype=i64, device=dev)
    L2r = idx["L2"][:4].to(i64)[None, :]
    primary = idx["primary"]
    W = lambda m, a, b: torch.where(m, a, b)  # noqa: E731
    d["steps"] = int(d["steps"])  # a state K13 left holds a tensor
    stop_at = d["steps"] + max_steps

    def vread(vec, pos):
        return vec[torch.arange(B, device=dev), pos]

    def col(mat, c):
        return mat[torch.arange(B, device=dev), c]

    while d["steps"] < stop_at and bool((d["phase"] != P_DONE).any()):
        if refill:  # the lanes' current reads
            trow = table[d["read_idx"]]
            qlen = hi1 = hi3 = trow[:, 0]
            q = trow[:, 1:L + 1]
            nv = trow[:, L + 1:]
        phase = d["phase"]
        st1m = d["stage"] == S_P2
        st2m = d["stage"] == S_P3

        # ---------- P_NEXT: acquire the next job (stage-dependent) ----------
        nx = phase == P_NEXT
        xv = vread(nv, d["job"].clamp(0, L))
        have_nv = nx & ~st1m & (xv < W(st2m, hi3, hi1))
        # pass 2: the first qualifying seed at or after the cursor, searched
        # only on the lanes that acquire a pass-2 job this step (no other
        # lane reads jj or the row below)
        jj = d["old_n"].clone()
        m2 = (nx & st1m).nonzero().squeeze(1)
        if m2.numel():
            old_n = d["old_n"][m2][:, None]
            if jobs is None:
                qual = d["qmask"][m2]
            else:
                jr = jobs[m2]
                qual = ((jr[:, :, 4] - jr[:, :, 3]) >= split_len) \
                    & (jr[:, :, 2] <= split_width)
            cand = qual & (sidx[None, :] < old_n) \
                & (sidx[None, :] >= d["job"][m2][:, None])
            jj_first = W(cand, sidx[None, :], torch.full_like(sidx, cap_s)
                         [None, :]).min(dim=1).values
            jj[m2] = W(jj_first < cap_s, jj_first, old_n[:, 0])
        k = jj.clamp(max=cap_s - 1)
        have_s1 = nx & st1m & (jj < d["old_n"])
        row = _row_read(d["seeds"] if jobs is None else jobs, k)
        x_s1 = (row[:, 3] + row[:, 4]) >> 1
        if tagged:
            d["cur_tag"] = W(have_s1, (row[:, 3] << 15) | row[:, 4],
                             d["cur_tag"])
        have = W(st1m, have_s1, have_nv)
        x_new = W(st1m, x_s1, xv)
        d["minv"] = W(nx, W(st1m, W(have_s1, row[:, 2] + 1, d["minv"]),
                            torch.ones_like(d["minv"])), d["minv"])
        d["job"] = W(nx & st1m, jj + have_s1.to(i64), d["job"])
        d["x"] = W(have, x_new, d["x"])

        exh = nx & ~have
        to_s2 = exh & (d["stage"] == S_P1) & (last_stage > S_P1)
        to_s3 = exh & st1m & use_p3 & (last_stage > S_P2)
        to_done = exh & ~to_s2 & ~to_s3
        d["old_n"] = W(to_s2, d["seed_n"], d["old_n"])
        d["stage"] = W(to_s2, torch.full_like(d["stage"], S_P2),
                       W(to_s3, torch.full_like(d["stage"], S_P3),
                         d["stage"]))
        # pass 2 scans the current read's seeds: from seed_base (0 unless
        # the lane refills)
        d["job"] = W(to_s2, d["seed_base"],
                     W(to_s3, torch.zeros_like(d["job"]), d["job"]))
        st2m = d["stage"] == S_P3

        if refill:
            # a finishing lane with room for another read's seeds draws the
            # next queued read; same-step finishers take consecutive queue
            # slots in lane order.  The lane idles this step (its gathered
            # row is the old read's) and starts the new read's pass 1 next.
            want = to_done & (d["seed_n"] <= cap_s - cap_r)
            wanti = want.to(i64)
            new_idx = d["qctr"] + torch.cumsum(wanti, 0) - wanti
            acq = want & (new_idx < n_queue)
            d["read_idx"] = W(acq, new_idx, d["read_idx"])
            d["seed_base"] = W(acq, d["seed_n"], d["seed_base"])
            d["stage"] = W(acq, torch.full_like(d["stage"], S_P1),
                           d["stage"])
            d["job"] = W(acq, torch.zeros_like(d["job"]), d["job"])
            d["qctr"] += int(acq.sum())
            to_done = to_done & ~acq

        qx = vread(q, d["x"].clamp(0, L - 1))
        startable = have & (qx < 4)
        k0, k1, k2 = _set_intv(idx, qx)
        ik_new = torch.stack([k0, k1, k2], dim=-1).to(i64)
        d["ik"] = W(startable[:, None], ik_new, d["ik"])
        d["info_end"] = W(startable, d["x"] + 1, d["info_end"])
        d["i"] = W(startable, d["x"] + 1, d["i"])
        d["an"] = W(startable, torch.zeros_like(d["an"]), d["an"])
        d["minv"] = d["minv"].clamp(min=1)
        d["phase"] = W(startable, torch.full_like(phase, P_FWD),
                       W(to_done, torch.full_like(phase, P_DONE), phase))

        # ---------- shared occ work ----------
        in_fwd = d["phase"] == P_FWD
        in_bwd = d["phase"] == P_BWD
        pn = W(d["cur_is_a"], d["an"], d["bn"])
        jj2 = W(d["rev_read"], pn - 1 - d["j"], d["j"]).clamp(0, cap - 1)
        p = W(d["cur_is_a"][:, None], _row_read(d["stkA"], jj2),
              _row_read(d["stkB"], jj2))
        ex = W(in_bwd[:, None], p[:, :3], d["ik"])
        fwd_side = W(in_bwd, ex[:, 0], ex[:, 1])
        tk = _occ4(idx, fwd_side - 1).to(i64)
        tl = _occ4(idx, fwd_side - 1 + ex[:, 2]).to(i64)
        ok_nb = L2r + 1 + tk
        ok_sz = tl - tk
        bk = W(in_bwd, ex[:, 1], ex[:, 0])
        span = ((fwd_side <= primary)
                & (fwd_side + ex[:, 2] - 1 >= primary)).to(i64)
        acc3 = bk + span
        acc2 = acc3 + ok_sz[:, 3]
        acc1 = acc2 + ok_sz[:, 2]
        acc0 = acc1 + ok_sz[:, 1]
        accs = torch.stack([acc0, acc1, acc2, acc3], dim=-1)

        # ---------- P_FWD micro-op (SMEM forward for stages 1/2) ----------
        qi = vread(q, d["i"].clamp(0, L - 1))
        qb_i = W(d["i"] >= 0, qi, torch.full_like(qi, 4))
        fwd_s12 = in_fwd & ~st2m
        run_f = fwd_s12 & (d["i"] < qlen)
        off_end = fwd_s12 & ~run_f
        amb = run_f & (qi >= 4)
        ext_m = run_f & ~amb
        cf = (3 - qi).clamp(0, 3)
        of = torch.stack([col(accs, cf), col(ok_nb, cf), col(ok_sz, cf)], -1)
        changed = ext_m & (of[:, 2] != d["ik"][:, 2])
        push_f = amb | changed | off_end
        rowf = torch.cat([d["ik"], d["info_end"][:, None]], dim=1)
        d["stkA"], d["an"], o1 = _push_row(d["stkA"], d["an"], push_f, rowf,
                                           cap)
        d["ovf"] = d["ovf"] | o1
        too_small = changed & (of[:, 2] < d["minv"])
        stop_f = amb | too_small | off_end
        adv = ext_m & ~stop_f
        d["ik"] = W(adv[:, None], of, d["ik"])
        d["info_end"] = W(adv, d["i"] + 1, d["info_end"])
        d["i"] = W(adv, d["i"] + 1, d["i"])
        to_bwd = stop_f
        d["ret"] = W(to_bwd, d["info_end"], d["ret"])
        d["cur_is_a"] = d["cur_is_a"] | to_bwd
        d["rev_read"] = d["rev_read"] | to_bwd
        d["bn"] = W(to_bwd, torch.zeros_like(d["bn"]), d["bn"])
        d["j"] = W(to_bwd, torch.zeros_like(d["j"]), d["j"])
        d["i"] = W(to_bwd, d["x"] - 1, d["i"])
        d["call_mem_n"] = W(to_bwd, torch.zeros_like(d["call_mem_n"]),
                            d["call_mem_n"])
        d["last_x2"] = W(to_bwd, torch.zeros_like(d["last_x2"]),
                         d["last_x2"])
        d["phase"] = W(to_bwd, torch.full_like(phase, P_BWD), d["phase"])

        # ---------- P_FWD micro-op, stage 3 (bwt_seed_strategy1) ----------
        if use_p3:
            f3 = in_fwd & st2m
            run3 = f3 & (d["i"] < qlen)
            hit_end3 = f3 & ~run3
            amb3 = run3 & (qi >= 4)
            ext3 = run3 & ~amb3
            hit3 = ext3 & (of[:, 2] < max_intv3) & \
                ((d["i"] - d["x"]) >= min_seed_len)
            write3 = hit3 & (of[:, 2] > 0)
            row3 = torch.cat([of, d["x"][:, None], (d["i"] + 1)[:, None]], 1)
            adv3 = ext3 & ~hit3
            d["ik"] = W(adv3[:, None], of, d["ik"])
            d["i"] = W(adv3, d["i"] + 1, d["i"])
            over3 = amb3 | hit3 | hit_end3
            d["job"] = W(amb3 | hit3, d["i"] + 1, W(hit_end3, qlen, d["job"]))
            d["phase"] = W(over3, torch.full_like(phase, P_NEXT), d["phase"])
        else:
            write3 = torch.zeros(B, dtype=torch.bool, device=dev)
            row3 = torch.zeros((B, 5), dtype=i64, device=dev)

        # ---------- P_BWD micro-op (one j of row i) ----------
        c = W((d["i"] >= 0) & (qb_i < 4), qb_i, torch.full_like(qb_i, -1))
        jact = in_bwd & (d["j"] < pn)
        cb = c.clamp(0, 3)
        ob = torch.stack([col(ok_nb, cb), col(accs, cb), col(ok_sz, cb)], -1)
        keep = jact & ((c < 0) | (ob[:, 2] < d["minv"]))
        curr_n_now = W(d["cur_is_a"], d["bn"], d["an"])
        can_emit = keep & (curr_n_now == 0) & (
            (d["call_mem_n"] == 0) | ((d["i"] + 1) < d["call_last_start"]))
        slen = p[:, 3] - (d["i"] + 1)
        write = can_emit & (slen >= min_seed_len)
        seed_row = torch.cat([p[:, :3], (d["i"] + 1)[:, None], p[:, 3:4]], 1)
        write_any = write | write3
        seed_row = W(write3[:, None], row3, seed_row)
        if tagged:
            tag = d["read_idx"] if refill else W(
                write3, torch.full_like(d["cur_tag"], -1),
                W(st1m, d["cur_tag"], torch.zeros_like(d["cur_tag"])))
            seed_row = torch.cat([seed_row, tag[:, None]], dim=1)
        qual_new = ((seed_row[:, 4] - seed_row[:, 3]) >= split_len) \
            & (seed_row[:, 2] <= split_width)
        slot_q = d["seed_n"].clamp(max=cap_s - 1)
        bidx = torch.arange(B, device=dev)
        d["qmask"][bidx, slot_q] = W(write_any, qual_new,
                                     d["qmask"][bidx, slot_q])
        d["seeds"], d["seed_n"], _ = _push_row(d["seeds"], d["seed_n"],
                                               write_any, seed_row, cap_s)
        d["call_last_start"] = W(can_emit, d["i"] + 1, d["call_last_start"])
        d["call_mem_n"] = d["call_mem_n"] + can_emit.to(i64)
        push_b = jact & ~keep & ((curr_n_now == 0)
                                 | (ob[:, 2] != d["last_x2"]))
        rowb = torch.cat([ob, p[:, 3:4]], dim=1)
        d["stkA"], d["an"], o2 = _push_row(d["stkA"], d["an"],
                                           push_b & ~d["cur_is_a"], rowb, cap)
        d["stkB"], d["bn"], o3 = _push_row(d["stkB"], d["bn"],
                                           push_b & d["cur_is_a"], rowb, cap)
        d["ovf"] = d["ovf"] | o2 | o3
        d["last_x2"] = W(push_b, ob[:, 2], d["last_x2"])
        d["j"] = W(jact, d["j"] + 1, d["j"])
        row_done = in_bwd & (d["j"] >= pn)
        new_n = W(d["cur_is_a"], d["bn"], d["an"])
        call_over = row_done & ((new_n == 0) | (d["i"] < 0))
        keep_going = row_done & ~call_over
        d["cur_is_a"] = d["cur_is_a"] ^ keep_going
        d["rev_read"] = d["rev_read"] & ~keep_going
        d["bn"] = W(keep_going & d["cur_is_a"], torch.zeros_like(d["bn"]),
                    d["bn"])
        d["an"] = W(keep_going & ~d["cur_is_a"], torch.zeros_like(d["an"]),
                    d["an"])
        d["i"] = W(keep_going, d["i"] - 1, d["i"])
        d["j"] = W(keep_going, torch.zeros_like(d["j"]), d["j"])
        d["last_x2"] = W(keep_going, torch.zeros_like(d["last_x2"]),
                         d["last_x2"])
        d["job"] = W(call_over & (d["stage"] == S_P1), d["ret"], d["job"])
        d["phase"] = W(call_over, torch.full_like(phase, P_NEXT), d["phase"])
        d["steps"] += 1
        d["done_step"] = W((d["phase"] == P_DONE) & (d["done_step"] == 0),
                           torch.full_like(d["done_step"], d["steps"]),
                           d["done_step"])
    return d


def bwd_row_resolve(ob2, keep, n0: int, last_x2: int, cap: int,
                    emit_ok: bool, rev: bool, rounds: int | None = None):
    """One backward row's order-dependent bookkeeping (the P_BWD micro-op
    of seed_machine_seg, taken j = 0..pn-1; bwt_smem1a, bwt.c:318-340)
    resolved for all its entries at once, as kernel K1 does it.  Nothing on
    the main path calls it; the tests hold it to the one-j-at-a-time rule.

    ob2: [pn] sizes of the entries' extensions and keep: [pn] bool, both in
    processing order; n0: the target stack's count when the row starts and
    last_x2 the size of its last push; emit_ok: call_mem_n == 0 or
    i + 1 < call_last_start; rev: the call's first row, read backwards.
    An entry is pushed if it is not kept and either no earlier entry of the
    row is unkept (then as the rule has it: n0 == 0 or a size other than
    last_x2) or its size differs from the nearest earlier unkept entry's:
    that entry was pushed, or had the size last pushed.  `rounds` takes the
    entries that many at a time, carrying the last unkept size and the push
    count across rounds, K1's order of work.

    Returns a dict: read_slot [pn] (stack slot each entry reads), push [pn]
    bool, slot [pn] (target slot of each push), wins [pn] bool (the push
    whose row its slot keeps: pushes past cap - 1 overwrite the last slot),
    emit (entry that ends an SMEM, or -1), ovf, n (count after the row) and
    last_x2 (after the row)."""
    i64 = torch.int64
    ob2 = torch.as_tensor(ob2).to(i64)
    keep = torch.as_tensor(keep).to(torch.bool)
    pn = ob2.shape[0]
    dev = ob2.device
    j = torch.arange(pn, dtype=i64, device=dev)
    read_slot = ((pn - 1 - j) if rev else j).clamp(0, cap - 1)
    unk = ~keep
    push = torch.zeros(pn, dtype=torch.bool, device=dev)
    rank = torch.zeros(pn, dtype=i64, device=dev)   # pushes before entry j
    has_prev, prev_ob2, n_push = False, int(last_x2), 0
    step = rounds or max(pn, 1)
    for lo in range(0, pn, step):
        u, o = unk[lo:lo + step], ob2[lo:lo + step]
        k = torch.arange(u.shape[0], dtype=i64, device=dev)
        upto = torch.cummax(torch.where(u, k, torch.full_like(k, -1)),
                            0).values
        before = torch.cat([upto.new_full((1,), -1), upto[:-1]])
        in_round = before >= 0
        cmp = torch.where(in_round, o[before.clamp(min=0)],
                          torch.full_like(o, prev_ob2))
        free = ~(in_round | has_prev) & (n0 == 0)
        p = u & (free | (o != cmp))
        push[lo:lo + step] = p
        rank[lo:lo + step] = n_push + torch.cumsum(p.to(i64), 0) - p.to(i64)
        if bool(u.any()):
            has_prev = True
            prev_ob2 = int(o[int(upto[-1])])
        n_push += int(p.sum())
    slot = (n0 + rank).clamp(max=cap - 1)
    wins = push & ((slot < cap - 1) | (rank == n_push - 1))
    ovf = bool((push & (n0 + rank >= cap)).any())
    cand = (keep & (n0 + rank == 0)).nonzero().flatten()
    emit = int(cand[0]) if emit_ok and cand.numel() else -1
    pushed = push.nonzero().flatten()
    last = int(ob2[int(pushed[-1])]) if pushed.numel() else int(last_x2)
    return dict(read_slot=read_slot, push=push, slot=slot, wins=wins,
                emit=emit, ovf=ovf, n=int(n0) + n_push, last_x2=last)


def bwd_row_serial(ob2, keep, n0: int, last_x2: int, cap: int,
                   emit_ok: bool, rev: bool):
    """One backward row the way K1's refill mode takes it (csrc/
    seed_machine.cu, seed_refill_kernel: a group of 2R threads a lane, one
    entry a step): entry j reads stack slot clamp(pn - 1 - j if rev else j,
    0, cap - 1); a kept entry emits while the target stack is empty and
    emit_ok holds (then no longer: call_last_start becomes i + 1); an unkept
    one is pushed when the target stack is empty or its size differs from
    the last push's, into slot min(n, cap - 1), the push past cap flagging
    overflow.  Arguments and the returned dict are bwd_row_resolve's.
    Nothing on the main path calls it; the tests hold it to the
    one-j-at-a-time rule and to bwd_row_resolve."""
    i64 = torch.int64
    ob2 = [int(v) for v in torch.as_tensor(ob2).to(i64)]
    keep = [bool(v) for v in torch.as_tensor(keep)]
    pn = len(ob2)
    read_slot = torch.tensor([min(max(pn - 1 - j if rev else j, 0), cap - 1)
                              for j in range(pn)], dtype=i64)
    push = torch.zeros(pn, dtype=torch.bool)
    slot = torch.zeros(pn, dtype=i64)
    owner = {}  # slot -> the entry whose row it keeps
    n, lx, ok, emit, ovf = int(n0), int(last_x2), bool(emit_ok), -1, False
    for j in range(pn):
        if keep[j]:
            if n == 0 and ok:
                emit, ok = j, False
        elif n == 0 or ob2[j] != lx:
            s = min(n, cap - 1)
            ovf |= n >= cap
            push[j], slot[j] = True, s
            owner[s] = j
            n, lx = n + 1, ob2[j]
    wins = torch.zeros(pn, dtype=torch.bool)
    for j in owner.values():
        wins[j] = True
    return dict(read_slot=read_slot, push=push, slot=slot, wins=wins,
                emit=emit, ovf=ovf, n=n, last_x2=lx)


# launches of the K1 kernel (the CUDA wrapper below adds one per launch)
launches = 0


def seed_machine(idx, q, qlen, next_valid, min_seed_len, split_len,
                 split_width, max_intv3, cap: int, cap_s: int, use_p3: bool,
                 shard=None):
    """Init + run every lane to completion.  Returns (seeds [B, cap_s, 5|6]
    coord dtype, seed_n [B] int32, steps int, ovf [B] bool, done_step [B]
    int32).  shard: optional (job_lo, hi1, hi3) numpy arrays for lane
    sharding; seeds then carry the provenance column.

    A CUDA q launches kernel K1; a CPU q runs the plain version."""
    if q.is_cuda:
        return _seed_machine_cuda(idx, q, qlen, next_valid, min_seed_len,
                                  split_len, split_width, max_intv3, cap,
                                  cap_s, use_p3, shard)
    return seed_machine_plain(idx, q, qlen, next_valid, min_seed_len,
                              split_len, split_width, max_intv3, cap, cap_s,
                              use_p3, shard)


def seed_machine_plain(idx, q, qlen, next_valid, min_seed_len, split_len,
                       split_width, max_intv3, cap: int, cap_s: int,
                       use_p3: bool, shard=None):
    """seed_machine through the plain version, on q's device."""
    dev = q.device
    tagged = shard is not None
    hi1 = hi3 = None
    job_lo = None
    if tagged:
        job_lo, hi1, hi3 = shard
        hi1 = torch.as_tensor(np.asarray(hi1, np.int64), device=dev)
        hi3 = torch.as_tensor(np.asarray(hi3, np.int64), device=dev)
    d = seed_state_init(q.shape[0], cap, cap_s, dev, tagged=tagged,
                        job_lo=job_lo)
    d = seed_machine_seg(d, idx, q, qlen, next_valid, int(min_seed_len),
                         int(split_len), int(split_width), int(max_intv3),
                         1 << 62, cap=cap, cap_s=cap_s, use_p3=use_p3,
                         hi1=hi1, hi3=hi3, tagged=tagged)
    return (d["seeds"].to(idx["cdt"]), d["seed_n"].to(torch.int32),
            d["steps"], d["ovf"], d["done_step"].to(torch.int32))


def _seed_machine_cuda(idx, q, qlen, next_valid, min_seed_len, split_len,
                       split_width, max_intv3, cap, cap_s, use_p3, shard):
    """Kernel K1 launch: a warp per lane runs its machine to done."""
    global launches
    out = _launch_k1(idx, q, qlen, next_valid, shard, min_seed_len,
                     split_len, split_width, max_intv3, cap, cap_s, use_p3)
    launches += 1
    return out


def _launch_k1(idx, q, qlen, next_valid, shard, min_seed_len, split_len,
               split_width, max_intv3, cap, cap_s, use_p3, lanes=None,
               cap_r=0, qctr=None, group=False):
    """K1 on q's rows, one a lane, or in refill mode (qctr given) on
    `lanes` lanes drawing q's rows from the cursor qctr, a warp a lane or
    (group) 2R threads a lane; the group form reads no next-valid table.
    Returns (seeds, seed_n, steps, ovf, done_step)."""
    from bwa_tpu_torch.ops import cuda_kernels

    refill = qctr is not None
    B = lanes if refill else q.shape[0]
    dev = q.device
    cdt = idx["cdt"]
    occtab = _check_occtab(idx, "K1")
    for t in (q, qlen, occtab) + (() if group else (next_valid,)):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("K1 inputs must be contiguous CUDA tensors")
    tagged = shard is not None or refill
    ncol = 6 if tagged else 5
    i32 = torch.int32
    if shard is not None:
        job_lo, hi1, hi3 = (torch.as_tensor(np.asarray(a, np.int32),
                                            device=dev) for a in shard)
    else:  # refill mode reads neither: its bounds are each read's length
        job_lo = torch.zeros(q.shape[0], dtype=i32, device=dev)
        hi1 = hi3 = qlen.to(i32)
    q8 = q.to(torch.uint8).contiguous()
    ql = qlen.to(i32).contiguous()
    nv = None if group else next_valid.to(i32).contiguous()
    # no zeroing: the kernel writes every seed slot (the unreached ones with
    # zeros) and reads qmask only where it wrote it
    seeds = torch.empty((B, cap_s, ncol), dtype=cdt, device=dev)
    seed_n = torch.empty(B, dtype=i32, device=dev)
    ovf = torch.empty(B, dtype=torch.uint8, device=dev)
    done_step = torch.empty(B, dtype=i32, device=dev)
    steps = torch.zeros(1, dtype=i32, device=dev)
    qmask = torch.empty((B, cap_s), dtype=torch.uint8, device=dev)
    L2 = idx["L2"].to(torch.int64).contiguous()
    cuda_kernels.seed_machine(
        occtab, L2, idx["primary"], idx["seq_len"], q8, ql, nv,
        job_lo.contiguous(), hi1.contiguous(), hi3.contiguous(),
        int(min_seed_len), int(split_len), int(split_width),
        int(max_intv3), cap, cap_s, bool(use_p3), tagged, seeds, seed_n,
        ovf, done_step, steps, qmask, lanes=B, cap_r=int(cap_r), qctr=qctr,
        group=group)
    return seeds, seed_n, steps, ovf.bool(), done_step


# launches of K1's refill mode in either form (its CUDA wrapper adds one a
# launch), and those of them in the group form (seed_refill_kernel)
refill_launches = 0
refill_group_launches = 0


def seed_machine_refill(idx, table, lanes: int, min_seed_len, split_len,
                        split_width, max_intv3, cap: int, cap_s: int,
                        use_p3: bool, cap_r: int, group: bool | None = None):
    """Retire-and-refill seeding of the N reads of `table` (ops/fm.py::
    _refill_table) on `lanes` lanes: lane b starts on read b (lanes past N
    start done), the shared cursor starts at min(lanes, N).  Returns
    (seeds [lanes, cap_s, 6] coord dtype, tag = read id; seed_n [lanes]
    int32; steps; ovf [lanes] bool; done_step [lanes] int32; qctr, a
    [1] int32 tensor: min(qctr, N) reads were drawn).  Which lane seeds
    which read depends on the order lanes finish, so only the seeds of
    each read, sorted by (start, end), are the same on both devices.

    A CUDA table launches K1's refill mode, in the form refill_group_form
    picks unless `group` says which; a CPU table runs the plain version."""
    args = (idx, table, lanes, min_seed_len, split_len, split_width,
            max_intv3, cap, cap_s, use_p3, cap_r)
    if table.is_cuda:
        return _seed_machine_refill_cuda(*args, group=group)
    return seed_machine_refill_plain(*args)


def refill_group_form(idx, lanes: int, cap: int, L: int) -> bool:
    """Whether a refill launch of `lanes` lanes runs in its group form (2R
    threads a lane): when they are at least twice the lanes resident at
    once as a warp each (K1's registers and stacks, this card's SMs).  A
    warp a lane steps faster (it extends a backward row's entries at once
    and its lanes never wait on each other's phases), but past its
    resident lanes the rest start after the queue has drained and draw
    nothing; the group form holds 32 / 2R lanes a warp resident.  At 150 bp
    on an H100 (2,640 resident): the warp form wins at 3,072 and 4,096
    lanes, the group form at 6,144 and 12,288 (PERF.md section 6)."""
    from bwa_tpu_torch.ops import cuda_kernels

    key = (str(idx["cdt"]), int(idx["occtab"].shape[1] - 4), int(cap),
           int(L), idx["occtab"].device.index)
    if key not in _warp_lanes:
        dev = idx["occtab"].device
        a = cuda_kernels.seed_kernel_attrs("K1", key[0] == "torch.int64",
                                           key[1], cap, L, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _warp_lanes[key] = a["warps_per_sm"] * sms
    return lanes >= 2 * _warp_lanes[key]


_warp_lanes: dict = {}


def seed_machine_refill_plain(idx, table, lanes, min_seed_len, split_len,
                              split_width, max_intv3, cap, cap_s, use_p3,
                              cap_r):
    """seed_machine_refill through the plain version, on table's device."""
    dev = table.device
    N = table.shape[0]
    d = seed_state_init(lanes, cap, cap_s, dev, tagged=True)
    init_n = min(lanes, N)
    d["read_idx"] = torch.arange(lanes, device=dev).clamp(max=max(N - 1, 0))
    d["phase"][init_n:] = P_DONE
    d["qctr"] = init_n
    d = seed_machine_seg(d, idx, table, None, None, int(min_seed_len),
                         int(split_len), int(split_width), int(max_intv3),
                         1 << 62, cap=cap, cap_s=cap_s, use_p3=use_p3,
                         tagged=True, refill=True, n_queue=N,
                         cap_r=int(cap_r))
    return (d["seeds"].to(idx["cdt"]), d["seed_n"].to(torch.int32),
            d["steps"], d["ovf"], d["done_step"].to(torch.int32),
            torch.tensor([d["qctr"]], dtype=torch.int32, device=dev))


def _seed_machine_refill_cuda(idx, table, lanes, min_seed_len, split_len,
                              split_width, max_intv3, cap, cap_s, use_p3,
                              cap_r, group=None):
    """K1's refill mode: a lane whose read is done draws the next one with
    an atomic add on the queue cursor; a warp a lane, or its group form."""
    global refill_launches, refill_group_launches
    N = table.shape[0]
    L = (table.shape[1] - 2) // 2
    i32 = torch.int32
    if group is None:
        group = refill_group_form(idx, lanes, cap, L)
    q = table[:, 1:L + 1].to(torch.uint8).contiguous()
    qlen = table[:, 0].contiguous()
    nv = None if group else table[:, L + 1:].contiguous()
    qctr = torch.full((1,), min(lanes, N), dtype=i32, device=table.device)
    out = _launch_k1(idx, q, qlen, nv, None, min_seed_len, split_len,
                     split_width, max_intv3, cap, cap_s, use_p3,
                     lanes=lanes, cap_r=cap_r, qctr=qctr, group=group)
    refill_launches += 1
    refill_group_launches += int(group)
    return (*out, qctr)


def sort_seeds(seeds, seed_n, key64: bool):
    """Stable sort by (start, end) == the reference's .info order."""
    shift = 32 if key64 else 16
    cap_s = seeds.shape[1]
    key = (seeds[:, :, 3].to(torch.int64) << shift) \
        | seeds[:, :, 4].to(torch.int64)
    if not key64:  # the int32 key of the reference implementation
        key = key.to(torch.int32).to(torch.int64)
    big = (1 << 63) - 1 if key64 else (1 << 31) - 1
    pad = torch.arange(cap_s, device=seeds.device)[None, :] \
        >= seed_n[:, None].to(torch.int64)
    key = torch.where(pad, torch.full_like(key, big), key)
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.gather(seeds, 1, order[:, :, None].expand_as(seeds))


# ---------------------------------------------------------------------------
# K1's state mode: the split route's passes (K12) and tail compaction's
# segments (K13)
# ---------------------------------------------------------------------------

# the per-lane scalar fields of the state dict, in the kernel's row order
# (ik takes three rows: x0, x1, x2)
SEG_FIELDS = ("phase", "stage", "old_n", "job", "x", "minv", "ik",
              "info_end", "i", "j", "an", "bn", "cur_is_a", "rev_read",
              "last_x2", "call_last_start", "call_mem_n", "ret", "seed_n",
              "ovf", "done_step")
_BOOL_FIELDS = ("cur_is_a", "rev_read", "ovf")
BIG_STEPS = 1 << 62  # a segment that runs every lane to done

# launches of K1's state mode: the split route's pass 1 and pass 2
# (smem_machine, K12a), its pass 3 (seed3_machine, K12b), and tail
# compaction's segments (segment, K13); each wrapper adds one a launch
smem_launches = 0
seed3_launches = 0
segment_launches = 0


def segment(d: dict, idx: dict, q, qlen, next_valid, min_seed_len,
            split_len, split_width, max_intv3, max_steps: int, cap: int,
            cap_s: int, use_p3: bool, last_stage: int = S_P3,
            jobs=None) -> dict:
    """At most max_steps more steps of every lane of the state d (from
    seed_state_init, untagged), resumed where d stands: kernel K13 (K1's
    state mode) for CUDA codes, seed_machine_seg for CPU ones.  Returns
    the state, the same on both devices field for field (steps a [1]
    int32 tensor after a launch, an int after the plain version)."""
    global segment_launches
    args = (d, idx, q, qlen, next_valid, min_seed_len, split_len,
            split_width, max_intv3, max_steps, cap, cap_s, use_p3,
            last_stage, jobs)
    if q.is_cuda:
        d = _launch_state(*args)
        segment_launches += 1
        return d
    return _plain_state(*args)


def _plain_state(d, idx, q, qlen, next_valid, min_seed_len, split_len,
                 split_width, max_intv3, max_steps, cap, cap_s, use_p3,
                 last_stage, jobs):
    return seed_machine_seg(d, idx, q, qlen, next_valid, int(min_seed_len),
                            int(split_len), int(split_width),
                            int(max_intv3), max_steps, cap=cap, cap_s=cap_s,
                            use_p3=use_p3, last_stage=last_stage,
                            jobs=None if jobs is None
                            else jobs.to(torch.int64))


def _launch_state(d, *args):
    """One launch of K1's state mode: the state's per-lane fields packed
    into one [fields, B] int64 tensor and its stacks into [B, 2, cap, 4],
    loaded by each lane's warp, run for the step budget and stored back."""
    from bwa_tpu_torch.ops import cuda_kernels

    kargs = _pack_state(d, *args)
    cuda_kernels.seed_state(*kargs)
    return _unpack_state(d, kargs)


def _pack_state(d, idx, q, qlen, next_valid, min_seed_len, split_len,
                split_width, max_intv3, max_steps, cap, cap_s, use_p3,
                last_stage, jobs) -> tuple:
    """The arguments of cuda_kernels.seed_state for one launch on the state
    d: its per-lane fields and stacks packed, the rest as the kernel reads
    them."""
    i64, i32 = torch.int64, torch.int32
    dev = q.device
    occtab = _check_occtab(idx, "K1's state mode")
    if d["seeds"].shape[2] != 5:
        raise ValueError("K1's state mode runs untagged lanes")
    for t in (q, qlen, next_valid, occtab, d["phase"]):
        if not t.is_cuda:
            raise ValueError("K1's state mode takes CUDA tensors")
    rows = [d[k].to(i64)[:, None] if d[k].dim() == 1 else d[k].to(i64)
            for k in SEG_FIELDS]
    lanes = torch.cat(rows, dim=1).T.contiguous()
    stk = torch.stack([d["stkA"], d["stkB"]], dim=1).to(i64).contiguous()
    seeds = d["seeds"].to(i64).contiguous()
    qmask = d["qmask"].contiguous()
    st = d["steps"]
    steps_in = (st.to(i32).reshape(1) if torch.is_tensor(st)
                else torch.tensor([st], dtype=i32, device=dev))
    steps_out = steps_in.clone()
    return (occtab, idx["L2"].to(i64).contiguous(), idx["primary"],
            idx["seq_len"], idx["cdt"] == i64, q.to(torch.uint8).contiguous(),
            qlen.to(i32).contiguous(), next_valid.to(i32).contiguous(),
            int(min_seed_len), int(split_len), int(split_width),
            int(max_intv3), cap, cap_s, bool(use_p3), int(last_stage),
            None if jobs is None else jobs.to(i64).contiguous(), lanes, stk,
            seeds, qmask, steps_in, steps_out, int(max_steps))


def _unpack_state(d, kargs) -> dict:
    """d updated from a launch's packed arguments (_pack_state)."""
    lanes, stk, seeds, qmask, _, steps_out = kargs[-7:-1]
    f = 0
    for k in SEG_FIELDS:
        n = 3 if k == "ik" else 1
        v = lanes[f:f + n].T if n == 3 else lanes[f]
        d[k] = v != 0 if k in _BOOL_FIELDS else v
        f += n
    d["stkA"], d["stkB"] = stk[:, 0], stk[:, 1]
    d["seeds"], d["qmask"], d["steps"] = seeds, qmask, steps_out
    return d


def _stage_state(idx, q, stage, cap, cap_s, seeds_in, seed_n_in,
                 old_n=None) -> dict:
    """A fresh state whose lanes start in `stage` with the seeds of the
    passes before it."""
    d = seed_state_init(q.shape[0], cap, cap_s, q.device)
    d["stage"].fill_(stage)
    d["seeds"] = seeds_in.to(torch.int64).clone()
    d["seed_n"] = seed_n_in.to(torch.int64).clone()
    if old_n is not None:
        d["old_n"] = old_n.to(torch.int64).clone()
    return d


def smem_machine(idx, q, qlen, next_valid, min_seed_len, split_len,
                 split_width, seeds_in, seed_n_in, old_n, cap: int,
                 cap_s: int, pass2: bool):
    """The split route's pass 1 (pass2=False) or pass 2 (pass2=True) run to
    completion (the JAX package's ops/fm_machine.py::smem_machine): the
    machine's stage range of that pass alone.  seeds_in [B, cap_s, 5]
    coord dtype, seed_n_in [B]; pass 2 takes its jobs from the fixed
    seeds_in[:old_n] and appends.  Returns (seeds, seed_n [B] int32, steps,
    ovf [B] bool, done_step [B] int32).  A CUDA q launches K12a (K1's
    state mode), a CPU q runs the plain version."""
    global smem_launches
    stage = S_P2 if pass2 else S_P1
    d = _stage_state(idx, q, stage, cap, cap_s, seeds_in, seed_n_in,
                     old_n if pass2 else None)
    args = (d, idx, q, qlen, next_valid, min_seed_len, split_len,
            split_width, 0, BIG_STEPS, cap, cap_s, False, stage,
            seeds_in if pass2 else None)
    if q.is_cuda:
        d = _launch_state(*args)
        smem_launches += 1
    else:
        d = _plain_state(*args)
    return (d["seeds"].to(idx["cdt"]), d["seed_n"].to(torch.int32),
            d["steps"], d["ovf"], d["done_step"].to(torch.int32))


def seed3_machine(idx, q, qlen, next_valid, min_len, max_intv, seeds_in,
                  seed_n_in, cap_s: int):
    """The split route's pass 3, bwt_seed_strategy1 over every start (the
    JAX package's ops/fm_machine.py::seed3_machine): the machine's stage
    range of pass 3 alone, appending to seeds_in.  Returns (seeds, seed_n
    [B] int32, steps).  A CUDA q launches K12b (K1's state mode), a CPU q
    runs the plain version."""
    global seed3_launches
    d = _stage_state(idx, q, S_P3, 1, cap_s, seeds_in, seed_n_in)
    args = (d, idx, q, qlen, next_valid, min_len, 0, 0, max_intv,
            BIG_STEPS, 1, cap_s, True, S_P3, None)
    if q.is_cuda:
        d = _launch_state(*args)
        seed3_launches += 1
    else:
        d = _plain_state(*args)
    return d["seeds"].to(idx["cdt"]), d["seed_n"].to(torch.int32), \
        d["steps"]
