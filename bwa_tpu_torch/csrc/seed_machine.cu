// Kernel K1: the per-lane SMEM seeding machine, a warp per lane.
//
// Replaces the JAX package's XLA while_loop
// bwa_tpu/ops/fm_machine.py::seed_machine_seg (with ops/fm.py::_occ4,
// _extend and _set_intv): all three seeding passes of mem_collect_intv
// (bwamem.c:140-188) -- pass 1 SMEMs (bwt_smem1a, bwt.c:289-351), pass 2
// re-seeding from the midpoints of long unique SMEMs, pass 3 LAST-like
// seeds (bwt_seed_strategy1, bwt.c:358-379) on lanes whose hi3 bound is
// non-zero.  Its plain version is
// bwa_tpu_torch/ops/fm_machine.py::seed_machine_seg; per lane, seeds (after
// sort_seeds), seed_n, ovf, done_step and steps are equal bit for bit.
//
// What bounds it on an H100: not bytes and not operations, but the longest
// lane's chain of dependent reads.  Every machine step extends an interval
// by one base (bwt_extend), which needs two occ4 lookups in the fused occtab
// at positions that the previous step produced.  The occtab of a 4.6 Mbp
// genome is 1.5 MB and stays in the 50 MB L2, so a step costs one L2 round
// trip plus the arithmetic that follows it, and a launch costs the longest
// lane's steps times that.  The design shortens the chain and what hangs
// off each link:
//  1. A warp per lane.  The lane's scalar state lives in registers, the same
//     in all 32 threads, so a warp never diverges on the machine's phase.
//     4 warps a block: 2,048 lanes are 512 blocks over all 132 SMs.
//  2. Cooperative occ4.  A group of G = 2R threads (2 for the R = 1 occtab,
//     8 for R = 4) extends one interval: half the group counts B[0..k] and
//     half B[0..l], each thread
//     8 text words (two 16-byte loads) plus the row's counts, all issued
//     together, so both lookups of a step cost one L2 latency.  A shuffle
//     reduction of packed 10-bit counts within each half and one exchange
//     between the halves finish bwt_extend.  In a forward step every group
//     does the same lookup, so the result is uniform without a broadcast.
//  3. A backward row in parallel.  The pn entries of row i are extended by
//     the same base at once, 32/G a round (the occ lookup of fm_occ.cuh,
//     shared with csrc/smem_batch.cu).  What depends on order comes
//     from ballots over the entries, in the plain version's order: an entry
//     is pushed if it is not kept and no earlier entry of the row is unkept
//     or its size differs from the nearest earlier unkept entry's; a push of
//     rank r writes slot min(r, cap - 1), the last such push winning; the
//     row can emit only at its first entry.  A row counts pn steps (one if
//     pn = 0), as the plain machine takes them one j at a time.
//  4. Stacks A and B in shared memory (2 x cap x 4 coordinates a lane);
//     seeds and qmask stay in global memory, written by the warp.
//  5. 32-bit arithmetic when 2*l_pac+2 < 2^31 (C = int32); occtab words are
//     masked and shifted as uint32.  The int64 instantiation serves
//     GRCh38-scale indexes.
//  6. No initialisation pass: every seed slot is written once, by a push or,
//     after the machine ends, by the warp's coalesced zeroing of the slots
//     past seed_n; qmask is read only below seed_n.
//  7. Retire-and-refill mode (the JAX machine's refill=True): the B lanes
//     draw the n_queue reads of q from a cursor in device memory.  A lane
//     whose read is done and whose seed store holds cap_r more rows takes
//     the next read with one atomicAdd (its first thread's, broadcast by a
//     shuffle); the cursor may pass n_queue by the failed draws, so the
//     reads drawn are min(qctr, n_queue).  Pass 2 scans only the current
//     read's seeds (from seed_base) and the tag column is the read id.
//     Which lane takes which read follows the order lanes finish, so only
//     each read's seeds, sorted by (start, end), equal the plain version's.
//     A refill launch runs here (a warp a lane, 20 warps an SM at R = 4)
//     below twice the lanes resident at once; from there it runs on
//     seed_refill_kernel below, a group of 2R threads a lane (the caller
//     chooses: ops/fm_machine.py::refill_group_form).
//  8. State mode (SEG, bwa_seed_state), the same code: each lane's warp
//     loads its machine state -- the plain version's per-lane fields and
//     both stacks; the seed store and its qualification bits are updated in
//     place -- runs it, and stores it back, so a later launch resumes it.
//     A stage range (the stage a lane starts in is its state's; last_stage
//     ends it) runs one pass alone: the JAX package's split route,
//     fm_machine.py:93 smem_machine (pass 1, or pass 2 from a fixed job
//     table, as its tables are fixed at entry) and :733 seed3_machine
//     (K12).  A step budget (steps_in + max_steps, in the plain machine's
//     steps, which K1 already counts) ends a segment at the plain
//     version's step, inside a backward row if that is where it falls:
//     the row resumes at entry j with the target stack's count and last
//     pushed size, from which the row's rules follow (K13, the tail
//     compaction of bwa_tpu/ops/fm.py:903-982).  The state is held at the
//     kernel's own widths, on the card, for a whole route call
//     (ops/fm_machine.py::typed_state): the int fields in the rows of an
//     int32 [18, B] tensor, the coordinates in the rows of a [5, B] tensor
//     of C, field f of lane b at row f, column b, so that a block's four
//     lanes share each row's sectors; the stacks in [B, 2, cap, 4] of C,
//     copied to and from shared memory as 16-byte vectors; the seed store
//     [B, cap_s, 5] of C, the one the route sorts and fetches.  So a launch
//     needs no packing on the host, and a state costs 4 bytes a field at
//     C = int32.  A pass starts from a few fills of those tensors
//     (start_state); compaction gathers one tensor at a time.
//
// Kernels of the same source, on the same occtab through the group lookup
// (glookup, csrc/fm_occ.cuh, shared with K10a, K10b and K11): K1's
// retire-and-refill mode (seed_refill_kernel) and K8, probe_breaks
// (probe_breaks_kernel).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (bwa_tpu_torch/ops/cuda_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_occ.cuh"

namespace {

constexpr int P_NEXT = 0, P_FWD = 1, P_BWD = 2, P_DONE = 3;
constexpr int S_P1 = 0, S_P2 = 1, S_P3 = 2;
constexpr int WARPS = 4;  // lanes (warps) a block

template <typename C>
struct SeedArgs {
  const uint32_t *occtab;  // [n_rows, 4 + nw] counts || text words
  const int64_t *L2;       // [5]
  C primary, seq_len;
  const uint8_t *q;        // [n_queue, L] read codes
  int B, n_queue, L;       // lanes, reads (equal unless refill)
  const int32_t *qlen, *nv, *job_lo, *hi1, *hi3;  // nv: [n_queue, L+1]
  int min_seed_len, split_len;
  int64_t split_width, max_intv3;
  int cap, cap_s, use_p3, tagged, cap_r;
  void *seeds;             // [B, cap_s, 5|6] coordinates
  int32_t *seed_n, *done_step, *steps;
  uint8_t *ovf;
  uint8_t *qmask;          // [B, cap_s] scratch
  int32_t *qctr;           // refill mode's queue cursor, else null
  // the state mode (K12, K13): the stage a lane ends with, a fixed pass-2
  // job table, the per-lane fields and stacks loaded and stored, the run's
  // steps before the launch and the launch's step budget
  int last_stage;
  const C *jobs;           // [B, cap_s, 5], or null: the live seed store
  // the per-lane fields: the rows of an int32 [18, B] tensor in
  // ops/fm_machine.py::INT_FIELDS's order and of a [5, B] tensor of
  // coordinates (minv, ik0, ik1, ik2, last_x2)
  int32_t *ints;
  C *coords;
  C *stk;                  // [B, 2, cap, 4]
  const int32_t *steps_in;
  int64_t max_steps;
};

// SEG: the state mode.  Each lane's warp loads its machine state (the
// per-lane fields, both stacks; seeds and qualification bits stay in
// place) from the state tensors, runs until it is done, exhausts
// last_stage or reaches steps_in + max_steps plain steps, and stores it
// back.  A backward row may start and end part way: it resumes at entry j
// with the target stack's count and last pushed size.
template <typename C, int NW, bool SEG>
__global__ void __launch_bounds__(WARPS * 32)
    seed_machine_kernel(SeedArgs<C> a) {
  constexpr int G = 2 * NW / WPT;  // threads a group (one interval)
  constexpr int E = 32 / G;        // backward entries a round
  constexpr unsigned LEADERS = FULL / ((1u << G) - 1);  // first of each group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;
  const int gl = lane & (G - 1), grp = lane / G;
  const unsigned below = (1u << (lane & ~(G - 1))) - 1;  // earlier groups
  const int L = a.L, cap = a.cap, cap_s = a.cap_s;
  const bool refill = a.qctr != nullptr;
  const int ncol = a.tagged ? 6 : 5;
  C *stkA = reinterpret_cast<C *>(smem_raw) + (size_t)warp * 2 * cap * 4;
  C *stkB = stkA + cap * 4;
  C *seeds = static_cast<C *>(a.seeds) + (size_t)b * cap_s * ncol;
  uint8_t *qmask = a.qmask + (size_t)b * cap_s;
  // a fixed pass-2 job table (the state mode's pass 2 alone), or none
  const C *jobs = SEG && a.jobs ? a.jobs + (size_t)b * cap_s * 5 : nullptr;
  // the lane's read: row b, or in refill mode each read it draws
  int rid = b, qlen = 0, hi1 = 0, hi3 = 0;
  const uint8_t *q = a.q;
  const int32_t *nv = a.nv;
  auto take_read = [&](int r) {
    rid = r;
    q = a.q + (size_t)r * L;
    nv = a.nv + (size_t)r * (L + 1);
    qlen = a.qlen[r];
    hi1 = refill ? qlen : a.hi1[r];
    hi3 = refill ? qlen : a.hi3[r];
  };
  C L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)a.L2[c];

  int phase = P_NEXT, stage = S_P1, old_n = 0, job = 0, x = 0;
  C minv = 1, ik0 = 0, ik1 = 0, ik2 = 0, last_x2 = 0;
  int info_end = 0, i = 0, j = 0, an = 0, bn = 0;
  bool cur_is_a = true, rev_read = true, ovf = false;
  int call_last_start = 0, call_mem_n = 0, ret = 0, seed_n = 0;
  int seed_base = 0;  // the current read's first seed slot (refill)
  int64_t cur_tag = 0;
  int steps = 0, done_step = 0;
  int stop_at = 0x7fffffff;
  // the stacks' 16-byte vectors a lane (2 * cap * 4 coordinates)
  const int nvec = 2 * cap * 4 * (int)sizeof(C) / 16;
  if (SEG) {
    take_read(b);
    const int32_t *f = a.ints + b;
    const C *g = a.coords + b;
    const size_t B = a.B;
    phase = f[0]; stage = f[B]; old_n = f[2 * B]; job = f[3 * B];
    x = f[4 * B]; info_end = f[5 * B]; i = f[6 * B]; j = f[7 * B];
    an = f[8 * B]; bn = f[9 * B]; cur_is_a = f[10 * B] != 0;
    rev_read = f[11 * B] != 0; call_last_start = f[12 * B];
    call_mem_n = f[13 * B]; ret = f[14 * B]; ovf = f[15 * B] != 0;
    done_step = f[16 * B]; seed_n = f[17 * B];
    minv = g[0]; ik0 = g[B]; ik1 = g[2 * B]; ik2 = g[3 * B];
    last_x2 = g[4 * B];
    steps = *a.steps_in;
    const int64_t stop = (int64_t)steps + a.max_steps;
    stop_at = stop < 0x7fffffff ? (int)stop : 0x7fffffff;
    const uint4 *st =
        reinterpret_cast<const uint4 *>(a.stk + (size_t)b * 2 * cap * 4);
    for (int t = lane; t < nvec; t += 32)
      reinterpret_cast<uint4 *>(stkA)[t] = st[t];
    __syncwarp();
  } else if (b < a.n_queue) {
    take_read(b);
    if (!refill) job = a.job_lo[b];
  } else {  // a refill lane with no read: done at the plain machine's step 1
    phase = P_DONE;
    done_step = 1;
  }

  // one seed row, pushed by the warp (the last slot keeps being overwritten
  // once the store is full; seed_n keeps counting)
  auto push_seed = [&](C r0, C r1, C r2, int r3, int r4, int64_t tag) {
    const int slot = seed_n < cap_s - 1 ? seed_n : cap_s - 1;
    const C v = lane == 0 ? r0 : lane == 1 ? r1 : lane == 2 ? r2
              : lane == 3 ? (C)r3 : lane == 4 ? (C)r4 : (C)tag;
    if (lane < ncol) seeds[(size_t)slot * ncol + lane] = v;
    if (lane == 0)
      qmask[slot] = (r4 - r3) >= a.split_len && (int64_t)r2 <= a.split_width;
    ++seed_n;
    __syncwarp();
  };

  while (phase != P_DONE && steps < stop_at) {
    const bool st1m = stage == S_P2;

    // ---------- P_NEXT: acquire the next job (stage-dependent) ----------
    if (phase == P_NEXT) {
      const bool st2m = stage == S_P3;
      const int xv = nv[clampi(job, 0, L)];
      const bool have_nv = !st1m && xv < (st2m ? hi3 : hi1);
      bool have_s1 = false;
      int x_s1 = 0;
      if (st1m) {  // the first qualifying seed at or after the cursor
        const int lim = old_n < cap_s ? old_n : cap_s;
        int jj = old_n;
        for (int base = job; base < lim; base += 32) {
          const int s = base + lane;
          bool qs = false;
          if (s < lim) {
            if (jobs) {
              const C *r = jobs + (size_t)s * 5;
              qs = (int)(r[4] - r[3]) >= a.split_len &&
                   (int64_t)r[2] <= a.split_width;
            } else {
              qs = qmask[s];
            }
          }
          const unsigned m = __ballot_sync(FULL, qs);
          if (m) {
            jj = base + __ffs(m) - 1;
            break;
          }
        }
        have_s1 = jj < old_n;
        if (have_s1) {
          const C *row =
              jobs ? jobs + (size_t)jj * 5 : seeds + (size_t)jj * ncol;
          const int r3 = (int)row[3], r4 = (int)row[4];
          x_s1 = (r3 + r4) >> 1;
          if (a.tagged) cur_tag = ((int64_t)r3 << 15) | r4;
          minv = row[2] + 1;
        }
        job = jj + (have_s1 ? 1 : 0);
      } else {
        minv = 1;
      }
      const bool have = st1m ? have_s1 : have_nv;
      if (have) x = st1m ? x_s1 : xv;
      const bool exh = !have;
      const bool to_s2 = exh && stage == S_P1 && a.last_stage > S_P1;
      const bool to_s3 = exh && st1m && a.use_p3 && a.last_stage > S_P2;
      const bool to_done = exh && !to_s2 && !to_s3;
      bool done_now = to_done;
      if (to_s2) {
        old_n = seed_n;
        stage = S_P2;
        job = seed_base;  // pass 2 scans the current read's seeds
      } else if (to_s3) {
        stage = S_P3;
        job = 0;
      }
      if (refill && to_done && seed_n <= cap_s - a.cap_r) {
        // draw the next read; the lane idles this step, as the plain
        // version's does
        int r = 0;
        if (lane == 0) r = atomicAdd(a.qctr, 1);
        r = __shfl_sync(FULL, r, 0);
        if (r < a.n_queue) {
          take_read(r);
          seed_base = seed_n;
          stage = S_P1;
          job = 0;
          done_now = false;
        }
      }
      bool startable = false;
      if (have) {
        const int qx = q[clampi(x, 0, L - 1)];
        startable = qx < 4;
        if (startable) {  // bwt_set_intv
          ik0 = pick(L2, qx) + 1;
          ik1 = pick(L2, 3 - qx) + 1;
          ik2 = pick(L2, qx + 1) - pick(L2, qx);
          info_end = x + 1;
          i = x + 1;
          an = 0;
        }
      }
      if (minv < 1) minv = 1;
      if (!startable) {
        if (done_now) phase = P_DONE;
        ++steps;
        if (phase == P_DONE && done_step == 0) done_step = steps;
        continue;
      }
      phase = P_FWD;  // the forward micro-op runs in this same step
    }

    // ---------- P_FWD: one forward extension (stages 1/2, or 3) ----------
    if (phase == P_FWD) {
      const int qi = q[clampi(i, 0, L - 1)];
      const int cf = clampi(3 - qi, 0, 3);
      C nb, sz, above;
      extend_c<C, NW>(a, L2, ik1 - 1, ik1 - 1 + ik2, gl, cf, nb, sz, above);
      const C span = (ik1 <= a.primary && ik1 + ik2 - 1 >= a.primary) ? 1 : 0;
      const C of0 = ik0 + span + above, of1 = nb, of2 = sz;
      if (stage != S_P3) {  // bwt_smem1a's forward loop
        const bool run_f = i < qlen, off_end = !run_f;
        const bool amb = run_f && qi >= 4, ext_m = run_f && !amb;
        const bool changed = ext_m && of2 != ik2;
        if (amb || changed || off_end) {
          const int slot = an < cap - 1 ? an : cap - 1;
          const C v = lane == 0 ? ik0 : lane == 1 ? ik1
                    : lane == 2 ? ik2 : (C)info_end;
          if (lane < 4) stkA[slot * 4 + lane] = v;
          if (an >= cap) ovf = true;
          ++an;
        }
        const bool stop_f = amb || (changed && of2 < minv) || off_end;
        if (ext_m && !stop_f) {
          ik0 = of0; ik1 = of1; ik2 = of2;
          info_end = i + 1;
          ++i;
        }
        if (stop_f) {
          ret = info_end;
          cur_is_a = true;
          rev_read = true;
          bn = 0;
          j = 0;
          i = x - 1;
          call_mem_n = 0;
          last_x2 = 0;
          phase = P_BWD;
        }
      } else {  // bwt_seed_strategy1
        const bool run3 = i < qlen, hit_end3 = !run3;
        const bool amb3 = run3 && qi >= 4, ext3 = run3 && !amb3;
        const bool hit3 = ext3 && (int64_t)of2 < a.max_intv3 &&
                          (i - x) >= a.min_seed_len;
        if (hit3 && of2 > 0)
          push_seed(of0, of1, of2, x, i + 1, refill ? rid : -1);
        if (ext3 && !hit3) {
          ik0 = of0; ik1 = of1; ik2 = of2;
          ++i;
        }
        if (amb3 || hit3) job = i + 1;
        else if (hit_end3) job = qlen;
        if (amb3 || hit3 || hit_end3) phase = P_NEXT;
      }
      ++steps;
      __syncwarp();
      continue;
    }

    // ---------- P_BWD: entries j0.. of row i (all of them, but where the
    // step budget ends the row) ----------
    const int pn = cur_is_a ? an : bn;
    const int n0 = cur_is_a ? bn : an;  // the target stack's count
    const int j0 = j;
    int jend = pn;
    if (SEG && jend - j0 > stop_at - steps) jend = j0 + (stop_at - steps);
    const C *rd = cur_is_a ? stkA : stkB;
    C *wr = cur_is_a ? stkB : stkA;
    const int qi = q[clampi(i, 0, L - 1)];
    const int c = (i >= 0 && qi < 4) ? qi : -1;  // -1: every entry is kept
    int npush = n0;
    bool keep0 = jend > j0;
    if (c >= 0) {
      // an unkept entry earlier in the row, and its size: with n0 > 0 the
      // last push's (an unkept entry not pushed has the last push's size)
      bool have_prev = n0 > 0;
      C prev_ob2 = last_x2;
      for (int base = j0; base < jend; base += E) {
        const int je = base + grp;
        const bool valid = je < jend;
        C p0 = 0, p1 = 0, p2 = 0, p3 = 0;
        if (valid) {
          const C *pr =
              rd + clampi(rev_read ? pn - 1 - je : je, 0, cap - 1) * 4;
          p0 = pr[0]; p1 = pr[1]; p2 = pr[2]; p3 = pr[3];
        }
        C nb, sz, above;
        extend_c<C, NW>(a, L2, valid ? p0 - 1 : (C)-1,
                        valid ? p0 - 1 + p2 : (C)-1, gl, c, nb, sz, above);
        const C span = (p0 <= a.primary && p0 + p2 - 1 >= a.primary) ? 1 : 0;
        const C ob0 = nb, ob1 = p1 + span + above, ob2 = sz;
        const bool keep = ob2 < minv;
        if (base == j0) keep0 = __ballot_sync(FULL, valid && keep) & 1u;
        const bool unk = valid && !keep;
        const unsigned U = __ballot_sync(FULL, unk) & LEADERS;
        const unsigned P = U & below;
        const C pob2 = __shfl_sync(FULL, ob2, P ? 31 - __clz(P) : lane);
        const bool push = unk && (!(P || have_prev) ||
                                  ob2 != (P ? pob2 : prev_ob2));
        const unsigned PM = __ballot_sync(FULL, push) & LEADERS;
        const int r = npush + __popc(PM & below), last = npush + __popc(PM) - 1;
        if (push && (r < cap - 1 || r == last)) {
          C *dst = wr + (r < cap - 1 ? r : cap - 1) * 4;
          for (int col = gl; col < 4; col += G)
            dst[col] = col == 0 ? ob0 : col == 1 ? ob1 : col == 2 ? ob2 : p3;
        }
        if (U) {
          have_prev = true;
          prev_ob2 = __shfl_sync(FULL, ob2, 31 - __clz(U));
        }
        npush = last + 1;
      }
      last_x2 = prev_ob2;  // the size last pushed (unchanged without one)
    }
    if (npush > cap) ovf = true;
    // the first entry taken, if kept while the target stack is empty, ends
    // an SMEM
    if (keep0 && n0 == 0 && (call_mem_n == 0 || i + 1 < call_last_start)) {
      const C *pr = rd + clampi(rev_read ? pn - 1 - j0 : j0, 0, cap - 1) * 4;
      const C p0 = pr[0], p1 = pr[1], p2 = pr[2];
      const int p3 = (int)pr[3];
      if (p3 - (i + 1) >= a.min_seed_len)
        push_seed(p0, p1, p2, i + 1, p3,
                  refill ? rid : (st1m ? cur_tag : 0));
      call_last_start = i + 1;
      ++call_mem_n;
    }
    steps += jend > j0 ? jend - j0 : 1;
    j = jend;
    if (cur_is_a) bn = npush;
    else an = npush;
    if (jend < pn) {  // the budget ends inside the row
    } else if (npush == 0 || i < 0) {  // the call is over
      if (stage == S_P1) job = ret;
      phase = P_NEXT;
    } else {
      cur_is_a = !cur_is_a;
      rev_read = false;
      if (cur_is_a) bn = 0;
      else an = 0;
      --i;
      j = 0;
      last_x2 = 0;
    }
    __syncwarp();
  }

  if (SEG) {
    if (lane == 0) {
      int32_t *f = a.ints + b;
      C *g = a.coords + b;
      const size_t B = a.B;
      f[0] = phase; f[B] = stage; f[2 * B] = old_n; f[3 * B] = job;
      f[4 * B] = x; f[5 * B] = info_end; f[6 * B] = i; f[7 * B] = j;
      f[8 * B] = an; f[9 * B] = bn; f[10 * B] = cur_is_a;
      f[11 * B] = rev_read; f[12 * B] = call_last_start;
      f[13 * B] = call_mem_n; f[14 * B] = ret; f[15 * B] = ovf;
      f[16 * B] = done_step; f[17 * B] = seed_n;
      g[0] = minv; g[B] = ik0; g[2 * B] = ik1; g[3 * B] = ik2;
      g[4 * B] = last_x2;
      atomicMax(a.steps, steps);
    }
    uint4 *st = reinterpret_cast<uint4 *>(a.stk + (size_t)b * 2 * cap * 4);
    for (int t = lane; t < nvec; t += 32)
      st[t] = reinterpret_cast<const uint4 *>(stkA)[t];
    return;
  }
  // the slots no push reached hold zeros, as in the plain version
  const int filled = seed_n < cap_s ? seed_n : cap_s;
  for (size_t t = (size_t)filled * ncol + lane; t < (size_t)cap_s * ncol;
       t += 32)
    seeds[t] = 0;
  if (lane == 0) {
    a.seed_n[b] = seed_n;
    a.ovf[b] = ovf ? 1 : 0;
    a.done_step[b] = done_step;
    atomicMax(a.steps, steps);
  }
}

template <typename C, int NW, bool SEG>
int launch(const SeedArgs<C> &a, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * 2 * a.cap * 4 * sizeof(C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_machine_kernel<C, NW, SEG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)e;
    }
  }
  seed_machine_kernel<C, NW, SEG><<<(a.B + WARPS - 1) / WARPS, WARPS * 32,
                                    smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename C, bool SEG = false>
int launch_nw(const SeedArgs<C> &a, int nw, cudaStream_t stream) {
  if (a.B == 0) return 0;
  if (a.cap < 1 || a.cap_s < 1) return (int)cudaErrorInvalidValue;
  switch (nw) {
    case 8: return launch<C, 8, SEG>(a, stream);
    case 32: return launch<C, 32, SEG>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// glookup's K8 case for a one-row interval whose ends are neighbouring
// text positions of one occtab row (k2 = k1 + 1, neither the $ row nor
// seq_len; the caller checks with narrow_ends): o1 = occ(k1)[c] as
// glookup counts it, and sz = occ(k2)[c] - o1, the one code at k2 read
// from its word, carried in the same shuffle sum.  The whole warp calls
// it; k1 = -1 loads nothing.
template <typename C, int NW>
__device__ __forceinline__ void glookup_narrow(const SeedArgs<C> &a, C k1,
                                               int c, int gl, C &o1, C &sz) {
  constexpr int RB = NW == 8 ? 0 : 2, PR = 128 << RB, G = NW / 4;
  const bool z = k1 < 0;  // a read that does not extend: no load
  C kk1 = z ? 0 : k1 - (k1 >= a.primary ? 1 : 0);
  const int p1 = (int)(kk1 & (PR - 1)), p2 = p1 + 1;
  const uint4 *row = reinterpret_cast<const uint4 *>(
      a.occtab + (size_t)(kk1 >> (7 + RB)) * (4 + NW));
  const int b1 = 2 * (p1 + 1 - 64 * gl);
  const bool owner = (p2 >> 6) == gl;
  const uint4 zz = make_uint4(0, 0, 0, 0);
  const uint4 cnt = z ? zz : ldg_now(row);
  const uint4 w = !z && (b1 > 0 || owner) ? ldg_now(row + 1 + gl) : zz;
  const QuadBits q = quad_bits<false>(w, (uint32_t)c * 0x55555555u, 0, 0, 0);
  const int u = (p2 >> 4) & 3, f = p2 & 15;
  const uint32_t bit =
      ((u < 2 ? q.e01 : q.e23) >> (2 * (15 - f) + (u & 1))) & 1u;
  uint32_t n = quad_count<false>(q, b1) | (owner ? bit << 16 : 0u);
#pragma unroll
  for (int off = 1; off < G; off <<= 1) n += __shfl_xor_sync(FULL, n, off);
  o1 = count_of<C>(cnt, c) + (C)(n & 0xffff);
  sz = (C)(n >> 16);
}

// whether glookup_narrow serves the interval (x1, x2) of K8
template <typename C, int NW>
__device__ __forceinline__ bool narrow_ends(const SeedArgs<C> &a, C x1,
                                            C x2) {
  constexpr int PR = 128 << (NW == 8 ? 0 : 2);
  const C k2 = x1;  // k1 + 1 for x2 == 1
  return x2 == 1 && k2 != a.primary && k2 != a.seq_len &&
         ((k2 - (k2 > a.primary ? 1 : 0)) & (PR - 1)) != 0;
}

// ---------------------------------------------------------------------------
// Kernel K8: probe_breaks, the trip-count predictor of trip-sorted bucket
// packing.  Replaces the JAX package's lax.scan bwa_tpu/ops/fm.py:253
// probe_breaks; its plain version is bwa_tpu_torch/ops/fm.py::
// probe_breaks_plain, equal count for count.  One forward interval a read
// over x = 0..L-1: where the previous base and this one are bases, the
// interval is extended forwards by c (the backward extension of the
// reverse complement, base 3 - c); an empty result counts a break, and
// wherever c is a base that did not extend, the interval restarts on c
// (bwt_set_intv).  The pad codes (4) end an interval as an N does.
//
// What bounds it: a position's chain of dependent work -- an occtab row
// from L2, the popcounts, a shuffle reduction, the new interval -- times
// the 150-odd positions a read extends, and the instructions of a lookup,
// which the 2R threads of a group repeat.  Design:
//  1. A group of G = 2R threads a read (E = 32 / G reads a warp), each
//     extension one group lookup (glookup) of base 3 - c's count at both
//     ends, only where the interval extends (the previous code and this one
//     bases): a start, an N or a pad costs no lookup, and a position where
//     no read of the warp extends costs none.  The warp looks up together
//     (a read that does not extend passes an empty end), so its shuffles
//     name every thread and need no convergence check.
//  2. Only the interval's forward start and size steer the breaks, so the
//     reverse start (bwt_extend's k side) is never formed: one base's
//     count, no sums above it.
//  3. The codes come 16 at a time, one 16-byte load ahead; 16 codes with no
//     base in any read of the warp (the pads past the reads) only end the
//     intervals.
//  4. Where every extending read of the warp has a one-row interval whose
//     ends are neighbouring positions of one occtab row (most positions
//     once an interval is unique), the lookup counts only k1's end and
//     reads the one code at k2 (glookup_narrow): about half a lookup's
//     instructions.
//  5. Picks by a base (L2, a row's counts, a code of the 16) are selects,
//     not branches.
// ---------------------------------------------------------------------------

// Codes x..x+15 of a row of L codes (4, a pad, past L); vec: 16-byte loads
__device__ __forceinline__ uint4 codes16(const uint8_t *q, int x, int L,
                                         bool vec) {
  if (vec && x + 16 <= L)
    return __ldg(reinterpret_cast<const uint4 *>(q + x));
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    w[u] = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int p = x + 4 * u + t;
      w[u] |= (uint32_t)(p < L ? q[p] : 4) << (8 * t);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename C, int NW>
__global__ void __launch_bounds__(WARPS * 32)
    probe_breaks_kernel(SeedArgs<C> a, int32_t *breaks) {
  constexpr int G = NW / 4;
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int b = (int)(((int64_t)blockIdx.x * WARPS * 32 + threadIdx.x) / G);
  const bool live = b < a.B;  // a dead group reads pads: no base, no lookup
  C L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)a.L2[c];
  const int L = a.L;
  const uint8_t *q = a.q + (size_t)(live ? b : 0) * L;
  const bool vec = ((reinterpret_cast<uintptr_t>(a.q) | (uintptr_t)L) & 15) == 0;
  C x1 = 1, x2 = 0;
  bool started = false;
  int brk = 0;
  const uint4 pads = make_uint4(0x04040404u, 0x04040404u, 0x04040404u,
                                0x04040404u);
  uint4 nxt = live ? codes16(q, 0, L, vec) : pads;
  for (int x = 0; x < L; x += 16) {
    const uint4 cur = nxt;
    if (live && x + 16 < L) nxt = codes16(q, x + 16, L, vec);
    // 16 codes with no base in any read of the warp only end the intervals
    const bool any = __vcmpltu4(cur.x, 0x04040404u) |
                     __vcmpltu4(cur.y, 0x04040404u) |
                     __vcmpltu4(cur.z, 0x04040404u) |
                     __vcmpltu4(cur.w, 0x04040404u);
    if (!__any_sync(FULL, any)) {
      started = false;
      continue;
    }
#pragma unroll 1
    for (int t = 0; t < 16; ++t) {
      const uint32_t word = sel4(cur.x, cur.y, cur.z, cur.w, t >> 2);
      const int c = (int)((word >> (8 * (t & 3))) & 0xffu);
      const bool good = c < 4, ext = started && good;
      const int cf = 3 - (c & 3);  // the base the interval extends by
      bool restart = good;
      if (__any_sync(FULL, ext)) {  // the warp's one lookup this position
        C o1, sz;
        if (__all_sync(FULL, !ext || narrow_ends<C, NW>(a, x1, x2))) {
          glookup_narrow<C, NW>(a, ext ? x1 - 1 : (C)-1, cf, gl, o1, sz);
        } else {
          C o2, ab;
          glookup<C, NW, false>(a, L2, ext ? x1 - 1 : (C)-1,
                                ext ? x1 - 1 + x2 : (C)-1, cf, gl, o1, o2,
                                ab);
          sz = o2 - o1;
        }
        if (ext) {
          if (sz >= 1) {
            x1 = l2_at(L2, cf) + 1 + o1;
            x2 = sz;
            restart = false;
          } else {
            ++brk;
          }
        }
      }
      if (restart) {  // bwt_set_intv
        x1 = l2_at(L2, cf) + 1;
        x2 = l2_next(L2, c & 3) - l2_at(L2, c & 3);
      }
      started = good;
    }
  }
  if (live && gl == 0) breaks[b] = brk;
}

template <typename C, int NW>
int launch_probe(const SeedArgs<C> &a, int32_t *breaks, cudaStream_t stream) {
  constexpr int G = NW / 4;
  const int64_t threads = (int64_t)a.B * G;
  const int block = WARPS * 32;
  probe_breaks_kernel<C, NW><<<(int)((threads + block - 1) / block), block,
                               0, stream>>>(a, breaks);
  return (int)cudaGetLastError();
}

template <typename C>
int launch_probe_nw(const SeedArgs<C> &a, int nw, int32_t *breaks,
                    cudaStream_t stream) {
  if (a.B == 0) return 0;
  switch (nw) {
    case 8: return launch_probe<C, 8>(a, breaks, stream);
    case 32: return launch_probe<C, 32>(a, breaks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K1's retire-and-refill mode in its group form (the JAX machine's
// refill=True, bwa_tpu/ops/fm_machine.py:369 seed_machine_seg): a group of
// G = 2R threads a lane, E = 32 / G lanes a warp, for launches of at least
// twice the lanes resident as a warp each (K1's own kernel takes the
// others).  Its plain version is bwa_tpu_torch/ops/fm_machine.py::
// seed_machine_seg(refill=True); each read's seeds, sorted by (start,
// end), are equal.
//
// The B lanes draw the n_queue reads of q: lane b starts on read b (lanes
// past n_queue start done), and a lane whose read is done and whose seed
// store holds cap_r more rows takes the next read with one atomicAdd by its
// group's first thread (broadcast by a shuffle); the cursor may pass
// n_queue by the failed draws, so the reads drawn are min(qctr, n_queue).
// Pass 2 scans only the current read's seeds (from seed_base) and the tag
// column is the read id.
//
// What bounds it: the instructions of a step, four lanes a warp at R = 4,
// each in its own phase, so a warp's step runs the code of every phase its
// lanes are in; and each lane's chain of dependent lookups, one a step (a
// backward row's entries are one a step here, at once in a warp a lane).
// Design:
//  1. A loop iteration is one step of the plain machine, whatever the
//     lane's phase, with at most one group lookup (glookup), at one place
//     in the loop, shared by the warp: every thread stays in the loop until
//     its warp is done, so the lookup's shuffles name every thread.  A
//     backward row takes its entries one a step, in the plain machine's
//     order, with its order-dependent rules as it has them: an entry is
//     pushed if it is not kept and the target stack is empty or its size
//     differs from the last push's; the push of rank r writes slot
//     min(r, cap - 1), the last such push winning; a kept entry emits only
//     while the target stack is empty, once a call row.
//  2. Stacks A and B in shared memory, one pair a lane, and the lane's read
//     staged there when it is drawn: the next start is found in its codes
//     (the plain version's next-valid table is not read); seeds and qmask
//     in global memory, written by the group.
//  3. Small enough that a block of 16 lanes (R = 4) fits six times an SM:
//     every lane of a 12,288-lane launch is resident from the start.
// ---------------------------------------------------------------------------

// bytes of a lane's staged codes
__host__ __device__ __forceinline__ size_t codes_bytes(int L) {
  return ((size_t)L + 15) & ~(size_t)15;
}

template <typename C, int NW>
__global__ void __launch_bounds__(WARPS * 32, sizeof(C) == 4 ? 6 : 5)
    seed_refill_kernel(SeedArgs<C> a) {
  constexpr int G = NW / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int slot = threadIdx.x / G;  // the lane's place in the block
  const int b = blockIdx.x * (blockDim.x / G) + slot;
  const bool real = b < a.B;  // past B: a lane that starts done, writes none
  const unsigned gmask = group_mask(lane, G);
  const int leader = lane & ~(G - 1);
  const int L = a.L, cap = a.cap, cap_s = a.cap_s;
  C *stkA = reinterpret_cast<C *>(smem_raw) + (size_t)slot * 2 * cap * 4;
  C *stkB = stkA + cap * 4;
  // the lane's read, its codes staged in shared memory past the stacks
  uint8_t *q = smem_raw + (size_t)(blockDim.x / G) * 2 * cap * 4 * sizeof(C) +
               (size_t)slot * codes_bytes(L);
  C *seeds = static_cast<C *>(a.seeds) + (size_t)(real ? b : 0) * cap_s * 6;
  uint8_t *qmask = a.qmask + (size_t)(real ? b : 0) * cap_s;
  C L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)a.L2[c];
  const bool vec = ((reinterpret_cast<uintptr_t>(a.q) | (uintptr_t)L) & 15) == 0;

  int rid = b, qlen = 0;
  auto take_read = [&](int r) {
    rid = r;
    qlen = a.qlen[r];
    const uint8_t *src = a.q + (size_t)r * L;
    if (vec) {
      for (int t = 16 * gl; t < L; t += 16 * G)
        *reinterpret_cast<uint4 *>(q + t) =
            __ldg(reinterpret_cast<const uint4 *>(src + t));
    } else {
      for (int t = gl; t < L; t += G) q[t] = src[t];
    }
  };
  int phase = P_NEXT, stage = S_P1, old_n = 0, job = 0, x = 0, i = 0, j = 0;
  C minv = 1, ik0 = 0, ik1 = 0, ik2 = 0, last_x2 = 0;
  int info_end = 0, an = 0, bn = 0, call_last_start = 0, call_mem_n = 0;
  int ret = 0, seed_n = 0, seed_base = 0, steps = 0, done_step = 0;
  bool cur_is_a = true, rev_read = true, ovf = false;
  if (real && b < a.n_queue) {
    take_read(b);
  } else {  // no read: done at the plain machine's step 1
    phase = P_DONE;
    done_step = 1;
  }
  __syncwarp();

  // one seed row, written by the group (the last slot keeps being
  // overwritten once the store is full; seed_n keeps counting)
  auto push_seed = [&](C r0, C r1, C r2, int r3, int r4) {
    const int s = seed_n < cap_s - 1 ? seed_n : cap_s - 1;
    for (int col = gl; col < 6; col += G)
      seeds[(size_t)s * 6 + col] = col == 0 ? r0 : col == 1 ? r1
                                 : col == 2 ? r2 : col == 3 ? (C)r3
                                 : col == 4 ? (C)r4 : (C)rid;
    if (gl == 0)
      qmask[s] = (r4 - r3) >= a.split_len && (int64_t)r2 <= a.split_width;
    ++seed_n;
  };
  // one stack row (ik or an extension and its end), written by the group
  auto push_row = [&](C *dst, C v0, C v1, C v2, C v3) {
    for (int col = gl; col < 4; col += G)
      dst[col] = col == 0 ? v0 : col == 1 ? v1 : col == 2 ? v2 : v3;
  };

  // every thread stays in the loop until its whole warp is done: the
  // step's lookup is the warp's, its shuffles name every thread
  while (__any_sync(FULL, phase != P_DONE)) {
    const bool stepping = phase != P_DONE;
    // ---------- P_NEXT: acquire the next job (stage-dependent) ----------
    if (phase == P_NEXT) {
      const bool st1m = stage == S_P2;
      bool have = false;
      if (st1m) {  // the first qualifying seed of this read at the cursor
        const int lim = old_n < cap_s ? old_n : cap_s;
        int jj = old_n;
        for (int base = job; base < lim; base += G) {
          const int s = base + gl;
          const unsigned m =
              (__ballot_sync(gmask, s < lim && qmask[s]) & gmask) >> leader;
          if (m) {
            jj = base + __ffs(m) - 1;
            break;
          }
        }
        have = jj < old_n;
        if (have) {
          const C *row = seeds + (size_t)jj * 6;
          x = ((int)row[3] + (int)row[4]) >> 1;
          minv = row[2] + 1;
        }
        job = jj + (have ? 1 : 0);
      } else {  // the first base at or after the cursor, below qlen
        const int p0 = job < 0 ? 0 : job;
        if (p0 < qlen && q[p0] < 4) {
          x = p0;
          have = true;
        } else {
          for (int base = p0 + 1; base < qlen; base += G) {
            const int p = base + gl;
            const unsigned m =
                (__ballot_sync(gmask, p < qlen && q[p] < 4) & gmask) >>
                leader;
            if (m) {
              x = base + __ffs(m) - 1;
              have = true;
              break;
            }
          }
        }
        minv = 1;
      }
      bool done_now = false;
      if (!have) {
        if (stage == S_P1) {
          old_n = seed_n;
          stage = S_P2;
          job = seed_base;  // pass 2 scans the current read's seeds
        } else if (st1m && a.use_p3) {
          stage = S_P3;
          job = 0;
        } else {
          done_now = true;
          if (seed_n <= cap_s - a.cap_r) {
            // draw the next read; the lane idles this step, as the plain
            // version's does
            int r = 0;
            if (gl == 0) r = atomicAdd(a.qctr, 1);
            r = __shfl_sync(gmask, r, leader);
            if (r < a.n_queue) {
              take_read(r);
              seed_base = seed_n;
              stage = S_P1;
              job = 0;
              done_now = false;
            }
          }
        }
      }
      if (minv < 1) minv = 1;
      phase = done_now ? P_DONE : P_NEXT;
      if (have) {
        const int qx = q[clampi(x, 0, L - 1)];
        if (qx < 4) {  // bwt_set_intv; the forward step runs in this step
          ik0 = l2_at(L2, qx) + 1;
          ik1 = l2_at(L2, 3 - qx) + 1;
          ik2 = l2_next(L2, qx) - l2_at(L2, qx);
          info_end = x + 1;
          i = x + 1;
          an = 0;
          phase = P_FWD;
        }
      }
    }

    // ---------- the step's lookup, the warp's one ----------
    const int qi = i >= 0 ? q[clampi(i, 0, L - 1)] : 4;
    const int pn = cur_is_a ? an : bn;
    const bool fwd = phase == P_FWD, bwd = phase == P_BWD, entry = bwd && j < pn;
    C p0 = 0, p1 = 0, p2 = 0;
    int p3 = 0;
    if (entry) {
      const C *pr = (cur_is_a ? stkA : stkB) +
                    clampi(rev_read ? pn - 1 - j : j, 0, cap - 1) * 4;
      p0 = pr[0];
      p1 = pr[1];
      p2 = pr[2];
      p3 = (int)pr[3];
    }
    // fwd: base 3 - q[i] at ik; an entry: base q[i] (an N keeps it) at p
    const int cb = fwd ? 3 - (qi & 3) : (qi & 3);
    const bool need = (fwd && i < qlen && qi < 4) || (entry && qi < 4);
    const C lk = fwd ? ik1 : p0, lsz = fwd ? ik2 : p2;
    C o1 = 0, o2 = 0, ab = 0;
    if (__any_sync(FULL, need))
      glookup<C, NW, true>(a, L2, need ? lk - 1 : (C)-1,
                           need ? lk - 1 + lsz : (C)-1, cb, gl, o1, o2, ab);
    const C span = (lk <= a.primary && lk + lsz - 1 >= a.primary) ? 1 : 0;

    // ---------- P_FWD: one forward extension (stages 1/2, or 3) ----------
    if (fwd) {
      const C of0 = ik0 + span + ab, of1 = l2_at(L2, cb) + 1 + o1,
              of2 = o2 - o1;
      const bool run_f = i < qlen, amb = run_f && qi >= 4;
      if (stage != S_P3) {  // bwt_smem1a's forward loop
        const bool ext_m = run_f && !amb, changed = ext_m && of2 != ik2;
        if (amb || changed || !run_f) {
          push_row(stkA + (an < cap - 1 ? an : cap - 1) * 4, ik0, ik1, ik2,
                   (C)info_end);
          if (an >= cap) ovf = true;
          ++an;
        }
        const bool stop_f = amb || (changed && of2 < minv) || !run_f;
        if (ext_m && !stop_f) {
          ik0 = of0; ik1 = of1; ik2 = of2;
          info_end = i + 1;
          ++i;
        }
        if (stop_f) {
          ret = info_end;
          cur_is_a = true;
          rev_read = true;
          bn = 0;
          j = 0;
          i = x - 1;
          call_mem_n = 0;
          last_x2 = 0;
          phase = P_BWD;
        }
      } else {  // bwt_seed_strategy1
        const bool ext3 = run_f && !amb;
        const bool hit3 = ext3 && (int64_t)of2 < a.max_intv3 &&
                          (i - x) >= a.min_seed_len;
        if (hit3 && of2 > 0) push_seed(of0, of1, of2, x, i + 1);
        if (ext3 && !hit3) {
          ik0 = of0; ik1 = of1; ik2 = of2;
          ++i;
        }
        if (amb || hit3) job = i + 1;
        else if (!run_f) job = qlen;
        if (amb || hit3 || !run_f) phase = P_NEXT;
      }
    } else if (bwd) {
      // ---------- P_BWD: entry j of row i ----------
      if (entry) {
        const C ob0 = l2_at(L2, cb) + 1 + o1, ob1 = p1 + span + ab,
                ob2 = o2 - o1;
        const bool keep = qi >= 4 || ob2 < minv;  // i < 0 reads qi = 4
        const int curr_n = cur_is_a ? bn : an;  // the target stack's
        if (keep) {  // the row's first kept entry ends an SMEM
          if (curr_n == 0 && (call_mem_n == 0 || i + 1 < call_last_start)) {
            if (p3 - (i + 1) >= a.min_seed_len)
              push_seed(p0, p1, p2, i + 1, p3);
            call_last_start = i + 1;
            ++call_mem_n;
          }
        } else if (curr_n == 0 || ob2 != last_x2) {
          push_row((cur_is_a ? stkB : stkA) +
                       (curr_n < cap - 1 ? curr_n : cap - 1) * 4,
                   ob0, ob1, ob2, (C)p3);
          if (curr_n >= cap) ovf = true;
          if (cur_is_a) ++bn;
          else ++an;
          last_x2 = ob2;
        }
        ++j;
      }
      if (j >= pn) {  // the row is done
        if ((cur_is_a ? bn : an) == 0 || i < 0) {  // and the call
          if (stage == S_P1) job = ret;
          phase = P_NEXT;
        } else {
          cur_is_a = !cur_is_a;
          rev_read = false;
          if (cur_is_a) bn = 0;
          else an = 0;
          --i;
          j = 0;
          last_x2 = 0;
        }
      }
    }
    if (stepping) {
      ++steps;
      if (phase == P_DONE && done_step == 0) done_step = steps;
    }
    __syncwarp();
  }

  if (!real) return;
  // the slots no push reached hold zeros, as in the plain version
  const int filled = seed_n < cap_s ? seed_n : cap_s;
  for (size_t t = (size_t)filled * 6 + gl; t < (size_t)cap_s * 6; t += G)
    seeds[t] = 0;
  if (gl == 0) {
    a.seed_n[b] = seed_n;
    a.ovf[b] = ovf ? 1 : 0;
    a.done_step[b] = done_step;
    atomicMax(a.steps, steps);
  }
}

// shared memory a block of the refill kernel takes: each lane's stacks and
// its read's codes
template <typename C, int NW>
size_t refill_smem(int cap, int L, int threads) {
  return (size_t)(threads / (NW / 4)) *
         (2 * cap * 4 * sizeof(C) + codes_bytes(L));
}

// threads a block of the refill kernel: 4 warps, fewer where the lanes'
// stacks and codes would pass a block's shared memory
template <typename C, int NW>
int refill_block(int cap, int L) {
  int threads = WARPS * 32;
  while (threads > 32 && refill_smem<C, NW>(cap, L, threads) > 232448)
    threads /= 2;
  return threads;
}

template <typename C, int NW>
int launch_refill(const SeedArgs<C> &a, cudaStream_t stream) {
  const int threads = refill_block<C, NW>(a.cap, a.L);
  const size_t smem = refill_smem<C, NW>(a.cap, a.L, threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_refill_kernel<C, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)e;
    }
  }
  const int lanes = threads / (NW / 4);
  seed_refill_kernel<C, NW><<<(a.B + lanes - 1) / lanes, threads, smem,
                              stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename C>
int launch_refill_nw(const SeedArgs<C> &a, int nw, cudaStream_t stream) {
  if (a.B == 0) return 0;
  if (a.cap < 1 || a.cap_s < 1) return (int)cudaErrorInvalidValue;
  switch (nw) {
    case 8: return launch_refill<C, 8>(a, stream);
    case 32: return launch_refill<C, 32>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the refill mode's group form (group != 0), else K1's warp per lane
template <typename C>
int launch_any(const SeedArgs<C> &a, int nw, int group, cudaStream_t stream) {
  return a.qctr != nullptr && group ? launch_refill_nw(a, nw, stream)
                                    : launch_nw(a, nw, stream);
}

// An empty kernel: timed beside a module's first real launch, it splits
// that launch's cost (loading the module, the kernel)
__global__ void noop_kernel() {}

// Registers, static shared memory and occupancy of a kernel at the block and
// dynamic shared memory of its launch
template <typename... A>
int kernel_attrs(void (*kern)(A...), int block, size_t smem, int32_t *out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, block,
                                                      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)fa.localSizeBytes;
  out[3] = block;
  out[4] = (int)smem;
  out[5] = blocks;
  out[6] = blocks * block / 32;  // resident warps an SM
  return 0;
}

template <typename C, int NW>
int attrs_of(int which, int cap, int L, int32_t *out) {
  switch (which) {
    case 0:
      return kernel_attrs(seed_machine_kernel<C, NW, false>, WARPS * 32,
                          (size_t)WARPS * 2 * cap * 4 * sizeof(C), out);
    case 1: {
      const int threads = refill_block<C, NW>(cap, L);
      return kernel_attrs(seed_refill_kernel<C, NW>, threads,
                          refill_smem<C, NW>(cap, L, threads), out);
    }
    case 2:
      return kernel_attrs(probe_breaks_kernel<C, NW>, WARPS * 32, 0, out);
    default:
      return kernel_attrs(noop_kernel, 32, 0, out);
  }
}

// K1's state mode (K12, K13): B lanes of q resumed from the typed state
// (ints [18, B] int32, coords [5, B], stk [B, 2, cap, 4], seeds
// [B, cap_s, 5] of the coordinate type and qmask [B, cap_s], all updated
// in place) for at most max_steps steps past steps_in[0]; each lane ends
// with last_stage, pass 2 reading its jobs from `jobs` when given;
// steps_out, which must not hold more than steps_in, ends as the largest
// lane's count.
template <typename C>
int seed_state(const uint32_t *occtab, int nw, const int64_t *L2,
               int64_t primary, int64_t seq_len, const uint8_t *q, int B,
               int L, const int32_t *qlen, const int32_t *nv,
               int min_seed_len, int split_len, int64_t split_width,
               int64_t max_intv3, int cap, int cap_s, int use_p3,
               int last_stage, const void *jobs, int32_t *ints, void *coords,
               void *stk, void *seeds, uint8_t *qmask,
               const int32_t *steps_in, int32_t *steps_out,
               int64_t max_steps, cudaStream_t stream) {
  SeedArgs<C> a{};
  a.occtab = occtab; a.L2 = L2; a.primary = (C)primary;
  a.seq_len = (C)seq_len; a.q = q; a.B = B; a.n_queue = B; a.L = L;
  a.qlen = qlen; a.nv = nv; a.hi1 = a.hi3 = qlen;
  a.min_seed_len = min_seed_len; a.split_len = split_len;
  a.split_width = split_width; a.max_intv3 = max_intv3; a.cap = cap;
  a.cap_s = cap_s; a.use_p3 = use_p3; a.seeds = seeds; a.steps = steps_out;
  a.qmask = qmask; a.last_stage = last_stage;
  a.jobs = static_cast<const C *>(jobs); a.ints = ints;
  a.coords = static_cast<C *>(coords); a.stk = static_cast<C *>(stk);
  a.steps_in = steps_in; a.max_steps = max_steps;
  return launch_nw<C, true>(a, nw, stream);
}

}  // namespace

extern "C" int bwa_seed_machine(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int n_queue,
    int L, const int32_t *qlen, const int32_t *nv, const int32_t *job_lo,
    const int32_t *hi1, const int32_t *hi3, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_intv3, int cap, int cap_s, int use_p3,
    int tagged, int cap_r, void *seeds, int32_t *seed_n, uint8_t *ovf,
    int32_t *done_step, int32_t *steps, uint8_t *qmask, int32_t *qctr,
    int group, void *stream) {
  if (qctr == nullptr && n_queue != B) return (int)cudaErrorInvalidValue;
  if (qctr != nullptr && !tagged) return (int)cudaErrorInvalidValue;
  if (coord64) {
    SeedArgs<int64_t> a{occtab, L2, primary, seq_len, q, B, n_queue, L,
                        qlen, nv, job_lo, hi1, hi3, min_seed_len, split_len,
                        split_width, max_intv3, cap, cap_s, use_p3, tagged,
                        cap_r, seeds, seed_n, done_step, steps, ovf, qmask,
                        qctr, S_P3};
    return launch_any(a, nw, group, (cudaStream_t)stream);
  }
  SeedArgs<int32_t> a{occtab, L2, (int32_t)primary, (int32_t)seq_len, q, B,
                      n_queue, L, qlen, nv, job_lo, hi1, hi3, min_seed_len,
                      split_len, split_width, max_intv3, cap, cap_s, use_p3,
                      tagged, cap_r, seeds, seed_n, done_step, steps, ovf,
                      qmask, qctr, S_P3};
  return launch_any(a, nw, group, (cudaStream_t)stream);
}

extern "C" int bwa_seed_state(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *nv, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_intv3, int cap, int cap_s, int use_p3,
    int last_stage, const void *jobs, int32_t *ints, void *coords, void *stk,
    void *seeds, uint8_t *qmask, const int32_t *steps_in,
    int32_t *steps_out, int64_t max_steps, void *stream) {
  auto f = coord64 ? seed_state<int64_t> : seed_state<int32_t>;
  return f(occtab, nw, L2, primary, seq_len, q, B, L, qlen, nv, min_seed_len,
           split_len, split_width, max_intv3, cap, cap_s, use_p3, last_stage,
           jobs, ints, coords, stk, seeds, qmask, steps_in, steps_out,
           max_steps, (cudaStream_t)stream);
}

extern "C" int bwa_probe_breaks(int coord64, const uint32_t *occtab, int nw,
                                const int64_t *L2, int64_t primary,
                                int64_t seq_len, const uint8_t *q, int B,
                                int L, int32_t *breaks, void *stream) {
  if (coord64) {
    SeedArgs<int64_t> a{};
    a.occtab = occtab; a.L2 = L2; a.primary = primary; a.seq_len = seq_len;
    a.q = q; a.B = B; a.n_queue = B; a.L = L;
    return launch_probe_nw(a, nw, breaks, (cudaStream_t)stream);
  }
  SeedArgs<int32_t> a{};
  a.occtab = occtab; a.L2 = L2; a.primary = (int32_t)primary;
  a.seq_len = (int32_t)seq_len; a.q = q; a.B = B; a.n_queue = B; a.L = L;
  return launch_probe_nw(a, nw, breaks, (cudaStream_t)stream);
}

// Step-0 numbers of a kernel (which: 0 K1, 1 K1's refill mode, 2 K8, 3 the
// empty kernel) at nw text words a row, stack cap `cap` and reads of L
// codes: out[7] =
// registers a thread, static shared bytes, local bytes, block threads,
// dynamic shared bytes, resident blocks an SM, resident warps an SM
extern "C" int bwa_seed_kernel_attrs(int which, int coord64, int nw, int cap,
                                     int L, int32_t *out) {
  if (nw != 8 && nw != 32) return (int)cudaErrorInvalidValue;
  if (coord64)
    return nw == 8 ? attrs_of<int64_t, 8>(which, cap, L, out)
                   : attrs_of<int64_t, 32>(which, cap, L, out);
  return nw == 8 ? attrs_of<int32_t, 8>(which, cap, L, out)
                 : attrs_of<int32_t, 32>(which, cap, L, out);
}

// One launch of the empty kernel on the stream
extern "C" int bwa_seed_noop(void *stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
