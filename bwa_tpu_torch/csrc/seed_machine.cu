// Kernel K1: the per-lane SMEM seeding machine.
//
// Replaces the JAX package's XLA while_loop
// bwa_tpu/ops/fm_machine.py::seed_machine_seg (with ops/fm.py::_occ4,
// _extend and _set_intv): all three seeding passes of mem_collect_intv
// (bwamem.c:140-188) -- pass 1 SMEMs (bwt_smem1a, bwt.c:289-351), pass 2
// re-seeding from the midpoints of long unique SMEMs, pass 3 LAST-like
// seeds (bwt_seed_strategy1, bwt.c:358-379) on lanes whose hi3 bound is
// non-zero.
//
// Design: one thread per lane runs its machine to completion in a single
// launch; each loop iteration is one step of the plain version
// (bwa_tpu_torch/ops/fm_machine.py::seed_machine_seg), statement for
// statement, so the per-lane outputs (seeds, seed_n, ovf) are identical.
// The interval stacks (capped at `cap`) and the seed store (capped at
// `cap_s`) live in global scratch, one slice per lane; a full stack keeps
// overwriting its last slot and raises the lane's overflow flag, exactly
// as the plain version does, so the host retry ladder sees the same flags.
//
// What bounds it: each machine step does two occ4 lookups, i.e. two
// dependent random reads of a (16 + 32R)-byte occtab row from device
// memory, plus a handful of popcounts.  The kernel is latency-bound on
// those reads (the table of a 4.6 Mbp genome is 1.5 MB and stays in L2);
// many lanes in flight per SM hide part of it.  Lanes diverge freely: a
// lane never waits for another lane's step.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (bwa_tpu_torch/ops/cuda_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P_NEXT = 0, P_FWD = 1, P_BWD = 2, P_DONE = 3;
constexpr int S_P1 = 0, S_P2 = 1, S_P3 = 2;
constexpr uint32_t M55 = 0x55555555u;

template <typename C>
struct SeedArgs {
  const uint32_t *occtab;  // [n_rows, 4 + nw] counts || text words
  int nw;                  // 8R words per row
  int rbits;               // log2(R)
  const int64_t *L2;       // [5]
  int64_t primary, seq_len;
  const uint8_t *q;        // [B, L] read codes
  int B, L;
  const int32_t *qlen, *nv, *job_lo, *hi1, *hi3;  // nv: [B, L+1]
  int min_seed_len, split_len;
  int64_t split_width, max_intv3;
  int cap, cap_s, use_p3, tagged;
  C *seeds;                // [B, cap_s, 5|6]
  int32_t *seed_n, *done_step, *steps;
  uint8_t *ovf;
  C *stk;                  // [B, 2, cap, 4] scratch (stacks A and B)
  uint8_t *qmask;          // [B, cap_s] scratch
};

__device__ __forceinline__ int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// bwt_occ4 (bwt.c:169-186) from the fused occtab; k == -1 -> zeros,
// k == seq_len -> the L2 differences.
template <typename C>
__device__ void occ4(const SeedArgs<C> &a, int64_t k, int64_t out[4]) {
  if (k == -1) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  if (k == a.seq_len) {
    for (int c = 0; c < 4; ++c) out[c] = a.L2[c + 1] - a.L2[c];
    return;
  }
  int64_t kk = k - (k >= a.primary ? 1 : 0);
  kk = clampi(kk, 0, a.seq_len - 1);
  const uint32_t *row = a.occtab + (kk >> (7 + a.rbits)) * (int64_t)(4 + a.nw);
  int kw = (int)((kk >> 4) & (a.nw - 1));
  int kb = (int)(kk & 15);
  int64_t c0 = row[0], c1 = row[1], c2 = row[2], c3 = row[3];
  for (int w = 0; w <= kw; ++w) {
    int nkeep = w < kw ? 16 : kb + 1;
    uint32_t mask = 0xFFFFFFFFu << ((16 - nkeep) << 1);
    uint32_t word = row[4 + w] & mask;
    uint32_t vm = mask & M55;
    uint32_t hi = (word >> 1) & M55, lo = word & M55;
    int n3 = __popc(hi & lo), nhi = __popc(hi), nlo = __popc(lo);
    int nv = __popc(vm);
    c0 += nv - nhi - nlo + n3;
    c1 += nlo - n3;
    c2 += nhi - n3;
    c3 += n3;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

template <typename C>
__device__ void push_row(C *buf, int64_t &n, int cap, int ncol,
                         const int64_t *row, bool &ovf) {
  int64_t slot = n < cap - 1 ? n : cap - 1;
  C *dst = buf + slot * ncol;
  for (int t = 0; t < ncol; ++t) dst[t] = (C)row[t];
  if (n >= cap) ovf = true;
  ++n;
}

template <typename C>
__global__ void seed_machine_kernel(SeedArgs<C> a) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int L = a.L, cap = a.cap, cap_s = a.cap_s;
  const int ncol = a.tagged ? 6 : 5;
  const uint8_t *q = a.q + (int64_t)b * L;
  const int32_t *nv = a.nv + (int64_t)b * (L + 1);
  const int64_t qlen = a.qlen[b], hi1 = a.hi1[b], hi3 = a.hi3[b];
  C *stkA = a.stk + (int64_t)b * 2 * cap * 4;
  C *stkB = stkA + cap * 4;
  C *seeds = a.seeds + (int64_t)b * cap_s * ncol;
  uint8_t *qmask = a.qmask + (int64_t)b * cap_s;
  for (int64_t t = 0; t < (int64_t)cap_s * ncol; ++t) seeds[t] = 0;
  for (int t = 0; t < cap_s; ++t) qmask[t] = 0;
  for (int t = 0; t < 2 * cap * 4; ++t) stkA[t] = 0;
  int64_t L2[5];
  for (int c = 0; c < 5; ++c) L2[c] = a.L2[c];

  int phase = P_NEXT, stage = S_P1;
  int64_t old_n = 0, job = a.job_lo[b], x = 0, minv = 1;
  int64_t ik[3] = {0, 0, 0};
  int64_t info_end = 0, i = 0, j = 0, an = 0, bn = 0;
  bool cur_is_a = true, rev_read = true, ovf = false;
  int64_t last_x2 = 0, call_last_start = 0, call_mem_n = 0, ret = 0;
  int64_t seed_n = 0, cur_tag = 0, steps = 0, done_step = 0;

  while (phase != P_DONE) {
    const bool st1m = stage == S_P2;
    bool st2m = stage == S_P3;

    // ---------- P_NEXT: acquire the next job (stage-dependent) ----------
    const bool nx = phase == P_NEXT;
    bool have = false, to_done = false;
    if (nx) {
      int64_t xv = nv[clampi(job, 0, L)];
      bool have_nv = !st1m && xv < (st2m ? hi3 : hi1);
      bool have_s1 = false;
      int64_t x_s1 = 0;
      if (st1m) {
        int64_t jj_first = cap_s;
        int64_t lim = old_n < cap_s ? old_n : cap_s;
        for (int64_t s = job; s < lim; ++s)
          if (qmask[s]) { jj_first = s; break; }
        bool found = jj_first < cap_s;
        int64_t jj = found ? jj_first : old_n;
        int64_t k = jj < cap_s - 1 ? jj : cap_s - 1;
        have_s1 = found && jj < old_n;
        const C *row = seeds + k * ncol;
        int64_t r2 = row[2], r3 = row[3], r4 = row[4];
        x_s1 = (r3 + r4) >> 1;
        if (a.tagged && have_s1) cur_tag = (r3 << 15) | r4;
        if (have_s1) minv = r2 + 1;
        job = jj + (have_s1 ? 1 : 0);
      } else {
        minv = 1;
      }
      have = st1m ? have_s1 : have_nv;
      if (have) x = st1m ? x_s1 : xv;
      bool exh = !have;
      bool to_s2 = exh && stage == S_P1;
      bool to_s3 = exh && st1m && a.use_p3;
      to_done = exh && (st2m || (st1m && !a.use_p3));
      if (to_s2) old_n = seed_n;
      if (to_s2) stage = S_P2;
      else if (to_s3) stage = S_P3;
      if (to_s2 || to_s3) job = 0;
    }
    st2m = stage == S_P3;
    bool startable = false;
    if (have) {
      int64_t qx = q[clampi(x, 0, L - 1)];
      startable = qx < 4;
      if (startable) {  // bwt_set_intv
        int64_t cc = qx;
        ik[0] = L2[cc] + 1;
        ik[1] = L2[3 - cc] + 1;
        ik[2] = L2[cc + 1] - L2[cc];
        info_end = x + 1;
        i = x + 1;
        an = 0;
      }
    }
    if (minv < 1) minv = 1;
    if (startable) phase = P_FWD;
    else if (to_done) phase = P_DONE;

    // ---------- shared occ work ----------
    const bool in_fwd = phase == P_FWD, in_bwd = phase == P_BWD;
    const int64_t pn = cur_is_a ? an : bn;
    int64_t jj2 = clampi(rev_read ? pn - 1 - j : j, 0, cap - 1);
    const C *prow = (cur_is_a ? stkA : stkB) + jj2 * 4;
    const int64_t p0 = prow[0], p1 = prow[1], p2 = prow[2], p3 = prow[3];
    int64_t ok_nb[4] = {0, 0, 0, 0}, ok_sz[4] = {0, 0, 0, 0};
    int64_t accs[4] = {0, 0, 0, 0};
    if (in_fwd || in_bwd) {
      int64_t e0 = in_bwd ? p0 : ik[0], e1 = in_bwd ? p1 : ik[1];
      int64_t e2 = in_bwd ? p2 : ik[2];
      int64_t fwd_side = in_bwd ? e0 : e1;
      int64_t tk[4], tl[4];
      occ4(a, fwd_side - 1, tk);
      occ4(a, fwd_side - 1 + e2, tl);
      for (int c = 0; c < 4; ++c) {
        ok_nb[c] = L2[c] + 1 + tk[c];
        ok_sz[c] = tl[c] - tk[c];
      }
      int64_t bk = in_bwd ? e1 : e0;
      int64_t span = (fwd_side <= a.primary && fwd_side + e2 - 1 >= a.primary);
      accs[3] = bk + span;
      accs[2] = accs[3] + ok_sz[3];
      accs[1] = accs[2] + ok_sz[2];
      accs[0] = accs[1] + ok_sz[1];
    }
    const int64_t qi = q[clampi(i, 0, L - 1)];
    const int64_t qb_i = i >= 0 ? qi : 4;
    const int cf = (int)clampi(3 - qi, 0, 3);
    const int64_t of0 = accs[cf], of1 = ok_nb[cf], of2 = ok_sz[cf];

    // ---------- P_FWD micro-op (SMEM forward for stages 1/2) ----------
    if (in_fwd && !st2m) {
      bool run_f = i < qlen;
      bool off_end = !run_f;
      bool amb = run_f && qi >= 4;
      bool ext_m = run_f && !amb;
      bool changed = ext_m && of2 != ik[2];
      if (amb || changed || off_end) {
        int64_t rowf[4] = {ik[0], ik[1], ik[2], info_end};
        push_row(stkA, an, cap, 4, rowf, ovf);
      }
      bool too_small = changed && of2 < minv;
      bool stop_f = amb || too_small || off_end;
      if (ext_m && !stop_f) {
        ik[0] = of0; ik[1] = of1; ik[2] = of2;
        info_end = i + 1;
        i = i + 1;
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
    }

    // ---------- P_FWD micro-op, stage 3 (bwt_seed_strategy1) ----------
    bool write3 = false;
    int64_t row3[5] = {of0, of1, of2, x, i + 1};
    if (a.use_p3 && in_fwd && st2m) {
      bool run3 = i < qlen;
      bool hit_end3 = !run3;
      bool amb3 = run3 && qi >= 4;
      bool ext3 = run3 && !amb3;
      bool hit3 = ext3 && of2 < a.max_intv3 && (i - x) >= a.min_seed_len;
      write3 = hit3 && of2 > 0;
      if (ext3 && !hit3) {
        ik[0] = of0; ik[1] = of1; ik[2] = of2;
        i = i + 1;
      }
      if (amb3 || hit3) job = i + 1;
      else if (hit_end3) job = qlen;
      if (amb3 || hit3 || hit_end3) phase = P_NEXT;
    }

    // ---------- P_BWD micro-op (one j of row i) ----------
    bool jact = false, keep = false, can_emit = false, write = false;
    int64_t ob0 = 0, ob1 = 0, ob2 = 0, curr_n_now = 0;
    if (in_bwd) {
      int64_t c = (i >= 0 && qb_i < 4) ? qb_i : -1;
      jact = j < pn;
      int cb = (int)clampi(c, 0, 3);
      ob0 = ok_nb[cb]; ob1 = accs[cb]; ob2 = ok_sz[cb];
      keep = jact && (c < 0 || ob2 < minv);
      curr_n_now = cur_is_a ? bn : an;
      can_emit = keep && curr_n_now == 0 &&
                 (call_mem_n == 0 || (i + 1) < call_last_start);
      int64_t slen = p3 - (i + 1);
      write = can_emit && slen >= a.min_seed_len;
    }
    if (write || write3) {
      int64_t row[6];
      if (write3) {
        for (int t = 0; t < 5; ++t) row[t] = row3[t];
      } else {
        row[0] = p0; row[1] = p1; row[2] = p2; row[3] = i + 1; row[4] = p3;
      }
      row[5] = write3 ? -1 : (st1m ? cur_tag : 0);
      bool qual_new = (row[4] - row[3]) >= a.split_len && row[2] <= a.split_width;
      qmask[seed_n < cap_s - 1 ? seed_n : cap_s - 1] = qual_new;
      bool dummy = false;
      push_row(seeds, seed_n, cap_s, ncol, row, dummy);
    }
    if (in_bwd) {
      if (can_emit) {
        call_last_start = i + 1;
        ++call_mem_n;
      }
      bool push_b = jact && !keep && (curr_n_now == 0 || ob2 != last_x2);
      if (push_b) {
        int64_t rowb[4] = {ob0, ob1, ob2, p3};
        if (cur_is_a) push_row(stkB, bn, cap, 4, rowb, ovf);
        else push_row(stkA, an, cap, 4, rowb, ovf);
        last_x2 = ob2;
      }
      if (jact) ++j;
      if (j >= pn) {  // row done
        int64_t new_n = cur_is_a ? bn : an;
        bool call_over = new_n == 0 || i < 0;
        if (!call_over) {
          cur_is_a = !cur_is_a;
          rev_read = false;
          if (cur_is_a) bn = 0;
          else an = 0;
          --i;
          j = 0;
          last_x2 = 0;
        } else {
          if (stage == S_P1) job = ret;
          phase = P_NEXT;
        }
      }
    }
    ++steps;
    if (phase == P_DONE && done_step == 0) done_step = steps;
  }
  a.seed_n[b] = (int32_t)seed_n;
  a.ovf[b] = ovf ? 1 : 0;
  a.done_step[b] = (int32_t)done_step;
  atomicMax(a.steps, (int32_t)steps);
}

template <typename C>
int launch(const SeedArgs<C> &a, cudaStream_t stream) {
  if (a.B == 0) return 0;
  const int threads = 128;
  seed_machine_kernel<C><<<(a.B + threads - 1) / threads, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bwa_seed_machine(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *nv, const int32_t *job_lo,
    const int32_t *hi1, const int32_t *hi3, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_intv3, int cap, int cap_s, int use_p3,
    int tagged, void *seeds, int32_t *seed_n, uint8_t *ovf,
    int32_t *done_step, int32_t *steps, void *stk, uint8_t *qmask,
    void *stream) {
  int rbits = 0;
  while ((8 << rbits) < nw) ++rbits;
  if (coord64) {
    SeedArgs<int64_t> a{occtab, nw, rbits, L2, primary, seq_len, q, B, L,
                        qlen, nv, job_lo, hi1, hi3, min_seed_len, split_len,
                        split_width, max_intv3, cap, cap_s, use_p3, tagged,
                        (int64_t *)seeds, seed_n, done_step, steps, ovf,
                        (int64_t *)stk, qmask};
    return launch(a, (cudaStream_t)stream);
  }
  SeedArgs<int32_t> a{occtab, nw, rbits, L2, primary, seq_len, q, B, L,
                      qlen, nv, job_lo, hi1, hi3, min_seed_len, split_len,
                      split_width, max_intv3, cap, cap_s, use_p3, tagged,
                      (int32_t *)seeds, seed_n, done_step, steps, ovf,
                      (int32_t *)stk, qmask};
  return launch(a, (cudaStream_t)stream);
}
