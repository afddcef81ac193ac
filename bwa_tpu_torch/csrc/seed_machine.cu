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
//     the same base at once, 32/G a round.  What depends on order comes
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
//
// Kernel K8, probe_breaks, lives here too: it reads the same occtab with
// the same cooperative extend_c (see probe_breaks_kernel below).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (bwa_tpu_torch/ops/cuda_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P_NEXT = 0, P_FWD = 1, P_BWD = 2, P_DONE = 3;
constexpr int S_P1 = 0, S_P2 = 1, S_P3 = 2;
constexpr uint32_t M55 = 0x55555555u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // lanes (warps) a block
constexpr int WPT = 8;    // occtab words a thread reads for one lookup

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
  C *seeds;                // [B, cap_s, 5|6]
  int32_t *seed_n, *done_step, *steps;
  uint8_t *ovf;
  uint8_t *qmask;          // [B, cap_s] scratch
  int32_t *qctr;           // refill mode's queue cursor, else null
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// v[c] for a c known only at run time, by selects (no local memory)
template <typename C>
__device__ __forceinline__ C pick(const C v[5], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : c == 3 ? v[3] : v[4];
}

// bwt_extend's counting half for one interval and base c, by a group of
// G = 2H threads (gl: thread in the group).  Threads [0, H) count B[0..k1],
// threads [H, 2H) B[0..k2] (bwt_occ4, bwt.c:169-186; k == -1 gives zeros,
// k == seq_len the L2 differences).  Every thread of the group leaves with
//   nb = L2[c] + 1 + occ(k1)[c],  sz = occ(k2)[c] - occ(k1)[c],
//   above = sum over c' > c of occ(k2)[c'] - occ(k1)[c'].
template <typename C, int NW>
__device__ __forceinline__ void extend_c(const SeedArgs<C> &a, const C L2[5],
                                         C k1, C k2, int gl, int c, C &nb,
                                         C &sz, C &above) {
  constexpr int H = NW / WPT;
  constexpr int RB = NW == 8 ? 0 : 2;  // log2(R)
  const bool half = gl >= H;
  const int h = half ? gl - H : gl;
  const C k = half ? k2 : k1;
  C kk = k - (k >= a.primary ? 1 : 0);
  kk = kk < 0 ? 0 : (kk > a.seq_len - 1 ? a.seq_len - 1 : kk);
  const uint4 *row = reinterpret_cast<const uint4 *>(
      a.occtab + (size_t)(kk >> (7 + RB)) * (4 + NW));
  const uint4 cnt = __ldg(row);
  uint4 w[WPT / 4];
#pragma unroll
  for (int u = 0; u < WPT / 4; ++u) w[u] = __ldg(row + 1 + h * (WPT / 4) + u);
  const int kw = (int)(kk >> 4) & (NW - 1), kb = (int)(kk & 15);
  uint32_t packed = 0;  // counts of bases 1, 2, 3 in 10 bits each
#pragma unroll
  for (int u = 0; u < WPT / 4; ++u) {
    const uint32_t ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int nkeep = (kw - (h * WPT + u * 4 + t)) * 16 + kb + 1;
      const uint32_t mask = nkeep <= 0 ? 0u
                            : nkeep >= 16 ? FULL
                                          : FULL << ((16 - nkeep) << 1);
      const uint32_t word = ws[t] & mask;
      const uint32_t hi = (word >> 1) & M55, lo = word & M55;
      const uint32_t n3 = __popc(hi & lo);
      packed += (__popc(lo) - n3) | ((__popc(hi) - n3) << 10) | (n3 << 20);
    }
  }
#pragma unroll
  for (int off = 1; off < H; off <<= 1)
    packed += __shfl_xor_sync(FULL, packed, off);
  const int n1 = packed & 1023, n2 = (packed >> 10) & 1023, n3 = packed >> 20;
  C o0 = (C)cnt.x + (kw * 16 + kb + 1 - n1 - n2 - n3);
  C o1 = (C)cnt.y + n1, o2 = (C)cnt.z + n2, o3 = (C)cnt.w + n3;
  if (k == -1) {
    o0 = o1 = o2 = o3 = 0;
  } else if (k == a.seq_len) {
    o0 = L2[1] - L2[0]; o1 = L2[2] - L2[1];
    o2 = L2[3] - L2[2]; o3 = L2[4] - L2[3];
  }
  const C oc = c == 0 ? o0 : (c == 1 ? o1 : (c == 2 ? o2 : o3));
  const C ab = (c < 1 ? o1 : 0) + (c < 2 ? o2 : 0) + (c < 3 ? o3 : 0);
  const C oc_x = __shfl_xor_sync(FULL, oc, H);
  const C ab_x = __shfl_xor_sync(FULL, ab, H);
  const C tk = half ? oc_x : oc, tl = half ? oc : oc_x;
  nb = pick(L2, c) + 1 + tk;
  sz = tl - tk;
  above = (half ? ab : ab_x) - (half ? ab_x : ab);
}

template <typename C, int NW>
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
  C *seeds = a.seeds + (size_t)b * cap_s * ncol;
  uint8_t *qmask = a.qmask + (size_t)b * cap_s;
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
  C minv = 1, ik0 = 0, ik1 = 0, ik2 = 0;
  int info_end = 0, i = 0, an = 0, bn = 0;
  bool cur_is_a = true, rev_read = true, ovf = false;
  int call_last_start = 0, call_mem_n = 0, ret = 0, seed_n = 0;
  int seed_base = 0;  // the current read's first seed slot (refill)
  int64_t cur_tag = 0;
  int steps = 0, done_step = 0;
  if (b < a.n_queue) {
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

  while (phase != P_DONE) {
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
          const unsigned m = __ballot_sync(FULL, s < lim && qmask[s]);
          if (m) {
            jj = base + __ffs(m) - 1;
            break;
          }
        }
        have_s1 = jj < old_n;
        if (have_s1) {
          const C *row = seeds + (size_t)jj * ncol;
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
      const bool to_s2 = exh && stage == S_P1;
      const bool to_s3 = exh && st1m && a.use_p3;
      const bool to_done = exh && (st2m || (st1m && !a.use_p3));
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
          i = x - 1;
          call_mem_n = 0;
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

    // ---------- P_BWD: all pn entries of row i ----------
    const int pn = cur_is_a ? an : bn;
    const C *rd = cur_is_a ? stkA : stkB;
    C *wr = cur_is_a ? stkB : stkA;
    const int qi = q[clampi(i, 0, L - 1)];
    const int c = (i >= 0 && qi < 4) ? qi : -1;  // -1: every entry is kept
    int npush = 0;
    bool keep0 = pn > 0;
    if (c >= 0) {
      bool have_prev = false;  // an unkept entry earlier in the row
      C prev_ob2 = 0;          // its size
      for (int base = 0; base < pn; base += E) {
        const int j = base + grp;
        const bool valid = j < pn;
        C p0 = 0, p1 = 0, p2 = 0, p3 = 0;
        if (valid) {
          const C *pr = rd + clampi(rev_read ? pn - 1 - j : j, 0, cap - 1) * 4;
          p0 = pr[0]; p1 = pr[1]; p2 = pr[2]; p3 = pr[3];
        }
        C nb, sz, above;
        extend_c<C, NW>(a, L2, valid ? p0 - 1 : (C)-1,
                        valid ? p0 - 1 + p2 : (C)-1, gl, c, nb, sz, above);
        const C span = (p0 <= a.primary && p0 + p2 - 1 >= a.primary) ? 1 : 0;
        const C ob0 = nb, ob1 = p1 + span + above, ob2 = sz;
        const bool keep = ob2 < minv;
        if (base == 0) keep0 = __ballot_sync(FULL, valid && keep) & 1u;
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
    }
    if (npush > cap) ovf = true;
    // the row's first entry, if kept, ends an SMEM
    if (keep0 && (call_mem_n == 0 || i + 1 < call_last_start)) {
      const C *pr = rd + clampi(rev_read ? pn - 1 : 0, 0, cap - 1) * 4;
      const C p0 = pr[0], p1 = pr[1], p2 = pr[2];
      const int p3 = (int)pr[3];
      if (p3 - (i + 1) >= a.min_seed_len)
        push_seed(p0, p1, p2, i + 1, p3,
                  refill ? rid : (st1m ? cur_tag : 0));
      call_last_start = i + 1;
      ++call_mem_n;
    }
    steps += pn > 0 ? pn : 1;
    if (npush == 0 || i < 0) {  // the call is over
      if (stage == S_P1) job = ret;
      phase = P_NEXT;
    } else {
      cur_is_a = !cur_is_a;
      rev_read = false;
      if (cur_is_a) {
        an = npush;
        bn = 0;
      } else {
        bn = npush;
        an = 0;
      }
      --i;
    }
    __syncwarp();
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

template <typename C, int NW>
int launch(const SeedArgs<C> &a, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * 2 * a.cap * 4 * sizeof(C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seed_machine_kernel<C, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)e;
    }
  }
  seed_machine_kernel<C, NW><<<(a.B + WARPS - 1) / WARPS, WARPS * 32, smem,
                               stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename C>
int launch_nw(const SeedArgs<C> &a, int nw, cudaStream_t stream) {
  if (a.B == 0) return 0;
  if (a.cap < 1 || a.cap_s < 1) return (int)cudaErrorInvalidValue;
  switch (nw) {
    case 8: return launch<C, 8>(a, stream);
    case 32: return launch<C, 32>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// What bounds it: as K1, the chain of dependent occ4 pairs, L of them; the
// bytes (the codes once, the occtab once) and the operations are far
// below.  Design: a group of G = 2R threads a read (E = 32 / G reads a
// warp), each step one cooperative extend_c, K1's; every read of the
// launch takes exactly L steps, so the warp never diverges and a step
// with nothing to extend looks up k = -1 (row 0, in cache).  No stack,
// no tail.
template <typename C, int NW>
__global__ void __launch_bounds__(WARPS * 32)
    probe_breaks_kernel(SeedArgs<C> a, int32_t *breaks) {
  constexpr int G = 2 * NW / WPT;
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int b = (blockIdx.x * WARPS * 32 + threadIdx.x) / G;
  const bool live = b < a.B;  // dead groups step on row 0, for the shuffles
  const uint8_t *q = a.q + (size_t)(live ? b : 0) * a.L;
  C L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)a.L2[c];
  C x0 = 1, x1 = 1, x2 = 0;
  bool started = false;
  int brk = 0;
  for (int x = 0; x < a.L; ++x) {
    const int c = q[x];
    const bool good = c < 4, ext = started && good;
    C nb, sz, above;
    extend_c<C, NW>(a, L2, ext ? x1 - 1 : (C)-1, ext ? x1 - 1 + x2 : (C)-1,
                    gl, clampi(3 - c, 0, 3), nb, sz, above);
    const C span = (x1 <= a.primary && x1 + x2 - 1 >= a.primary) ? 1 : 0;
    if (ext && sz >= 1) {
      x0 = x0 + span + above;
      x1 = nb;
      x2 = sz;
    } else if (good) {
      if (ext) ++brk;
      x0 = pick(L2, c) + 1;
      x1 = pick(L2, 3 - c) + 1;
      x2 = pick(L2, c + 1) - pick(L2, c);
    }
    started = good;
  }
  if (live && gl == 0) breaks[b] = brk;
}

template <typename C, int NW>
int launch_probe(const SeedArgs<C> &a, int32_t *breaks, cudaStream_t stream) {
  constexpr int G = 2 * NW / WPT;
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

}  // namespace

extern "C" int bwa_seed_machine(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int n_queue,
    int L, const int32_t *qlen, const int32_t *nv, const int32_t *job_lo,
    const int32_t *hi1, const int32_t *hi3, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_intv3, int cap, int cap_s, int use_p3,
    int tagged, int cap_r, void *seeds, int32_t *seed_n, uint8_t *ovf,
    int32_t *done_step, int32_t *steps, uint8_t *qmask, int32_t *qctr,
    void *stream) {
  if (qctr == nullptr && n_queue != B) return (int)cudaErrorInvalidValue;
  if (qctr != nullptr && !tagged) return (int)cudaErrorInvalidValue;
  if (coord64) {
    SeedArgs<int64_t> a{occtab, L2, primary, seq_len, q, B, n_queue, L,
                        qlen, nv, job_lo, hi1, hi3, min_seed_len, split_len,
                        split_width, max_intv3, cap, cap_s, use_p3, tagged,
                        cap_r, (int64_t *)seeds, seed_n, done_step, steps,
                        ovf, qmask, qctr};
    return launch_nw(a, nw, (cudaStream_t)stream);
  }
  SeedArgs<int32_t> a{occtab, L2, (int32_t)primary, (int32_t)seq_len, q, B,
                      n_queue, L, qlen, nv, job_lo, hi1, hi3, min_seed_len,
                      split_len, split_width, max_intv3, cap, cap_s, use_p3,
                      tagged, cap_r, (int32_t *)seeds, seed_n, done_step,
                      steps, ovf, qmask, qctr};
  return launch_nw(a, nw, (cudaStream_t)stream);
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
