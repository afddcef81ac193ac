// Kernels K9, K10a, K10b and K11: the JAX package's cross-check programs,
// a second implementation of seeding beside K1 (csrc/seed_machine.cu).
//
//  K9   sa_batch: bwt_sa (bwt.c:86-96), replacing bwa_tpu/ops/fm.py:201
//       sa_batch (an XLA while_loop): a thread a row walks inverse Psi
//       (the BWT base at the row and its count, from ckpt and the text
//       words) until the row is a multiple of 32, then adds the sampled
//       position.  Bound: the walk's dependent loads, a step each.
//  K10a smem1a: bwt_smem1a (bwt.c:289-351) one read a lane, replacing
//       bwa_tpu/ops/fm.py:319 _smem1a_core (smem1a_batch :478); the mems
//       in the reference's pre-reversal order, each list overwriting its
//       last slot once it outgrows cap, as fm.py:306 _push does.
//  K10b strategy1: bwt_seed_strategy1 (bwt.c:358-379), replacing
//       bwa_tpu/ops/fm.py:481 _seed_strategy1_core (seed_strategy1_batch
//       :529).
//  K11  collect_intv: mem_collect_intv's three passes (bwamem.c:140-188)
//       for each read on K10's device functions, then a stable sort by
//       (start, end), replacing bwa_tpu/ops/fm.py:589 collect_intv_device
//       (with :540 _append_filtered and :572 _skip_amb).  It shares the
//       occ lookup with K1 (fm_occ.cuh) and nothing else: it is K1's
//       cross-check.
// Their plain versions are the functions of bwa_tpu_torch/ops/fm.py named
// *_plain; outputs are equal bit for bit.
//
// What bounds K10 and K11 on an H100: each read's chain of dependent
// interval extensions (two occ4 lookups in the occtab, which stays in L2
// for the genomes chip_smoke.py runs), as K1.  Design, simple first:
//  1. A warp a read.  A forward step is one lookup by the whole warp (its
//     groups of G = 2R threads look up the same interval); a backward row
//     extends its entries 32 / G at a time, one a group, and then takes the
//     order-dependent rules (emit while the new list is empty, push a size
//     other than the last, the bwt_smem1a ik that an emit rewrites) entry
//     by entry in the row's order, uniform across the warp, the values
//     fetched by shuffles.
//  2. The curr and prev lists (cap rows of four coordinates each; K11's
//     mem list of cap rows of five besides) live in shared memory, four
//     warps a block, fewer when they pass a block's 227 KB; past one
//     warp's, in a global scratch for a few warps an SM, each warp taking
//     reads in turn (the wrapper plans which: ops/fm.py::_lists_plan).
//  3. K11 appends its seeds to a zeroed store in global memory, then sorts
//     each read's cap_s rows by rank (a lane a row, counting the keys
//     below it), stable as the plain version's sort.
//  4. K10b needs no list: a warp a read, one lookup a step.
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (bwa_tpu_torch/ops/cuda_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_occ.cuh"

namespace {

template <typename C>
struct SmemArgs {
  const uint32_t *occtab;  // [n_rows, 4 + nw] counts || text words
  C primary, seq_len;
  const int64_t *L2;       // [5]
  const uint8_t *q;        // [B, L] read codes (>= 4 past qlen)
  int B, L;
  const int32_t *qlen;
  // K10a, K10b: one call a read
  const int32_t *x;
  const C *min_intv;
  C max_intv;
  const uint8_t *active;
  int cap, min_len;
  int32_t *ret, *ms, *me, *mem_n;
  C *m0, *m1, *m2;
  uint8_t *found;
  C *r0, *r1, *r2;
  // K11
  int min_seed_len, split_len, cap_s, key64;
  C split_width, max_mem_intv;
  C *raw;                  // [B, cap_s, 5] zeroed seed store
  C *s0, *s1, *s2;
  int32_t *ss, *se, *seed_n;
  // the lists: shared memory, or scratch + per_warp bytes a warp
  unsigned char *scratch;
  size_t per_warp;
  unsigned long long *work;  // intervals extended, or null
};

// bwt_set_intv for a base c in [0, 4)
template <typename C>
__device__ __forceinline__ void set_intv(const C L2[5], int c, C &k0, C &k1,
                                         C &k2) {
  k0 = pick(L2, c) + 1;
  k1 = pick(L2, 3 - c) + 1;
  k2 = pick(L2, c + 1) - pick(L2, c);
}

// the forward extension of (k0, k1, k2) by base qi (the backward extension
// of the reverse complement by 3 - qi: bwt_extend, is_back = 0)
template <typename C, int NW>
__device__ __forceinline__ void extend_fwd(const SmemArgs<C> &a,
                                           const C L2[5], C k0, C k1, C k2,
                                           int qi, int gl, C &o0, C &o1,
                                           C &o2) {
  C nb, sz, above;
  extend_c<C, NW>(a, L2, k1 - 1, k1 - 1 + k2, gl, 3 - qi, nb, sz, above);
  const C span = (k1 <= a.primary && k1 + k2 - 1 >= a.primary) ? 1 : 0;
  o0 = k0 + span + above;
  o1 = nb;
  o2 = sz;
}

// A mem list: K10a's output rows of read b, or K11's list in its lists
template <typename C>
struct MemOut {
  C *m0, *m1, *m2;
  int32_t *ms, *me;
  __device__ void put(int slot, C v0, C v1, C v2, int s, int e) const {
    m0[slot] = v0; m1[slot] = v1; m2[slot] = v2; ms[slot] = s; me[slot] = e;
  }
};

template <typename C>
struct MemList {
  C *m;  // [cap][5]
  __device__ void put(int slot, C v0, C v1, C v2, int s, int e) const {
    C *r = m + (size_t)slot * 5;
    r[0] = v0; r[1] = v1; r[2] = v2; r[3] = (C)s; r[4] = (C)e;
  }
};

// bwt_smem1a from x for the warp's read (q its codes, qlen its length):
// the mems into `out` (lane 0 writes them; mem_n their count, which may
// pass cap: the last slot is overwritten), la and lb the two [cap][4]
// lists.  Returns ret; ends with the warp converged (its writes seen).
template <typename C, int NW, typename Out>
__device__ int smem1a_warp(const SmemArgs<C> &a, const C L2[5],
                           const uint8_t *q, int qlen, int x, C min_intv,
                           C max_intv, bool active, int cap, C *la, C *lb,
                           const Out &out, int &mem_n,
                           unsigned long long &work) {
  constexpr int G = 2 * NW / WPT, E = 32 / G;
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), grp = lane / G;
  const int L = a.L;
  const int qx = q[clampi(x, 0, L - 1)];
  mem_n = 0;
  if (!(active && qx < 4 && x < qlen)) return x + 1;
  const C minv = min_intv > 1 ? min_intv : 1;
  C ik0, ik1, ik2;
  set_intv(L2, qx, ik0, ik1, ik2);
  int info_end = x + 1, cn = 0, i = x + 1;
  bool done = false;
  auto push4 = [&](C *list, int n, C v0, C v1, C v2, C v3) {
    if (lane < 4)
      list[(n < cap - 1 ? n : cap - 1) * 4 + lane] =
          lane == 0 ? v0 : lane == 1 ? v1 : lane == 2 ? v2 : v3;
  };

  // ---- forward pass ----
  while (!done && i < qlen) {
    const int qi = q[clampi(i, 0, L - 1)];
    const bool small = ik2 < max_intv;
    const bool amb = !small && qi >= 4, ext = !small && !amb;
    C o0 = 0, o1 = 0, o2 = 0;
    if (ext) {
      extend_fwd<C, NW>(a, L2, ik0, ik1, ik2, qi, gl, o0, o1, o2);
      ++work;
    }
    const bool changed = ext && o2 != ik2;
    if (small || amb || changed) push4(la, cn++, ik0, ik1, ik2, info_end);
    done = small || amb || (changed && o2 < minv);
    if (ext && !done) {
      ik0 = o0; ik1 = o1; ik2 = o2;
      info_end = i + 1;
      ++i;
    }
  }
  if (!done) push4(la, cn++, ik0, ik1, ik2, info_end);  // ran off the end
  __syncwarp();
  const int ret = (int)la[clampi(cn - 1, 0, cap - 1) * 4 + 3];

  // ---- backward pass: the first row reads the forward list reversed ----
  C ik_x2 = ik2;  // the reference reuses ik: an emit rewrites it
  int m_last = 0;  // the start of the last mem emitted
  const C *prev = la;
  C *cur = lb;
  int pn = cn;
  bool first = true;
  for (i = x - 1; i >= -1; --i) {
    const int qi = i >= 0 ? q[clampi(i, 0, L - 1)] : 4;
    const int c = (i >= 0 && qi < 4) ? qi : -1;  // -1: every entry kept
    int n0 = 0;
    C last_x2 = 0;
    for (int base = 0; base < pn; base += E) {
      const int je = base + grp;
      const bool valid = je < pn;
      const int jj = je < cap - 1 ? je : cap - 1;
      const C *pr = prev + (first ? clampi(cn - 1 - jj, 0, cap - 1) : jj) * 4;
      const C p0 = valid ? pr[0] : 0, p1 = valid ? pr[1] : 0,
              p2 = valid ? pr[2] : 0, p3 = valid ? pr[3] : 0;
      C o0 = 0, o1 = 0, o2 = 0;
      if (c >= 0) {  // the entries' backward extensions by c, one a group
        C nb, sz, above;
        extend_c<C, NW>(a, L2, valid ? p0 - 1 : (C)-1,
                        valid ? p0 - 1 + p2 : (C)-1, gl, c, nb, sz, above);
        const C span = (p0 <= a.primary && p0 + p2 - 1 >= a.primary) ? 1 : 0;
        o0 = nb;
        o1 = p1 + span + above;
        o2 = sz;
      }
      // the row's rules, entry by entry in its order
      const int nr = pn - base < E ? pn - base : E;
      if (c >= 0) work += nr;
      for (int t = 0; t < nr; ++t) {
        const int src = t * G;
        const C e0 = __shfl_sync(FULL, p0, src);
        const C e1 = __shfl_sync(FULL, p1, src);
        const C e2 = __shfl_sync(FULL, p2, src);
        const C e3 = __shfl_sync(FULL, p3, src);
        const C f0 = __shfl_sync(FULL, o0, src);
        const C f1 = __shfl_sync(FULL, o1, src);
        const C f2 = __shfl_sync(FULL, o2, src);
        if (c < 0 || ik_x2 < max_intv || f2 < minv) {  // keep the hit
          if (n0 == 0 && (mem_n == 0 || i + 1 < m_last)) {
            if (lane == 0)
              out.put(mem_n < cap - 1 ? mem_n : cap - 1, e0, e1, e2, i + 1,
                      (int)e3);
            ++mem_n;
            m_last = i + 1;
            ik_x2 = e2;
          }
        } else if (n0 == 0 || f2 != last_x2) {
          push4(cur, n0++, f0, f1, f2, e3);
          last_x2 = f2;
        }
      }
    }
    __syncwarp();
    if (n0 == 0) break;
    const C *t = prev;
    prev = cur;
    cur = const_cast<C *>(t);
    pn = n0;
    first = false;
  }
  __syncwarp();
  return ret;
}

// bwt_seed_strategy1 from x for the warp's read: ret, and whether it hit
// (found) with the interval r
template <typename C, int NW>
__device__ int strategy1_warp(const SmemArgs<C> &a, const C L2[5],
                              const uint8_t *q, int qlen, int x, int min_len,
                              C max_intv, bool active, bool &found, C &r0,
                              C &r1, C &r2, unsigned long long &work) {
  const int gl = threadIdx.x & (2 * NW / WPT - 1);
  const int qx = q[clampi(x, 0, a.L - 1)];
  found = false;
  r0 = r1 = r2 = 0;
  if (!(active && qx < 4 && x < qlen)) return x + 1;
  C ik0, ik1, ik2;
  set_intv(L2, qx, ik0, ik1, ik2);
  for (int i = x + 1; i < qlen; ++i) {
    const int qi = q[clampi(i, 0, a.L - 1)];
    if (qi >= 4) return i + 1;
    C o0, o1, o2;
    extend_fwd<C, NW>(a, L2, ik0, ik1, ik2, qi, gl, o0, o1, o2);
    ++work;
    if (o2 < max_intv && i - x >= min_len) {
      found = true;
      r0 = o0; r1 = o1; r2 = o2;
      return i + 1;
    }
    ik0 = o0; ik1 = o1; ik2 = o2;
  }
  return qlen;
}

// the warp's place: its lists and the first read it takes
template <typename C>
__device__ __forceinline__ unsigned char *warp_lists(const SmemArgs<C> &a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  if (a.scratch)
    return a.scratch +
           ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * a.per_warp;
  return smem_raw + (size_t)warp * a.per_warp;
}

template <typename C>
__device__ __forceinline__ void load_l2(const SmemArgs<C> &a, C L2[5]) {
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)a.L2[c];
}

__device__ __forceinline__ void add_work(unsigned long long *work,
                                         unsigned long long n) {
  if (work && (threadIdx.x & 31) == 0) atomicAdd(work, n);
}

template <typename C, int NW>
__global__ void __launch_bounds__(128) smem1a_kernel(SmemArgs<C> a) {
  C L2[5];
  load_l2(a, L2);
  C *la = reinterpret_cast<C *>(warp_lists(a));
  C *lb = la + (size_t)a.cap * 4;
  const int lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  unsigned long long work = 0;
  for (int b = blockIdx.x * wpb + (threadIdx.x >> 5); b < a.B;
       b += gridDim.x * wpb) {
    const size_t row = (size_t)b * a.cap;
    const MemOut<C> out{a.m0 + row, a.m1 + row, a.m2 + row, a.ms + row,
                        a.me + row};
    int mem_n;
    const int ret = smem1a_warp<C, NW>(
        a, L2, a.q + (size_t)b * a.L, a.qlen[b], a.x[b], a.min_intv[b],
        a.max_intv, a.active[b] != 0, a.cap, la, lb, out, mem_n, work);
    if (lane == 0) {
      a.ret[b] = ret;
      a.mem_n[b] = mem_n;
    }
  }
  add_work(a.work, work);
}

template <typename C, int NW>
__global__ void __launch_bounds__(128) strategy1_kernel(SmemArgs<C> a) {
  C L2[5];
  load_l2(a, L2);
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= a.B) return;
  bool found;
  C r0, r1, r2;
  unsigned long long work = 0;
  const int ret = strategy1_warp<C, NW>(
      a, L2, a.q + (size_t)b * a.L, a.qlen[b], a.x[b], a.min_len,
      a.max_intv, a.active[b] != 0, found, r0, r1, r2, work);
  if ((threadIdx.x & 31) == 0) {
    a.ret[b] = ret;
    a.found[b] = found ? 1 : 0;
    a.r0[b] = r0; a.r1[b] = r1; a.r2[b] = r2;
  }
  add_work(a.work, work);
}

template <typename C, int NW>
__global__ void __launch_bounds__(128) collect_kernel(SmemArgs<C> a) {
  C L2[5];
  load_l2(a, L2);
  const int cap = a.cap, cap_s = a.cap_s;
  C *la = reinterpret_cast<C *>(warp_lists(a));
  C *lb = la + (size_t)cap * 4;
  const MemList<C> mems{lb + (size_t)cap * 4};
  const int lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  unsigned long long work = 0;
  for (int b = blockIdx.x * wpb + (threadIdx.x >> 5); b < a.B;
       b += gridDim.x * wpb) {
    const uint8_t *q = a.q + (size_t)b * a.L;
    const int qlen = a.qlen[b];
    C *raw = a.raw + (size_t)b * cap_s * 5;
    int seed_n = 0;
    auto append = [&](C v0, C v1, C v2, C v3, C v4) {
      const int slot = seed_n < cap_s - 1 ? seed_n : cap_s - 1;
      if (lane < 5)
        raw[(size_t)slot * 5 + lane] = lane == 0 ? v0 : lane == 1 ? v1
                                     : lane == 2 ? v2 : lane == 3 ? v3 : v4;
      ++seed_n;
      __syncwarp();
    };
    // a call's mems of min_seed_len bases or more, oldest first
    auto append_filtered = [&](int mem_n) {
      for (int j = 0; j < mem_n; ++j) {
        const C *r = mems.m + (size_t)clampi(mem_n - 1 - j, 0, cap - 1) * 5;
        if (r[4] - r[3] >= a.min_seed_len) append(r[0], r[1], r[2], r[3], r[4]);
      }
    };
    auto skip_amb = [&](int x) {
      while (x < qlen && q[clampi(x, 0, a.L - 1)] >= 4) ++x;
      return x;
    };
    // ---- pass 1: SMEMs, the cursor advanced by each call's ret ----
    for (int x = skip_amb(0); x < qlen;) {
      int mem_n;
      x = smem1a_warp<C, NW>(a, L2, q, qlen, x, 1, 0, true, cap, la, lb,
                             mems, mem_n, work);
      append_filtered(mem_n);
      x = skip_amb(x);
    }
    // ---- pass 2: re-seed long low-occurrence SMEMs from their midpoints
    const int old_n = seed_n;
    for (int k = 0; k < old_n; ++k) {
      const C *r = raw + (size_t)(k < cap_s - 1 ? k : cap_s - 1) * 5;
      const C x2 = r[2];
      const int start = (int)r[3], end = (int)r[4];
      if (end - start < a.split_len || x2 > a.split_width) continue;
      int mem_n;
      smem1a_warp<C, NW>(a, L2, q, qlen, (start + end) >> 1, x2 + 1, 0, true,
                         cap, la, lb, mems, mem_n, work);
      append_filtered(mem_n);
    }
    // ---- pass 3: LAST-like seeding (no hit is possible without a
    // positive max_mem_intv) ----
    if (a.max_mem_intv > 0) {
      for (int x = skip_amb(0); x < qlen;) {
        bool found;
        C r0, r1, r2;
        const int ret = strategy1_warp<C, NW>(
            a, L2, q, qlen, x, a.min_seed_len, a.max_mem_intv, true, found,
            r0, r1, r2, work);
        if (found && r2 > 0) append(r0, r1, r2, (C)x, (C)ret);
        x = skip_amb(ret);
      }
    }
    // ---- stable sort by (start, end): each row to its rank ----
    const int shift = a.key64 ? 32 : 16;
    auto key = [&](int t) -> int64_t {
      if (t >= seed_n) return (int64_t)0x7fffffffffffffffLL;  // a pad
      const C *r = raw + (size_t)t * 5;
      return ((int64_t)r[3] << shift) | (int64_t)r[4];
    };
    const size_t out = (size_t)b * cap_s;
    for (int t = lane; t < cap_s; t += 32) {
      const int64_t kt = key(t);
      int rank = 0;
      for (int u = 0; u < cap_s; ++u) {
        const int64_t ku = key(u);
        rank += ku < kt || (ku == kt && u < t);
      }
      const C *r = raw + (size_t)t * 5;
      a.s0[out + rank] = r[0];
      a.s1[out + rank] = r[1];
      a.s2[out + rank] = r[2];
      a.ss[out + rank] = (int32_t)r[3];
      a.se[out + rank] = (int32_t)r[4];
    }
    if (lane == 0) a.seed_n[b] = seed_n;
    __syncwarp();
  }
  add_work(a.work, work);
}

// K9: bwt_sa a thread a row
template <typename C>
__global__ void __launch_bounds__(128)
    sa_kernel(const C *ckpt, const uint32_t *words, const C *ssa,
              const int64_t *L2p, C primary, C seq_len, const C *k_in,
              C *out, int N, unsigned long long *work) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  C L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)L2p[c];
  unsigned steps = 0;
  if (t < N) {
    C k = k_in[t];
    while ((k & 31) != 0) {
      // the BWT base at the $-removed row
      const C x = k - (k > primary ? 1 : 0);
      const uint32_t wx = words[(size_t)(x >> 7) * 8 + ((x >> 4) & 7)];
      const int c = (int)(wx >> ((15 - (int)(x & 15)) << 1)) & 3;
      // its count in B[0..k] (bwt_occ)
      C kk = k - (k >= primary ? 1 : 0);
      kk = kk < 0 ? 0 : (kk > seq_len - 1 ? seq_len - 1 : kk);
      const uint32_t *w = words + (size_t)(kk >> 7) * 8;
      const int kw = (int)(kk >> 4) & 7, kb = (int)(kk & 15);
      int n = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int nkeep = clampi((kw - u) * 16 + kb + 1, 0, 16);
        const uint32_t mask = nkeep > 0 ? FULL << ((16 - nkeep) << 1) : 0u;
        const uint32_t word = w[u] & mask, m55 = mask & M55;
        const uint32_t hi = (word >> 1) & M55, lo = word & M55;
        n += __popc(((c & 2) ? hi : ~hi & m55) & ((c & 1) ? lo : ~lo & m55));
      }
      C occ = ckpt[(size_t)(kk >> 7) * 4 + c] + n;
      if (k == seq_len) occ = pick(L2, c + 1) - pick(L2, c);
      k = k == primary ? 0 : pick(L2, c) + occ;
      ++steps;
    }
    out[t] = (C)steps + ssa[k >> 5];
  }
  if (work) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      steps += __shfl_xor_sync(FULL, steps, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(work, (unsigned long long)steps);
  }
}

// a kernel with its lists: `warps` a block, `blocks`, `smem` shared bytes
template <typename C>
int launch_with(void (*kern)(SmemArgs<C>), const SmemArgs<C> &a, int warps,
                int blocks, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)e;
    }
  }
  kern<<<blocks, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename C>
void fill_common(SmemArgs<C> &a, const uint32_t *occtab, const int64_t *L2,
                 int64_t primary, int64_t seq_len, const uint8_t *q, int B,
                 int L, const int32_t *qlen, void *work) {
  a.occtab = occtab; a.L2 = L2; a.primary = (C)primary;
  a.seq_len = (C)seq_len; a.q = q; a.B = B; a.L = L; a.qlen = qlen;
  a.work = static_cast<unsigned long long *>(work);
}

template <typename C>
int smem1a_launch(SmemArgs<C> &a, int nw, int warps, int blocks, size_t smem,
                  cudaStream_t stream) {
  switch (nw) {
    case 8: return launch_with(smem1a_kernel<C, 8>, a, warps, blocks, smem,
                               stream);
    case 32: return launch_with(smem1a_kernel<C, 32>, a, warps, blocks, smem,
                                stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename C>
int collect_launch(SmemArgs<C> &a, int nw, int warps, int blocks,
                   size_t smem, cudaStream_t stream) {
  switch (nw) {
    case 8: return launch_with(collect_kernel<C, 8>, a, warps, blocks, smem,
                               stream);
    case 32: return launch_with(collect_kernel<C, 32>, a, warps, blocks,
                                smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename C>
int strategy1_launch(SmemArgs<C> &a, int nw, cudaStream_t stream) {
  const int blocks = (a.B + 3) / 4;
  switch (nw) {
    case 8: return launch_with(strategy1_kernel<C, 8>, a, 4, blocks, 0,
                               stream);
    case 32: return launch_with(strategy1_kernel<C, 32>, a, 4, blocks, 0,
                                stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K9: out[t] = bwt_sa(k[t]) for N rows (coordinates int64 when coord64)
extern "C" int bwa_sa_batch(int coord64, const void *ckpt,
                            const uint32_t *words, const void *ssa,
                            const int64_t *L2, int64_t primary,
                            int64_t seq_len, const void *k, void *out, int N,
                            void *work, void *stream) {
  if (N == 0) return 0;
  const int blocks = (N + 127) / 128;
  auto *wk = static_cast<unsigned long long *>(work);
  if (coord64)
    sa_kernel<int64_t><<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (const int64_t *)ckpt, words, (const int64_t *)ssa, L2, primary,
        seq_len, (const int64_t *)k, (int64_t *)out, N, wk);
  else
    sa_kernel<int32_t><<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t *)ckpt, words, (const int32_t *)ssa, L2,
        (int32_t)primary, (int32_t)seq_len, (const int32_t *)k,
        (int32_t *)out, N, wk);
  return (int)cudaGetLastError();
}

// K10a: bwt_smem1a of each of the B reads from x; the lists on `warps`
// warps a block over `blocks` blocks, in `smem` shared bytes a block or,
// with scratch, per_warp bytes a warp of it
extern "C" int bwa_smem1a(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *x, const void *min_intv,
    int64_t max_intv, const uint8_t *active, int cap, int32_t *ret, void *m0,
    void *m1, void *m2, int32_t *ms, int32_t *me, int32_t *mem_n, int warps,
    int blocks, int64_t smem, void *scratch, int64_t per_warp, void *work,
    void *stream) {
  if (B == 0) return 0;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (coord64) {
    SmemArgs<int64_t> a{};
    fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, work);
    a.x = x; a.min_intv = (const int64_t *)min_intv; a.max_intv = max_intv;
    a.active = active; a.cap = cap; a.ret = ret; a.m0 = (int64_t *)m0;
    a.m1 = (int64_t *)m1; a.m2 = (int64_t *)m2; a.ms = ms; a.me = me;
    a.mem_n = mem_n; a.scratch = (unsigned char *)scratch;
    a.per_warp = (size_t)per_warp;
    return smem1a_launch(a, nw, warps, blocks, (size_t)smem,
                         (cudaStream_t)stream);
  }
  SmemArgs<int32_t> a{};
  fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, work);
  a.x = x; a.min_intv = (const int32_t *)min_intv;
  a.max_intv = (int32_t)max_intv; a.active = active; a.cap = cap;
  a.ret = ret; a.m0 = (int32_t *)m0; a.m1 = (int32_t *)m1;
  a.m2 = (int32_t *)m2; a.ms = ms; a.me = me; a.mem_n = mem_n;
  a.scratch = (unsigned char *)scratch; a.per_warp = (size_t)per_warp;
  return smem1a_launch(a, nw, warps, blocks, (size_t)smem,
                       (cudaStream_t)stream);
}

// K10b: bwt_seed_strategy1 of each of the B reads from x
extern "C" int bwa_strategy1(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *x, int min_len, int64_t max_intv,
    const uint8_t *active, int32_t *ret, uint8_t *found, void *r0, void *r1,
    void *r2, void *work, void *stream) {
  if (B == 0) return 0;
  if (coord64) {
    SmemArgs<int64_t> a{};
    fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, work);
    a.x = x; a.min_len = min_len; a.max_intv = max_intv; a.active = active;
    a.ret = ret; a.found = found; a.r0 = (int64_t *)r0;
    a.r1 = (int64_t *)r1; a.r2 = (int64_t *)r2;
    return strategy1_launch(a, nw, (cudaStream_t)stream);
  }
  SmemArgs<int32_t> a{};
  fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, work);
  a.x = x; a.min_len = min_len; a.max_intv = (int32_t)max_intv;
  a.active = active; a.ret = ret; a.found = found; a.r0 = (int32_t *)r0;
  a.r1 = (int32_t *)r1; a.r2 = (int32_t *)r2;
  return strategy1_launch(a, nw, (cudaStream_t)stream);
}

// K11: mem_collect_intv's three passes for each of the B reads, seeds
// appended to raw (zeroed [B, cap_s, 5]) and sorted into s0..se; the lists
// planned as K10a's
extern "C" int bwa_collect_intv(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_mem_intv, int cap, int cap_s, int key64,
    void *raw, void *s0, void *s1, void *s2, int32_t *ss, int32_t *se,
    int32_t *seed_n, int warps, int blocks, int64_t smem, void *scratch,
    int64_t per_warp, void *work, void *stream) {
  if (B == 0) return 0;
  if (cap < 1 || cap_s < 1) return (int)cudaErrorInvalidValue;
  if (coord64) {
    SmemArgs<int64_t> a{};
    fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, work);
    a.min_seed_len = min_seed_len; a.split_len = split_len;
    a.split_width = split_width; a.max_mem_intv = max_mem_intv;
    a.cap = cap; a.cap_s = cap_s; a.key64 = key64;
    a.raw = (int64_t *)raw; a.s0 = (int64_t *)s0; a.s1 = (int64_t *)s1;
    a.s2 = (int64_t *)s2; a.ss = ss; a.se = se; a.seed_n = seed_n;
    a.scratch = (unsigned char *)scratch; a.per_warp = (size_t)per_warp;
    return collect_launch(a, nw, warps, blocks, (size_t)smem,
                          (cudaStream_t)stream);
  }
  SmemArgs<int32_t> a{};
  fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, work);
  a.min_seed_len = min_seed_len; a.split_len = split_len;
  a.split_width = (int32_t)split_width;
  a.max_mem_intv = (int32_t)max_mem_intv; a.cap = cap; a.cap_s = cap_s;
  a.key64 = key64; a.raw = (int32_t *)raw; a.s0 = (int32_t *)s0;
  a.s1 = (int32_t *)s1; a.s2 = (int32_t *)s2; a.ss = ss; a.se = se;
  a.seed_n = seed_n; a.scratch = (unsigned char *)scratch;
  a.per_warp = (size_t)per_warp;
  return collect_launch(a, nw, warps, blocks, (size_t)smem,
                        (cudaStream_t)stream);
}
