// Kernels K9, K10a, K10b and K11: the JAX package's cross-check programs,
// a second implementation of seeding beside K1 (csrc/seed_machine.cu).
//
//  K9   sa_batch: bwt_sa (bwt.c:86-96), replacing bwa_tpu/ops/fm.py:201
//       sa_batch (an XLA while_loop): a thread a row walks inverse Psi
//       (the BWT base at the row and its count, from ckpt and the text
//       words) until the row is a multiple of 32, then adds the sampled
//       position.  Bound: every row is resident at once, so the launch
//       takes its longest walk's chain of dependent steps (439 on step
//       4f's 65,536 rows).  A step is one memory round trip: the base and
//       its count lie in one 128-base block (the row's $-removed position
//       serves both; at the $ row the count is not used), so the block's
//       eight text words (two 16-byte loads) and four counts (one, two at
//       int64) are issued together and the base is taken from the words
//       already loaded.  Loading the base's word first costs less than a
//       second round trip: the block's loads after it, of the same 32-byte
//       sector, mostly hit L1.  What is left is a step's L2 latency and
//       the count after it (PERF.md).
//       One row a thread: more would lengthen the chain.  `work` gets the
//       steps and the longest walk.
//       Its occtab form (sa_occ_kernel) also replaces the host's walk
//       (native/bsw2.cpp fm_sa_batch: one dependent DRAM miss a step, one
//       walk after another) on the main path, on an index too large for
//       ckpt and words to be uploaded (index/fmindex.py, light): it reads
//       each step's base and count from K1's fused occtab, [n_rows, 4 +
//       NW] uint32 (NW = 8R; R = 4 at chr1 scale: 512 bases a row), so no
//       second copy of the BWT goes onto the card.  Bound: latency, as
//       above; a bucket's ~88K rows are resident in one wave, and the
//       launch takes the longest walk (~32 ln N steps, ~365) times one HBM
//       round trip.  Design: a step is one round trip, the row's counts
//       and its text words up to the row's word issued together as
//       16-byte loads (predicated: words past the row's word are not
//       read: 88 of a row's 144 bytes on average); the base is taken from
//       the loaded words and its count is one xor and popcount a word;
//       only k and the step count live across steps.
//  K10a smem1a: bwt_smem1a (bwt.c:289-351) one read a lane, replacing
//       bwa_tpu/ops/fm.py:319 _smem1a_core (smem1a_batch :478); the mems
//       in the reference's pre-reversal order, each list overwriting its
//       last slot once it outgrows cap, as fm.py:306 _push does.
//  K10b strategy1: bwt_seed_strategy1 (bwt.c:358-379), replacing
//       bwa_tpu/ops/fm.py:481 _seed_strategy1_core (seed_strategy1_batch
//       :529).
//  K11  collect_intv: mem_collect_intv's three passes (bwamem.c:140-188)
//       for each read on K10's device routines, then a stable sort by
//       (start, end), replacing bwa_tpu/ops/fm.py:589 collect_intv_device
//       (with :540 _append_filtered and :572 _skip_amb).  It shares the
//       group lookup with K1's refill mode and K8 (fm_occ.cuh) and nothing
//       else: it is K1's cross-check.
// Their plain versions are the functions of bwa_tpu_torch/ops/fm.py named
// *_plain; outputs are equal bit for bit.
//
// What bounds K10 and K11 on an H100: each read's chain of dependent
// interval extensions (a group lookup in the occtab, which stays in L2 for
// the genomes chip_smoke.py runs), as K1, and the instructions each link
// costs: the reads of one warp share its instruction stream, so their
// steps cost the union of the code paths they take.  Design:
//  1. A team of T groups of G = 2R threads a read (warp_run), the form:
//     "group", T = 1, 32 / G reads a warp (K10b; K10a where no read
//     starts past 0: its reads then step in lockstep); "warp", T = 32 / G,
//     a read a warp (K11, and K10a elsewhere: reads whose backward rows
//     diverge would cost a shared warp the union of their code paths each
//     step; the wrapper picks, ops/fm.py::smem1a_form).  A forward step is
//     one group lookup (glookup: a 16-byte word load a thread, the row
//     read once when both ends share it) by the team's first group, the
//     others loading nothing; the warp's lookups are one call, and a read
//     whose call is over passes k = -1 and loads nothing.  Every thread
//     stays in the loop until its warp is done.
//  2. Between two rounds a team takes its read through every step that
//     needs no lookup (walk_prepare): a forward pass that ends on an N, a
//     small interval or the read's end, a row of an N or the read's start
//     (every entry kept, only the first may emit), an entry kept because
//     ik's size is below max_intv, a row's end; in K11, the next call or
//     pass.
//  3. A backward row is taken T entries a round, one a group, each
//     extended by the row's base, the order-dependent rules resolved by
//     ballots over the round's entries as K1's item 3 (with T = 1 they are
//     the rule of one entry): an entry is pushed if it is not kept and no
//     earlier entry of the round is unkept (then if the target list is
//     empty or its size differs from the last push's) or its size differs
//     from the nearest earlier unkept entry's; the push of rank r writes
//     slot min(r, cap - 1), the last such push winning; only the row's
//     first entry can emit, and its emit rewrites the ik size that keeps
//     the later entries (bwt_smem1a reuses ik).
//  4. The lists of a read (curr and prev, cap rows of four coordinates;
//     K11's mem list of cap rows of five besides) live in shared memory,
//     per_read bytes a read; the wrapper picks warps a block from B and
//     the blocks resident an SM (ops/fm.py::_smem_plan).  Past a block's
//     227 KB for one warp's reads, the lists are in a global scratch and
//     each warp takes its reads in turn.  A team writes a row with every
//     thread writing every column, so that its threads read back their
//     own writes; other threads' writes are seen after the warp's
//     __syncwarp at the end of each round.
//  5. K11 appends its seeds to a zeroed store in global memory, then sorts
//     each read's cap_s rows by rank (a lane a row, the warp on one read
//     at a time, counting the keys below it), stable as the plain
//     version's sort.
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (bwa_tpu_torch/ops/cuda_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm_occ.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // 8 warps a block at most
// the warp form's registers, at most 65536 / (MAX_THREADS * this) a thread
// (85), so that 24 of its one-read warps fit an SM (at 64 registers, 32 fit
// but K10a's spills cost more than they gain: PERF.md section 6)
constexpr int WARP_FORM_BLOCKS = 3;

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
  // the lists: shared memory, or scratch; per_read bytes a read
  unsigned char *scratch;
  size_t per_read;
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

// K10b's calls have no list
struct NoOut {
  template <typename C>
  __device__ void put(int, C, C, C, int, int) const {}
};

// a list row (four coordinates) at slot min(n, cap - 1)
template <typename C>
__device__ __forceinline__ void put4(C *list, int n, int cap, C v0, C v1,
                                     C v2, C v3) {
  C *r = list + (size_t)(n < cap - 1 ? n : cap - 1) * 4;
  r[0] = v0; r[1] = v1; r[2] = v2; r[3] = v3;
}

constexpr int W_FWD = 0, W_BWD = 1, W_END = 2;

// One read's call of bwt_smem1a (or, with s1, bwt_seed_strategy1), the
// state its group holds (the same in each of its threads).  The forward
// list is la; a backward row reads prev (la, reversed, on the first row)
// and fills cur, the two swapping each row (on_b: prev is lb).
template <typename C>
struct Walk {
  int phase, x, i, ret, info_end, cn;
  int pn, j, n0, mem_n, m_last, c, min_len;
  bool s1, first, on_b, found;
  C minv, max_intv, ik0, ik1, ik2, last_x2, ik_x2, r0, r1, r2;
};

__device__ __forceinline__ int code_at(const uint8_t *q, int L, int i) {
  return q[clampi(i, 0, L - 1)];
}

// bwt_smem1a from x (ret = x + 1 and no mem where it cannot start)
template <typename C>
__device__ void walk_smem1a(Walk<C> &w, const uint8_t *q, int L, int qlen,
                            const C L2[5], int x, C min_intv, C max_intv,
                            bool active) {
  w.s1 = false;
  w.x = x;
  w.mem_n = 0;
  w.ret = x + 1;
  w.phase = W_END;
  const int qx = L > 0 ? code_at(q, L, x) : 4;
  if (!(active && qx < 4 && x < qlen)) return;
  w.minv = min_intv > 1 ? min_intv : 1;
  w.max_intv = max_intv;
  set_intv(L2, qx, w.ik0, w.ik1, w.ik2);
  w.info_end = x + 1;
  w.cn = 0;
  w.i = x + 1;
  w.phase = W_FWD;
}

// bwt_seed_strategy1 from x
template <typename C>
__device__ void walk_strategy1(Walk<C> &w, const uint8_t *q, int L, int qlen,
                               const C L2[5], int x, int min_len, C max_intv,
                               bool active) {
  w.s1 = true;
  w.x = x;
  w.found = false;
  w.r0 = w.r1 = w.r2 = 0;
  w.ret = x + 1;
  w.phase = W_END;
  const int qx = L > 0 ? code_at(q, L, x) : 4;
  if (!(active && qx < 4 && x < qlen)) return;
  w.min_len = min_len;
  w.max_intv = max_intv;
  set_intv(L2, qx, w.ik0, w.ik1, w.ik2);
  w.i = x + 1;
  w.phase = W_FWD;
}

// row i's base (-1: the read's start or an N, every entry kept)
template <typename C>
__device__ __forceinline__ void row_start(Walk<C> &w, const uint8_t *q,
                                          int L) {
  const int qi = w.i >= 0 ? code_at(q, L, w.i) : 4;
  w.c = qi < 4 ? qi : -1;
}

// the backward pass after the forward pass's last push
template <typename C>
__device__ __forceinline__ void bwd_start(Walk<C> &w, const uint8_t *q,
                                          int L) {
  w.phase = W_BWD;
  w.i = w.x - 1;
  w.first = true;
  w.on_b = false;
  w.pn = w.cn;
  w.j = w.n0 = 0;
  w.last_x2 = 0;
  w.ik_x2 = w.ik2;  // the reference reuses ik: an emit rewrites it
  w.m_last = 0;
  w.mem_n = 0;
  row_start(w, q, L);
}

// the list slot that entry j of the current row reads
template <typename C>
__device__ __forceinline__ int entry_slot(const Walk<C> &w, int j, int cap) {
  const int jj = j < cap - 1 ? j : cap - 1;
  return w.first ? clampi(w.cn - 1 - jj, 0, cap - 1) : jj;
}

// a kept entry p: an SMEM while the new list is empty and it is not
// contained in the last one
template <typename C, typename Out>
__device__ __forceinline__ void emit_rule(Walk<C> &w, const Out &out,
                                          int cap, const C p[4]) {
  if (w.n0 == 0 && (w.mem_n == 0 || w.i + 1 < w.m_last)) {
    out.put(w.mem_n < cap - 1 ? w.mem_n : cap - 1, p[0], p[1], p[2],
            w.i + 1, (int)p[3]);
    ++w.mem_n;
    w.m_last = w.i + 1;
    w.ik_x2 = p[2];
  }
}

// Takes the read's call through every step that needs no lookup.  Returns
// whether its next step is a lookup (the ends k1, k2, the base cb and, for
// a backward row, its entry j, p); false: the call is over (W_END).
template <typename C, typename Out>
__device__ bool walk_prepare(Walk<C> &w, const uint8_t *q, int L, int qlen,
                             int cap, C *la, C *lb, const Out &out, C &k1,
                             C &k2, int &cb, C p[4]) {
  for (;;) {
    if (w.phase == W_END) return false;
    if (w.phase == W_FWD) {
      const bool run = w.i < qlen;
      const int qi = run ? code_at(q, L, w.i) : 4;
      if (w.s1) {
        if (!run || qi >= 4) {
          w.ret = run ? w.i + 1 : qlen;
          w.phase = W_END;
          return false;
        }
      } else if (!run || qi >= 4 || w.ik2 < w.max_intv) {
        // off the end, an N or a small interval: the last push
        put4(la, w.cn++, cap, w.ik0, w.ik1, w.ik2, (C)w.info_end);
        w.ret = w.info_end;
        bwd_start(w, q, L);
        continue;
      }
      k1 = w.ik1 - 1;
      k2 = w.ik1 - 1 + w.ik2;
      cb = 3 - qi;
      return true;
    }
    if (w.j >= w.pn) {  // the row is over
      if (w.n0 == 0) {
        w.phase = W_END;
        return false;
      }
      w.on_b = !w.on_b;
      w.first = false;
      w.pn = w.n0;
      w.j = w.n0 = 0;
      w.last_x2 = 0;
      --w.i;
      row_start(w, q, L);
      continue;
    }
    const C *pr = (w.on_b ? lb : la) + (size_t)entry_slot(w, w.j, cap) * 4;
    p[0] = pr[0]; p[1] = pr[1]; p[2] = pr[2]; p[3] = pr[3];
    if (w.c < 0) {  // every entry kept: only the first can emit
      emit_rule(w, out, cap, p);
      w.j = w.pn;
      continue;
    }
    if (w.ik_x2 < w.max_intv) {  // kept, not extended
      emit_rule(w, out, cap, p);
      ++w.j;
      continue;
    }
    k1 = p[0] - 1;
    k2 = p[0] - 1 + p[2];
    cb = w.c;
    return true;
  }
}

// A forward step after its lookup (o1 = occ(k1)[cb], o2 = occ(k2)[cb], ab
// the counts above cb between them): ik forwards by q[i] (the reverse
// strand's backward extension by 3 - q[i]).
template <typename C>
__device__ void walk_forward(Walk<C> &w, C primary, const uint8_t *q, int L,
                             const C L2[5], int cap, C *la, C k1, C k2,
                             int cb, C o1, C o2, C ab) {
  const C span = (k1 < primary && k2 >= primary) ? 1 : 0;
  const C e0 = w.ik0 + span + ab, e1 = l2_at(L2, cb) + 1 + o1, e2 = o2 - o1;
  if (w.s1) {
    if (e2 < w.max_intv && w.i - w.x >= w.min_len) {
      w.found = true;
      w.r0 = e0; w.r1 = e1; w.r2 = e2;
      w.ret = w.i + 1;
      w.phase = W_END;
      return;
    }
  } else if (e2 != w.ik2) {  // the interval changed: push the old one
    put4(la, w.cn++, cap, w.ik0, w.ik1, w.ik2, (C)w.info_end);
    w.ret = w.info_end;
    if (e2 < w.minv) {
      bwd_start(w, q, L);
      return;
    }
  }
  w.ik0 = e0; w.ik1 = e1; w.ik2 = e2;
  w.info_end = w.i + 1;
  ++w.i;
}

// The warp's loop over its reads' steps until every read of the warp is
// done: E / T reads a warp, a team of T groups (T * 2R threads) a read,
// every thread of a team holding its read's state (the same values).
// Each step, each team takes its read through the steps that need no
// lookup (prepare: walk_prepare, and K11's calls and passes), then, if the
// read is not done, makes one round: in a forward pass, one lookup by the
// team's first group (the others load nothing); in a backward row, entries
// j..j+T-1, one a group, each extended by c, the row's order-dependent
// rules resolved by ballots over them (design item 3: with T = 1 the rule
// of one entry).  The warp's lookups are one glookup.  Returns the
// intervals the team's groups extended (counted by each group's first
// thread).
template <typename C, int NW, int T, typename A, typename Out, typename P>
__device__ unsigned long long warp_run(const A &a, const C L2[5], Walk<C> &w,
                                       const uint8_t *q, int L, C *la, C *lb,
                                       const Out &out, int cap, P &&prepare) {
  constexpr int G = NW / 4;
  constexpr unsigned LEADERS = FULL / ((1u << G) - 1);  // first of each group
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), grp = lane / G;
  const int t = grp % T, tb = (grp - t) * G;  // place in the team, its lane 0
  const unsigned team =
      T * G == 32 ? FULL : ((1u << (T * G)) - 1) << tb;
  const unsigned below = ((1u << (lane & ~(G - 1))) - 1) & team & LEADERS;
  unsigned long long work = 0;
  for (;;) {
    C k1 = 0, k2 = 0, p[4] = {0, 0, 0, 0};
    int cb = 0;
    const bool need = prepare(k1, k2, cb, p);
    if (!__any_sync(FULL, need)) break;
    const bool bwd = need && w.phase == W_BWD;
    const int je = bwd ? w.j + t : 0;  // the group's entry of the row
    const bool valid = bwd && je < w.pn;
    if (valid && t > 0) {  // entry j is the team's first group's
      const C *pr =
          (w.on_b ? lb : la) + (size_t)entry_slot(w, je, cap) * 4;
      p[0] = pr[0]; p[1] = pr[1]; p[2] = pr[2]; p[3] = pr[3];
      k1 = p[0] - 1;
      k2 = p[0] - 1 + p[2];
    }
    const bool look = bwd ? valid : (need && t == 0);
    C o1, o2, ab;
    glookup<C, NW, true>(a, L2, look ? k1 : (C)-1, look ? k2 : (C)-1, cb, gl,
                         o1, o2, ab);
    // ---- a forward step: the team's first group's lookup ----
    const bool fwd = need && !bwd;
    if (T > 1 && __any_sync(FULL, fwd)) {
      const C f1 = __shfl_sync(FULL, o1, tb), f2 = __shfl_sync(FULL, o2, tb),
              fa = __shfl_sync(FULL, ab, tb);
      if (fwd) {
        o1 = f1; o2 = f2; ab = fa;
      }
    }
    if (fwd) {
      walk_forward(w, a.primary, q, L, L2, cap, la, k1, k2, cb, o1, o2, ab);
      if (look && gl == 0) ++work;
    }
    if (!__any_sync(FULL, bwd)) {  // no backward round in the warp
      __syncwarp();
      continue;
    }
    // ---- a backward round: entries j..j+T-1 by ballots over them ----
    const C span = (p[0] <= a.primary && p[0] + p[2] - 1 >= a.primary) ? 1 : 0;
    const C e0 = l2_at(L2, cb) + 1 + o1, e1 = p[1] + span + ab, e2 = o2 - o1;
    // only the row's first entry can emit (the team's first group holds
    // it when j == 0), and its emit rewrites the ik size that keeps every
    // later entry
    const C f2 = __shfl_sync(FULL, e2, tb), fp2 = __shfl_sync(FULL, p[2], tb);
    const bool emit = bwd && w.j == 0 &&
                      (w.ik_x2 < w.max_intv || f2 < w.minv) && w.n0 == 0 &&
                      (w.mem_n == 0 || w.i + 1 < w.m_last);
    const C x2 = emit ? fp2 : w.ik_x2;
    const bool kept_ik = (je == 0 ? w.ik_x2 : x2) < w.max_intv;
    const bool unk = valid && !kept_ik && !(e2 < w.minv);
    // an unkept entry is pushed if its size differs from the nearest
    // earlier unkept entry's, or, with none before it in the round, if
    // the new list is empty or its size differs from the last push's
    const unsigned U = __ballot_sync(FULL, unk) & LEADERS & team;
    const unsigned Pb = U & below;
    const C pe2 = __shfl_sync(FULL, e2, Pb ? 31 - __clz(Pb) : lane);
    const C ue2 = __shfl_sync(FULL, e2, U ? 31 - __clz(U) : lane);
    const bool push = unk && (Pb ? e2 != pe2 : (w.n0 == 0 || e2 != w.last_x2));
    const unsigned PM = __ballot_sync(FULL, push) & LEADERS & team;
    if (bwd) {
      // a push of rank r writes slot min(r, cap - 1), the last one winning
      const int r = w.n0 + __popc(PM & below), last = w.n0 + __popc(PM) - 1;
      if (push && (r < cap - 1 || r == last))
        put4(w.on_b ? la : lb, r, cap, e0, e1, e2, p[3]);
      if (emit && t == 0)
        out.put(w.mem_n < cap - 1 ? w.mem_n : cap - 1, p[0], p[1], p[2],
                w.i + 1, (int)p[3]);
      if (valid && !kept_ik && gl == 0) ++work;
      w.n0 += __popc(PM);
      if (U) w.last_x2 = ue2;
      w.j = w.j + T < w.pn ? w.j + T : w.pn;
      w.ik_x2 = x2;
      if (emit) {
        ++w.mem_n;
        w.m_last = w.i + 1;
      }
    }
    __syncwarp();
  }
  __syncwarp();
  return work;
}

// the lists of the warp's read g: R reads a warp, per_read bytes each, in
// the block's shared memory or in the scratch
template <typename C, int R>
__device__ __forceinline__ C *read_lists(const SmemArgs<C> &a, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t slot = (size_t)(threadIdx.x >> 5) * R + g;
  if (a.scratch)
    return reinterpret_cast<C *>(
        a.scratch +
        ((size_t)blockIdx.x * (blockDim.x >> 5) * R + slot) * a.per_read);
  return reinterpret_cast<C *>(smem_raw + slot * a.per_read);
}

template <typename C>
__device__ __forceinline__ void load_l2(const SmemArgs<C> &a, C L2[5]) {
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)a.L2[c];
}

__device__ __forceinline__ void add_work(unsigned long long *work,
                                         unsigned long long n) {
  if (work && n) atomicAdd(work, n);
}

// K10a: bwt_smem1a, a team of T groups a read; each warp takes its
// 32 / (2R T) reads at a time
template <typename C, int NW, int T>
__global__ void __launch_bounds__(MAX_THREADS, T > 1 ? WARP_FORM_BLOCKS : 1)
    smem1a_kernel(SmemArgs<C> a) {
  constexpr int G = NW / 4, R = 32 / G / T;
  C L2[5];
  load_l2(a, L2);
  const int gl = threadIdx.x & (G - 1), rd = (threadIdx.x & 31) / G / T;
  const int wpb = blockDim.x >> 5, cap = a.cap, L = a.L;
  unsigned long long work = 0;
  for (int b0 = (blockIdx.x * wpb + (threadIdx.x >> 5)) * R; b0 < a.B;
       b0 += gridDim.x * wpb * R) {
    const int b = b0 + rd;
    const bool real = b < a.B;
    const int bb = real ? b : a.B - 1;
    const uint8_t *q = a.q + (size_t)bb * L;
    const int qlen = a.qlen[bb];
    C *la = read_lists<C, R>(a, rd), *lb = la + (size_t)cap * 4;
    const size_t row = (size_t)bb * cap;
    const MemOut<C> out{a.m0 + row, a.m1 + row, a.m2 + row, a.ms + row,
                        a.me + row};
    Walk<C> w;
    walk_smem1a(w, q, L, qlen, L2, a.x[bb], a.min_intv[bb], a.max_intv,
                real && a.active[bb] != 0);
    work += warp_run<C, NW, T>(
        a, L2, w, q, L, la, lb, out, cap,
        [&](C &k1, C &k2, int &cb, C *p) {
          return walk_prepare(w, q, L, qlen, cap, la, lb, out, k1, k2, cb, p);
        });
    if (real && gl == 0 && (threadIdx.x & 31) % (G * T) == 0) {
      a.ret[b] = w.ret;
      a.mem_n[b] = w.mem_n;
    }
  }
  add_work(a.work, work);
}

// K10b: bwt_seed_strategy1, a group a read
template <typename C, int NW>
__global__ void __launch_bounds__(MAX_THREADS)
    strategy1_kernel(SmemArgs<C> a) {
  constexpr int G = NW / 4, R = 32 / G;
  C L2[5];
  load_l2(a, L2);
  const int gl = threadIdx.x & (G - 1), rd = (threadIdx.x & 31) / G;
  const int wpb = blockDim.x >> 5, L = a.L;
  unsigned long long work = 0;
  for (int b0 = (blockIdx.x * wpb + (threadIdx.x >> 5)) * R; b0 < a.B;
       b0 += gridDim.x * wpb * R) {
    const int b = b0 + rd;
    const bool real = b < a.B;
    const int bb = real ? b : a.B - 1;
    const uint8_t *q = a.q + (size_t)bb * L;
    const int qlen = a.qlen[bb];
    Walk<C> w;
    walk_strategy1(w, q, L, qlen, L2, a.x[bb], a.min_len, a.max_intv,
                   real && a.active[bb] != 0);
    work += warp_run<C, NW, 1>(
        a, L2, w, q, L, (C *)nullptr, (C *)nullptr, NoOut{}, 1,
        [&](C &k1, C &k2, int &cb, C *p) {
          return walk_prepare(w, q, L, qlen, 1, (C *)nullptr, (C *)nullptr,
                              NoOut{}, k1, k2, cb, p);
        });
    if (real && gl == 0) {
      a.ret[b] = w.ret;
      a.found[b] = w.found ? 1 : 0;
      a.r0[b] = w.r0; a.r1[b] = w.r1; a.r2[b] = w.r2;
    }
  }
  add_work(a.work, work);
}

constexpr int K_START = 0, K_P1 = 1, K_P2 = 2, K_P3 = 3, K_DONE = 4;

// K11: mem_collect_intv's three passes, a read a warp (the warp form: its
// reads' passes diverge, which costs a warp of several reads the union of
// their code paths each step), each call one of K10's walks; then its
// seeds sorted by the warp
template <typename C, int NW>
__global__ void __launch_bounds__(MAX_THREADS, WARP_FORM_BLOCKS)
    collect_kernel(SmemArgs<C> a) {
  constexpr int G = NW / 4, T = 32 / G, R = 1;
  C L2[5];
  load_l2(a, L2);
  const int lane = threadIdx.x & 31, rd = lane / G / T;
  const int wpb = blockDim.x >> 5, cap = a.cap, cap_s = a.cap_s, L = a.L;
  unsigned long long work = 0;
  for (int b0 = (blockIdx.x * wpb + (threadIdx.x >> 5)) * R; b0 < a.B;
       b0 += gridDim.x * wpb * R) {
    const int b = b0 + rd;
    const bool real = b < a.B;
    const int bb = real ? b : a.B - 1;
    const uint8_t *q = a.q + (size_t)bb * L;
    const int qlen = a.qlen[bb];
    C *la = read_lists<C, R>(a, rd), *lb = la + (size_t)cap * 4;
    const MemList<C> mems{lb + (size_t)cap * 4};
    C *raw = a.raw + (size_t)bb * cap_s * 5;
    int pass = real ? K_START : K_DONE, cx = 0, k = 0, old_n = 0, seed_n = 0;
    Walk<C> w;
    w.phase = W_END;
    w.mem_n = 0;
    auto skip_amb = [&](int x) {
      while (x < qlen && code_at(q, L, x) >= 4) ++x;
      return x;
    };
    // a seed row (the last slot overwritten once the store is full)
    auto append = [&](C v0, C v1, C v2, C v3, C v4) {
      C *r = raw + (size_t)(seed_n < cap_s - 1 ? seed_n : cap_s - 1) * 5;
      r[0] = v0; r[1] = v1; r[2] = v2; r[3] = v3; r[4] = v4;
      ++seed_n;
    };
    // the call that ended: its seeds; then the next call, or pass
    auto next_call = [&]() {
      if (pass == K_P1 || pass == K_P2) {
        // its mems of min_seed_len bases or more, oldest first
        for (int j = 0; j < w.mem_n; ++j) {
          const C *r =
              mems.m + (size_t)clampi(w.mem_n - 1 - j, 0, cap - 1) * 5;
          if (r[4] - r[3] >= a.min_seed_len)
            append(r[0], r[1], r[2], r[3], r[4]);
        }
        if (pass == K_P1) cx = skip_amb(w.ret);
      } else if (pass == K_P3) {
        if (w.found && w.r2 > 0) append(w.r0, w.r1, w.r2, (C)w.x, (C)w.ret);
        cx = skip_amb(w.ret);
      } else {  // the read's start
        pass = K_P1;
        cx = skip_amb(0);
      }
      // pass 1: SMEMs, the cursor advanced by each call's ret
      if (pass == K_P1) {
        if (cx < qlen) {
          walk_smem1a(w, q, L, qlen, L2, cx, (C)1, (C)0, true);
          return;
        }
        pass = K_P2;
        old_n = seed_n;
        k = 0;
      }
      // pass 2: re-seed long low-occurrence SMEMs from their midpoints
      if (pass == K_P2) {
        while (k < old_n) {
          const C *r = raw + (size_t)(k < cap_s - 1 ? k : cap_s - 1) * 5;
          ++k;
          const C x2 = r[2];
          const int s = (int)r[3], e = (int)r[4];
          if (e - s < a.split_len || x2 > a.split_width) continue;
          walk_smem1a(w, q, L, qlen, L2, (s + e) >> 1, x2 + 1, (C)0, true);
          return;
        }
        // pass 3: LAST-like seeding (no hit without a positive
        // max_mem_intv)
        pass = K_P3;
        cx = a.max_mem_intv > 0 ? skip_amb(0) : qlen;
      }
      if (cx < qlen) {
        walk_strategy1(w, q, L, qlen, L2, cx, a.min_seed_len, a.max_mem_intv,
                       true);
        return;
      }
      pass = K_DONE;
    };
    work += warp_run<C, NW, T>(
        a, L2, w, q, L, la, lb, mems, cap,
        [&](C &k1, C &k2, int &cb, C *p) {
          for (;;) {
            if (pass == K_DONE) return false;
            if (walk_prepare(w, q, L, qlen, cap, la, lb, mems, k1, k2, cb, p))
              return true;
            next_call();
          }
        });
    // ---- each read's stable sort by (start, end), the warp on one read at
    // a time: each row to its rank ----
    const int shift = a.key64 ? 32 : 16;
    for (int g = 0; g < R; ++g) {
      const int n = __shfl_sync(FULL, seed_n, g * G * T), bg = b0 + g;
      if (bg >= a.B) break;
      const C *rg = a.raw + (size_t)bg * cap_s * 5;
      auto key = [&](int t) -> int64_t {
        if (t >= n) return (int64_t)0x7fffffffffffffffLL;  // a pad
        const C *r = rg + (size_t)t * 5;
        return ((int64_t)r[3] << shift) | (int64_t)r[4];
      };
      const size_t out = (size_t)bg * cap_s;
      for (int t = lane; t < cap_s; t += 32) {
        const int64_t kt = key(t);
        int rank = 0;
        for (int u = 0; u < cap_s; ++u) {
          const int64_t ku = key(u);
          rank += ku < kt || (ku == kt && u < t);
        }
        const C *r = rg + (size_t)t * 5;
        a.s0[out + rank] = r[0];
        a.s1[out + rank] = r[1];
        a.s2[out + rank] = r[2];
        a.ss[out + rank] = (int32_t)r[3];
        a.se[out + rank] = (int32_t)r[4];
      }
      if (lane == 0) a.seed_n[bg] = n;
    }
    __syncwarp();
  }
  add_work(a.work, work);
}

// K9: bwt_sa a thread a row (design note at the top)
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
      ++steps;
      if (k == primary) {  // the $ row: bwt_sa's k = 0, its count unused
        k = 0;
        break;
      }
      // the $-removed row: the position of the BWT base and of its count
      // in B[0..k] (bwt_occ) alike, so one block holds both
      C kk = k - (k > primary ? 1 : 0);
      kk = kk > seq_len - 1 ? seq_len - 1 : kk;
      const size_t blk = (size_t)(kk >> 7);
      const uint4 *wp = reinterpret_cast<const uint4 *>(words + blk * 8);
      const uint4 *cp = reinterpret_cast<const uint4 *>(ckpt + blk * 4);
      // the block's text words and counts, all issued before any is used
      const uint4 w0 = ldg_now(wp), w1 = ldg_now(wp + 1);
      const uint4 c0 = ldg_now(cp);
      const uint4 c1 = sizeof(C) == 8 ? ldg_now(cp + 1) : c0;
      const uint32_t ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const int kw = (int)(kk >> 4) & 7, kb = (int)(kk & 15);
      uint32_t wx = ws[0];
#pragma unroll
      for (int u = 1; u < 8; ++u) wx = u == kw ? ws[u] : wx;
      const int c = (int)(wx >> ((15 - kb) << 1)) & 3;
      int n = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int nkeep = clampi((kw - u) * 16 + kb + 1, 0, 16);
        const uint32_t mask = nkeep > 0 ? FULL << ((16 - nkeep) << 1) : 0u;
        const uint32_t word = ws[u] & mask, m55 = mask & M55;
        const uint32_t hi = (word >> 1) & M55, lo = word & M55;
        n += __popc(((c & 2) ? hi : ~hi & m55) & ((c & 1) ? lo : ~lo & m55));
      }
      C cnt;
      if (sizeof(C) == 4) {
        cnt = (C)sel4(c0.x, c0.y, c0.z, c0.w, c);
      } else {  // two 64-bit counts a vector
        const uint4 h = c < 2 ? c0 : c1;
        const uint64_t lo = (c & 1) ? h.z : h.x, hi = (c & 1) ? h.w : h.y;
        cnt = (C)(lo | hi << 32);
      }
      C occ = cnt + n;
      if (k == seq_len) occ = pick(L2, c + 1) - pick(L2, c);
      k = pick(L2, c) + occ;
    }
    out[t] = (C)steps + ssa[k >> 5];
  }
  if (work) {  // the walk steps summed and the longest walk
    const unsigned longest = __reduce_max_sync(FULL, steps);
    steps = __reduce_add_sync(FULL, steps);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(work, (unsigned long long)steps);
      atomicMax(work + 1, (unsigned long long)longest);
    }
  }
}

// A 16-byte read-only load issued only where p holds (r kept elsewhere), in
// program order with the other loads (ldg_now)
__device__ __forceinline__ void ldg_if(bool p, const uint4 *ptr, uint4 &r) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %4, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%5];\n\t}"
      : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w)
      : "r"((int)p), "l"(ptr));
}

// K9's occtab form: bwt_sa a thread a row on K1's fused table, NW text
// words a row (design note at the top)
template <typename C, int NW>
__global__ void __launch_bounds__(128)
    sa_occ_kernel(const uint32_t *occtab, const C *ssa, const int64_t *L2p,
                  C primary, C seq_len, const C *k_in, C *out, int N,
                  unsigned long long *work) {
  constexpr int RB = NW == 8 ? 0 : 2;  // log2(R)
  constexpr int NV = NW / 4;           // 16-byte vectors of text a row
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  C L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)L2p[c];
  unsigned steps = 0;
  if (t < N) {
    C k = k_in[t];
    while ((k & 31) != 0) {
      ++steps;
      if (k == primary) {  // the $ row: bwt_sa's k = 0, its count unused
        k = 0;
        break;
      }
      // the $-removed row, where the BWT base and its count lie alike
      C kk = k - (k > primary ? 1 : 0);
      kk = kk > seq_len - 1 ? seq_len - 1 : kk;
      const uint4 *row = reinterpret_cast<const uint4 *>(
          occtab + (size_t)(kk >> (7 + RB)) * (4 + NW));
      const int kw = (int)(kk >> 4) & (NW - 1), kb = (int)(kk & 15);
      const int last = kw >> 2;  // the vector that holds word kw
      // the row's counts and its text up to word kw, all issued before
      // any is used: one round trip a step
      const uint4 cnt = ldg_now(row);
      uint4 w[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        w[v] = make_uint4(0u, 0u, 0u, 0u);
        ldg_if(v <= last, row + 1 + v, w[v]);
      }
      uint4 wl = w[0];
#pragma unroll
      for (int v = 1; v < NV; ++v) wl = v == last ? w[v] : wl;
      const int c =
          (int)(sel4(wl.x, wl.y, wl.z, wl.w, kw & 3) >> ((15 - kb) << 1)) &
          3;
      // base c's fields in B[row start .. kk]: a field equal to c is 00
      // after the xor with c in every field
      const uint32_t pat = (uint32_t)c * M55;
      int n = 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const uint32_t ws[4] = {w[v].x, w[v].y, w[v].z, w[v].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nkeep = clampi((kw - (4 * v + u)) * 16 + kb + 1, 0, 16);
          const uint32_t mask = nkeep > 0 ? FULL << ((16 - nkeep) << 1) : 0u;
          const uint32_t x = ws[u] ^ pat;
          n += __popc(~(x | (x >> 1)) & mask & M55);
        }
      }
      C occ = count_of<C>(cnt, c) + n;
      if (k == seq_len) occ = l2_next(L2, c) - l2_at(L2, c);
      k = l2_at(L2, c) + occ;
    }
    out[t] = (C)steps + ssa[k >> 5];
  }
  if (work) {  // the walk steps summed and the longest walk
    const unsigned longest = __reduce_max_sync(FULL, steps);
    steps = __reduce_add_sync(FULL, steps);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(work, (unsigned long long)steps);
      atomicMax(work + 1, (unsigned long long)longest);
    }
  }
}

// a kernel on its lists: `wpb` warps a block, `blocks`, `smem` shared bytes
template <typename C>
int launch_with(void (*kern)(SmemArgs<C>), const SmemArgs<C> &a, int wpb,
                int blocks, size_t smem, cudaStream_t stream) {
  if (!kern || wpb < 1 || wpb * 32 > MAX_THREADS || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)e;
    }
  }
  kern<<<blocks, wpb * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// kernel `which` (0 K10a, 1 K10b, 2 K11) at NW text words a row, a team
// of T groups a read
// (K10b: the group form; K11: the warp form)
template <typename C, int NW, int T>
void (*kernel_of(int which))(SmemArgs<C>) {
  switch (which) {
    case 0: return smem1a_kernel<C, NW, T>;
    case 1: return strategy1_kernel<C, NW>;
    case 2: return collect_kernel<C, NW>;
    default: return nullptr;
  }
}

// warp: a read a warp (T = 32 / 2R), else a read a group (T = 1)
template <typename C>
void (*kernel_for(int which, int nw, int warp))(SmemArgs<C>) {
  if (nw == 8)
    return warp ? kernel_of<C, 8, 16>(which) : kernel_of<C, 8, 1>(which);
  if (nw == 32)
    return warp ? kernel_of<C, 32, 4>(which) : kernel_of<C, 32, 1>(which);
  return nullptr;
}

// registers a thread, resident blocks an SM and local bytes of a kernel at
// `wpb` warps a block and `smem` dynamic shared bytes
template <typename C>
int occupancy_of(int which, int nw, int warp, int wpb, size_t smem,
                 int32_t *out) {
  auto kern = kernel_for<C>(which, nw, warp);
  if (!kern || wpb < 1 || wpb * 32 > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, wpb * 32,
                                                      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  out[0] = fa.numRegs;
  out[1] = blocks;
  out[2] = (int)fa.localSizeBytes;
  return 0;
}

template <typename C>
void fill_common(SmemArgs<C> &a, const uint32_t *occtab, const int64_t *L2,
                 int64_t primary, int64_t seq_len, const uint8_t *q, int B,
                 int L, const int32_t *qlen, void *scratch, int64_t per_read,
                 void *work) {
  a.occtab = occtab; a.L2 = L2; a.primary = (C)primary;
  a.seq_len = (C)seq_len; a.q = q; a.B = B; a.L = L; a.qlen = qlen;
  a.scratch = (unsigned char *)scratch; a.per_read = (size_t)per_read;
  a.work = static_cast<unsigned long long *>(work);
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

// K9's occtab form: out[t] = bwt_sa(k[t]) for N rows on the fused occtab
// of nw (8 or 32) text words a row
extern "C" int bwa_sa_occ(int coord64, const uint32_t *occtab, int nw,
                          const void *ssa, const int64_t *L2,
                          int64_t primary, int64_t seq_len, const void *k,
                          void *out, int N, void *work, void *stream) {
  if (N == 0) return 0;
  if (nw != 8 && nw != 32) return (int)cudaErrorInvalidValue;
  const int blocks = (N + 127) / 128;
  auto *wk = static_cast<unsigned long long *>(work);
  if (coord64) {
    auto kern = nw == 8 ? sa_occ_kernel<int64_t, 8>
                        : sa_occ_kernel<int64_t, 32>;
    kern<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        occtab, (const int64_t *)ssa, L2, primary, seq_len,
        (const int64_t *)k, (int64_t *)out, N, wk);
  } else {
    auto kern = nw == 8 ? sa_occ_kernel<int32_t, 8>
                        : sa_occ_kernel<int32_t, 32>;
    kern<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        occtab, (const int32_t *)ssa, L2, (int32_t)primary,
        (int32_t)seq_len, (const int32_t *)k, (int32_t *)out, N, wk);
  }
  return (int)cudaGetLastError();
}

// K9 from host rows to host positions, in the occtab form where occtab is
// given, else on ckpt and words: the N rows k_host (pinned) up into k,
// work zeroed, the launch, the positions and work down into out_host and
// work_host (pinned), the stream synchronised.  One call a lookup, so that
// a Python caller need not let go of its interpreter lock between the
// steps (ops/fm.py::DeviceSA)
extern "C" int bwa_sa_round_trip(int coord64, const uint32_t *occtab,
                                 int nw, const void *ckpt,
                                 const uint32_t *words, const void *ssa,
                                 const int64_t *L2, int64_t primary,
                                 int64_t seq_len, const void *k_host,
                                 void *k, void *out, void *out_host, int N,
                                 void *work, void *work_host, void *stream) {
  auto s = (cudaStream_t)stream;
  const size_t bytes = (size_t)N * (coord64 ? 8 : 4);
  cudaError_t e = cudaMemcpyAsync(k, k_host, bytes, cudaMemcpyHostToDevice,
                                  s);
  if (e == cudaSuccess) e = cudaMemsetAsync(work, 0, 16, s);
  if (e != cudaSuccess) return (int)e;
  const int rc = occtab ? bwa_sa_occ(coord64, occtab, nw, ssa, L2, primary,
                                     seq_len, k, out, N, work, stream)
                        : bwa_sa_batch(coord64, ckpt, words, ssa, L2,
                                       primary, seq_len, k, out, N, work,
                                       stream);
  if (rc) return rc;
  e = cudaMemcpyAsync(out_host, out, bytes, cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(work_host, work, 16, cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  return (int)e;
}

// K10a: bwt_smem1a of each of the B reads from x, a group a read or, with
// `warp`, a warp a read (design item 3); wpb warps a block
// over `blocks` blocks, the lists in `smem` shared bytes a block or, with
// scratch, in it; per_read bytes of lists a read
extern "C" int bwa_smem1a(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *x, const void *min_intv,
    int64_t max_intv, const uint8_t *active, int cap, int32_t *ret, void *m0,
    void *m1, void *m2, int32_t *ms, int32_t *me, int32_t *mem_n, int warp,
    int wpb, int blocks, int64_t smem, void *scratch, int64_t per_read,
    void *work, void *stream) {
  if (B == 0) return 0;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (coord64) {
    SmemArgs<int64_t> a{};
    fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, scratch,
                per_read, work);
    a.x = x; a.min_intv = (const int64_t *)min_intv; a.max_intv = max_intv;
    a.active = active; a.cap = cap; a.ret = ret; a.m0 = (int64_t *)m0;
    a.m1 = (int64_t *)m1; a.m2 = (int64_t *)m2; a.ms = ms; a.me = me;
    a.mem_n = mem_n;
    return launch_with(kernel_for<int64_t>(0, nw, warp), a, wpb, blocks,
                       (size_t)smem, (cudaStream_t)stream);
  }
  SmemArgs<int32_t> a{};
  fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, scratch,
              per_read, work);
  a.x = x; a.min_intv = (const int32_t *)min_intv;
  a.max_intv = (int32_t)max_intv; a.active = active; a.cap = cap;
  a.ret = ret; a.m0 = (int32_t *)m0; a.m1 = (int32_t *)m1;
  a.m2 = (int32_t *)m2; a.ms = ms; a.me = me; a.mem_n = mem_n;
  return launch_with(kernel_for<int32_t>(0, nw, warp), a, wpb, blocks,
                     (size_t)smem, (cudaStream_t)stream);
}

// K10b: bwt_seed_strategy1 of each of the B reads from x, a group a read;
// wpb warps a block over `blocks` blocks
extern "C" int bwa_strategy1(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *x, int min_len, int64_t max_intv,
    const uint8_t *active, int32_t *ret, uint8_t *found, void *r0, void *r1,
    void *r2, int wpb, int blocks, void *work, void *stream) {
  if (B == 0) return 0;
  if (coord64) {
    SmemArgs<int64_t> a{};
    fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, nullptr, 0,
                work);
    a.x = x; a.min_len = min_len; a.max_intv = max_intv; a.active = active;
    a.ret = ret; a.found = found; a.r0 = (int64_t *)r0;
    a.r1 = (int64_t *)r1; a.r2 = (int64_t *)r2;
    return launch_with(kernel_for<int64_t>(1, nw, 0), a, wpb, blocks, 0,
                       (cudaStream_t)stream);
  }
  SmemArgs<int32_t> a{};
  fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, nullptr, 0,
              work);
  a.x = x; a.min_len = min_len; a.max_intv = (int32_t)max_intv;
  a.active = active; a.ret = ret; a.found = found; a.r0 = (int32_t *)r0;
  a.r1 = (int32_t *)r1; a.r2 = (int32_t *)r2;
  return launch_with(kernel_for<int32_t>(1, nw, 0), a, wpb, blocks, 0,
                     (cudaStream_t)stream);
}

// K11: mem_collect_intv's three passes for each of the B reads, a warp a
// read, seeds appended to raw (zeroed [B, cap_s, 5]) and sorted into
// s0..se; the lists planned as K10a's
extern "C" int bwa_collect_intv(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_mem_intv, int cap, int cap_s, int key64,
    void *raw, void *s0, void *s1, void *s2, int32_t *ss, int32_t *se,
    int32_t *seed_n, int wpb, int blocks, int64_t smem,
    void *scratch, int64_t per_read, void *work, void *stream) {
  if (B == 0) return 0;
  if (cap < 1 || cap_s < 1) return (int)cudaErrorInvalidValue;
  if (coord64) {
    SmemArgs<int64_t> a{};
    fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, scratch,
                per_read, work);
    a.min_seed_len = min_seed_len; a.split_len = split_len;
    a.split_width = split_width; a.max_mem_intv = max_mem_intv;
    a.cap = cap; a.cap_s = cap_s; a.key64 = key64;
    a.raw = (int64_t *)raw; a.s0 = (int64_t *)s0; a.s1 = (int64_t *)s1;
    a.s2 = (int64_t *)s2; a.ss = ss; a.se = se; a.seed_n = seed_n;
    return launch_with(kernel_for<int64_t>(2, nw, 1), a, wpb, blocks,
                       (size_t)smem, (cudaStream_t)stream);
  }
  SmemArgs<int32_t> a{};
  fill_common(a, occtab, L2, primary, seq_len, q, B, L, qlen, scratch,
              per_read, work);
  a.min_seed_len = min_seed_len; a.split_len = split_len;
  a.split_width = (int32_t)split_width;
  a.max_mem_intv = (int32_t)max_mem_intv; a.cap = cap; a.cap_s = cap_s;
  a.key64 = key64; a.raw = (int32_t *)raw; a.s0 = (int32_t *)s0;
  a.s1 = (int32_t *)s1; a.s2 = (int32_t *)s2; a.ss = ss; a.se = se;
  a.seed_n = seed_n;
  return launch_with(kernel_for<int32_t>(2, nw, 1), a, wpb, blocks,
                     (size_t)smem, (cudaStream_t)stream);
}

// registers a thread, resident blocks an SM and local bytes (out[0..2]) of
// kernel `which` (0 K10a, 1 K10b, 2 K11) at wpb warps a block and smem
// dynamic shared bytes, on the current device
extern "C" int bwa_smem_occupancy(int which, int coord64, int nw, int warp,
                                  int wpb, int64_t smem, int32_t *out) {
  return coord64 ? occupancy_of<int64_t>(which, nw, warp, wpb, (size_t)smem,
                                         out)
                 : occupancy_of<int32_t>(which, nw, warp, wpb, (size_t)smem,
                                         out);
}
