// Kernels K7 and K7w: the bwa aln backtrack search, a group of threads per
// read.
//
// K7 (bwa_gap_machine) replaces the JAX package's XLA while_loop
// bwa_tpu/ops/gap_machine.py::gap_machine: each lane runs one read's
// best-first bounded-difference search (bwt_match_gap, bwtgap.c:109-264) to
// its own end.  K7w (bwa_cal_width) replaces its lax.scan cal_width_device:
// the per-position (w, bid) lower bounds of bwt_cal_width (bwtaln.c:57-81).
// Their plain versions are bwa_tpu_torch/ops/gap_machine.py::
// gap_machine_plain and cal_width_plain; per lane, aln_m, aln_kl, n_aln,
// n_stk, ovf, done_step, n_occ and the longest lane's steps (K7) and the
// width table (K7w) are equal bit for bit.
//
// What bounds them on an H100: neither bytes nor operations but chains of
// dependent steps.  A K7 step pops the stack's least entry and, to walk or
// expand it, needs an occ4 pair at positions the entry holds; a K7w step
// needs the pair at the interval the last one made.  The occtab of a 4.6
// Mbp genome is 1.5-3.5 MB and stays in the 50 MB L2.  The first port ran
// a thread per read, with occ4 a loop of serial loads and the stack's
// bookkeeping a chain of global loads: about ten round trips a step (7.1
// us a step of aln_se's longest lane).  Redesigned for Hopper, a lane's
// step issues its loads in one round trip, and what remains is the step's
// own instructions and the warp it shares (PERF.md section 6):
//  1. A group of G = 2R threads a lane (2 for R = 1 occtab rows, 8 for
//     R = 4; the aln path passes R = 1 rows, batch_search.search_tree):
//     the lane's scalar state is the same in all its threads, so a group
//     never diverges and a warp only between its 32/G lanes.
//  2. Cooperative occ4 (as K1's extend_c): half the group counts B[0..k],
//     half B[0..l], each thread the row's counts and 8 text words (only
//     those up to k's), all loads issued together (ld.global.nc in inline
//     asm: nvcc sank the counts load below the popcounts); packed 10-bit
//     counts are summed by shuffles within a half and the four counts
//     exchanged between the halves.  A K7 step does one such pair
//     whatever its phase, the walk's (wk-1, wl) or the popped entry's
//     (k-1, l), with the loads of the codes and width tables the step
//     reads issued beside it; a pop that neither walks nor expands
//     discards it.
//  3. The stack is the reference's gap_stack_t (bwtgap.c:17-84): one LIFO
//     list a score, the pop taking the head of the lowest non-empty list.
//     The plain version's key (score << 18 | (2^18 - 1 - seqno)) is unique
//     within a lane and its least key is exactly that entry, so the pop
//     order is the plain version's; n_stk and every overflow test
//     (n_push > cap - n_stk) are its counts over a key array of cap slots.
//     The bookkeeping is on chip:
//     - the newest child an expansion pushes onto the list it popped from
//       (the exact-match child, bwtgap.c:247-253) is the next pop, so it
//       stays in registers, packed, and never reaches memory; so does the
//       root;
//     - a bitmap of the non-empty lists in registers makes the lowest one
//       a find-first-set (128 lists; score_lists at default options: 56);
//     - the list heads live in shared memory, and so do 16 freed slots;
//       past them, 7 at a time go into the slot just freed (a chunk list
//       in the pool), so a push takes a slot without a load;
//     - only the slots live in global memory, one 32-byte record each (k,
//       l, the list link and the eight small fields packed).
//     Every thread computes the step's push plan (at most 9 children in
//     the reference's order: insertion, 4 deletions, 4 substitutions, in
//     four score classes) as bit masks; child c, when it takes a slot, is
//     placed, linked and written by thread c mod G.
//  4. The hit bookkeeping is strided over the group: the tandem duplicate
//     test (bwtgap.c:166-169) over the hits so far, and gap_shadow
//     (bwtgap.c:86-96) over the lane's width table, its running count of
//     equal widths from a ballot and a popcount.
//  5. A persistent grid: each group takes the next lane from a counter
//     when its lane ends, so a warp is not held by its longest lane.
//  6. A launch whose fields do not fit the packed record (a read past 512,
//     md + 1, mg or max_gape past 255, or more than 128 lists) takes the
//     wide-record variant of the same kernel (WIDE: 48- or 64-byte
//     records, heads and bitmap in global memory).  Templated on the
//     coordinate type (int32 when 2*l_pac+2 < 2^31, else int64); the
//     search flags are launch constants.
// K7w runs the same group lookup once a base, a group a read, the next
// code loaded a step ahead.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (bwa_tpu_torch/ops/cuda_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P_RUN = 0, P_WALK = 1, P_DONE = 2;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2;
constexpr int32_t SENT = 0x7FFFFFFF;
constexpr int SEQ_BITS = 18;
constexpr int32_t SEQ_CAP = 1 << SEQ_BITS;
constexpr int32_t SCORE_CAP = (SENT >> SEQ_BITS) - 1;
constexpr uint32_t M55 = 0x55555555u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int W_THREADS = 128;  // K7w: threads a block
constexpr int K_THREADS = 32;   // K7: threads a block (one warp)
constexpr int NBW = 4;          // compact: bitmap words in registers
constexpr int FS = 16;          // free-slot stack a lane, in shared memory
constexpr int CHUNK = 7;        // free slots a spilled slot carries
constexpr int PACK_L = 512;     // compact: the longest read (i, ldp: 10 bits)
constexpr int PACK_D = 255;     // compact: md + 1, mg, max_gape (8 bits)
// ops/gap_machine.py mirrors PACK_L, PACK_D, FS and CHUNK

template <typename C>
struct Fm {
  const uint32_t *occtab;  // [n_rows, 4 + nw] counts || text words
  int nw, rb;              // words a row (8R), log2(R)
  const int64_t *L2;       // [5]
  C primary, seq_len;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// v[c] for a c known only at run time, by selects (no local memory)
template <typename C>
__device__ __forceinline__ C pick(const C v[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

template <typename C>
__device__ __forceinline__ void load_L2(const Fm<C> &f, C L2[5]) {
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)f.L2[c];
}

// A 16-byte read-only load that the compiler keeps in program order with
// the others (nvcc would otherwise sink the row's counts load below the
// popcounts of the text words, a second round trip)
__device__ __forceinline__ uint4 ldg_now(const uint4 *p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// The mask of a thread's group, for G threads a group
__device__ __forceinline__ unsigned group_mask(int lane, int G) {
  return G == 32 ? FULL : ((1u << G) - 1) << (lane & ~(G - 1));
}

// One thread's share of an occ4 lookup at k: the row's counts and text
// words 8h..8h+7 (only those up to the one that holds k), loaded at once
struct RowPart {
  uint4 cnt, w0, w1;
  int kw, kbit;
};

template <typename C>
__device__ __forceinline__ RowPart row_load(const Fm<C> &f, C k, int h) {
  C kk = k - (k >= f.primary ? 1 : 0);
  kk = kk < 0 ? 0 : (kk > f.seq_len - 1 ? f.seq_len - 1 : kk);
  const uint4 *row = reinterpret_cast<const uint4 *>(
      f.occtab + (size_t)(kk >> (7 + f.rb)) * (4 + f.nw));
  RowPart r;
  r.kw = (int)(kk >> 4) & (f.nw - 1);
  r.kbit = (int)(kk & 15);
  const uint4 z4 = make_uint4(0, 0, 0, 0);
  r.cnt = ldg_now(row);
  r.w0 = 8 * h <= r.kw ? ldg_now(row + 1 + 2 * h) : z4;
  r.w1 = 8 * h + 4 <= r.kw ? ldg_now(row + 2 + 2 * h) : z4;
  return r;
}

// counts of bases 1, 2, 3 in the part's words, 10 bits each
__device__ __forceinline__ uint32_t row_packed(const RowPart &r, int h) {
  const uint32_t ws[8] = {r.w0.x, r.w0.y, r.w0.z, r.w0.w,
                          r.w1.x, r.w1.y, r.w1.z, r.w1.w};
  uint32_t packed = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int nkeep = (r.kw - (h * 8 + t)) * 16 + r.kbit + 1;
    const uint32_t mask = nkeep <= 0    ? 0u
                          : nkeep >= 16 ? FULL
                                        : FULL << ((16 - nkeep) << 1);
    const uint32_t word = ws[t] & mask;
    const uint32_t hi = (word >> 1) & M55, lo = word & M55;
    const uint32_t n3 = __popc(hi & lo);
    packed += (__popc(lo) - n3) | ((__popc(hi) - n3) << 10) | (n3 << 20);
  }
  return packed;
}

// bwt_occ4 (bwt.c:169-186) from a row's counts and the packed sums of its
// words; k == -1 gives zeros, k == seq_len the L2 differences
template <typename C>
__device__ __forceinline__ void row_counts(const Fm<C> &f, const C L2[5], C k,
                                           const RowPart &r, uint32_t packed,
                                           C o[4]) {
  const int n1 = packed & 1023, n2 = (packed >> 10) & 1023, n3 = packed >> 20;
  o[0] = (C)r.cnt.x + (C)(r.kw * 16 + r.kbit + 1 - n1 - n2 - n3);
  o[1] = (C)r.cnt.y + (C)n1;
  o[2] = (C)r.cnt.z + (C)n2;
  o[3] = (C)r.cnt.w + (C)n3;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (k == -1) o[c] = 0;
    else if (k == f.seq_len) o[c] = L2[c + 1] - L2[c];
  }
}

// occ4 at ka and kb by the G = 2H threads of a group (gl: thread in the
// group, gm: the group's mask), every load issued together: threads [0, H)
// count B[0..ka], threads [H, 2H) B[0..kb], each 8 text words of the row;
// packed sums meet by shuffles within each half and the four counts are
// exchanged between the halves.  Every thread leaves with oa[4] and ob[4].
template <typename C>
__device__ __forceinline__ void occ4_pair(const Fm<C> &f, const C L2[5], C ka,
                                          C kb, int gl, int G, unsigned gm,
                                          C oa[4], C ob[4]) {
  const int H = G >> 1;
  const bool half = gl >= H;
  const int h = half ? gl - H : gl;
  const C k = half ? kb : ka;
  const RowPart r = row_load(f, k, h);
  uint32_t packed = row_packed(r, h);
  for (int off = 1; off < H; off <<= 1)
    packed += __shfl_xor_sync(gm, packed, off);
  C o[4];
  row_counts(f, L2, k, r, packed, o);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const C x = __shfl_xor_sync(gm, o[c], H);
    oa[c] = half ? x : o[c];
    ob[c] = half ? o[c] : x;
  }
}

// ---------------------------------------------------------------- K7w

template <typename C>
__global__ void __launch_bounds__(W_THREADS)
    cal_width_kernel(Fm<C> f, const uint8_t *q, int B, int L, C *out, int G) {
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int b = (blockIdx.x * W_THREADS + threadIdx.x) / G;
  if (b >= B) return;  // whole groups: G divides the block
  const unsigned gm = group_mask(lane, G);
  C L2[5];
  load_L2(f, L2);
  q += (size_t)b * L;
  out += (size_t)b * L * 2;
  C k = 0, l = f.seq_len, bid = 0;
  int cn = __ldg(q);  // the next code, loaded a step ahead
  for (int t = 0; t < L; ++t) {
    const int c = cn;
    if (t + 1 < L) cn = __ldg(q + t + 1);
    C k2 = k, l2 = l;
    const bool good = c < 4;
    if (good) {  // the same for the whole group
      C ok[4], ol[4];
      occ4_pair(f, L2, k - 1, l, gl, G, gm, ok, ol);
      const C l2c = pick(L2, c);
      k2 = l2c + pick(ok, c) + 1;
      l2 = l2c + pick(ol, c);
    }
    const bool reset = k2 > l2 || !good;
    bid += reset ? 1 : 0;
    k = reset ? 0 : k2;
    l = reset ? f.seq_len : l2;
    if (gl == (t & (G - 1))) {
      out[2 * t] = l - k + 1;
      out[2 * t + 1] = bid;
    }
  }
}

// ---------------------------------------------------------------- K7

// A stack entry in registers
template <typename C>
struct Ent {
  C k, l;
  int i, mm, go, ge, ins, del, st, ldp;
};

// A slot of the pool.  Compact (32 bytes, both coordinate types): k, l, the
// list link, then i | ldp << 10 | st << 20, mm | go << 8 | ge << 16 and
// ins | del << 16.  Wide (48 or 64 bytes): eight int32 fields, k, l, link.
template <typename C, bool WIDE>
struct Rec {
  static constexpr int VECS = WIDE ? (sizeof(C) == 4 ? 3 : 4) : 2;
};

template <typename C, bool WIDE>
__device__ __forceinline__ void load_rec(const uint4 *pool, int s, Ent<C> &e,
                                         int &nxt) {
  constexpr int V = Rec<C, WIDE>::VECS;
  union {
    uint4 v[V];
    int32_t w[4 * V];
  } u;
#pragma unroll
  for (int j = 0; j < V; ++j) u.v[j] = pool[(size_t)s * V + j];
  int o;  // the first word after k and l
  if constexpr (sizeof(C) == 4) {
    e.k = (C)u.w[0];
    e.l = (C)u.w[1];
    o = 2;
  } else {
    e.k = (C)(((uint64_t)(uint32_t)u.w[1] << 32) | (uint32_t)u.w[0]);
    e.l = (C)(((uint64_t)(uint32_t)u.w[3] << 32) | (uint32_t)u.w[2]);
    o = 4;
  }
  nxt = u.w[o];
  if constexpr (WIDE) {
    e.i = u.w[o + 1]; e.ldp = u.w[o + 2]; e.st = u.w[o + 3];
    e.mm = u.w[o + 4]; e.go = u.w[o + 5]; e.ge = u.w[o + 6];
    e.ins = u.w[o + 7]; e.del = u.w[o + 8];
  } else {
    const uint32_t a = u.w[o + 1], b = u.w[o + 2], c = u.w[o + 3];
    e.i = a & 1023; e.ldp = (a >> 10) & 1023; e.st = (a >> 20) & 3;
    e.mm = b & 255; e.go = (b >> 8) & 255; e.ge = (b >> 16) & 255;
    e.ins = c & 0xffff; e.del = c >> 16;
  }
}

template <typename C, bool WIDE>
__device__ __forceinline__ void store_rec(uint4 *pool, int s,
                                          const Ent<C> &e, int nxt) {
  constexpr int V = Rec<C, WIDE>::VECS;
  union {
    uint4 v[V];
    int32_t w[4 * V];
  } u;
#pragma unroll
  for (int j = 0; j < 4 * V; ++j) u.w[j] = 0;
  int o;
  if constexpr (sizeof(C) == 4) {
    u.w[0] = (int32_t)e.k;
    u.w[1] = (int32_t)e.l;
    o = 2;
  } else {
    u.w[0] = (int32_t)(uint32_t)(uint64_t)e.k;
    u.w[1] = (int32_t)(uint32_t)((uint64_t)e.k >> 32);
    u.w[2] = (int32_t)(uint32_t)(uint64_t)e.l;
    u.w[3] = (int32_t)(uint32_t)((uint64_t)e.l >> 32);
    o = 4;
  }
  u.w[o] = nxt;
  if constexpr (WIDE) {
    u.w[o + 1] = e.i; u.w[o + 2] = e.ldp; u.w[o + 3] = e.st;
    u.w[o + 4] = e.mm; u.w[o + 5] = e.go; u.w[o + 6] = e.ge;
    u.w[o + 7] = e.ins; u.w[o + 8] = e.del;
  } else {
    u.w[o + 1] = e.i | e.ldp << 10 | e.st << 20;
    u.w[o + 2] = e.mm | e.go << 8 | e.ge << 16;
    u.w[o + 3] = e.ins | e.del << 16;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) pool[(size_t)s * V + j] = u.v[j];
}

// An entry held in registers across steps (the next pop, the walk's
// start): packed as in a compact record, or whole in the wide variant
template <typename C, bool WIDE>
struct Held {
  Ent<C> e;
  __device__ __forceinline__ void set(const Ent<C> &x) { e = x; }
  __device__ __forceinline__ Ent<C> get() const { return e; }
};

template <typename C>
struct Held<C, false> {
  C k, l;
  uint32_t a, b, c;
  __device__ __forceinline__ void set(const Ent<C> &x) {
    k = x.k;
    l = x.l;
    a = x.i | x.ldp << 10 | x.st << 20;
    b = x.mm | x.go << 8 | x.ge << 16;
    c = x.ins | x.del << 16;
  }
  __device__ __forceinline__ Ent<C> get() const {
    return Ent<C>{k, l, (int)(a & 1023), (int)(b & 255),
                  (int)((b >> 8) & 255), (int)((b >> 16) & 255),
                  (int)(c & 0xffff), (int)(c >> 16), (int)((a >> 20) & 3),
                  (int)((a >> 10) & 1023)};
  }
};

// The non-empty score lists.  Compact: a bitmap in registers (nb <= 128);
// wide: in global memory, written by the group's thread 0.
template <bool WIDE>
struct Lists {
  uint32_t w[NBW];
  __device__ __forceinline__ void reset(int, bool) {
#pragma unroll
    for (int j = 0; j < NBW; ++j) w[j] = 0;
  }
  __device__ __forceinline__ void set(int s, bool) {
#pragma unroll
    for (int j = 0; j < NBW; ++j)
      w[j] |= j == (s >> 5) ? 1u << (s & 31) : 0u;
  }
  __device__ __forceinline__ bool has(int s) const {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < NBW; ++j) x |= j == (s >> 5) ? w[j] : 0u;
    return (x >> (s & 31)) & 1;
  }
  // clear list s; return the lowest non-empty list (nb if none)
  __device__ __forceinline__ int clear_first(int s, int nb, bool) {
    int lo = nb;
#pragma unroll
    for (int j = NBW - 1; j >= 0; --j) {
      w[j] &= j == (s >> 5) ? ~(1u << (s & 31)) : FULL;
      if (w[j]) lo = 32 * j + __ffs(w[j]) - 1;
    }
    return lo;
  }
};

template <>
struct Lists<true> {
  uint32_t *w;
  int nw;
  __device__ __forceinline__ void reset(int nb, bool writer) {
    nw = (nb + 31) >> 5;
    if (writer)
      for (int j = 0; j < nw; ++j) w[j] = 0;
  }
  __device__ __forceinline__ void set(int s, bool writer) {
    if (writer) w[s >> 5] |= 1u << (s & 31);
  }
  __device__ __forceinline__ bool has(int s) const {
    return (w[s >> 5] >> (s & 31)) & 1;
  }
  __device__ __forceinline__ int clear_first(int s, int nb, bool writer) {
    uint32_t x = w[s >> 5] & ~(1u << (s & 31));
    if (writer) w[s >> 5] = x;
    x &= FULL << (s & 31);
    for (int j = s >> 5;;) {
      if (x) return 32 * j + __ffs(x) - 1;
      if (++j >= nw) return nb;
      x = w[j];
    }
  }
};

template <typename C>
struct GapArgs {
  Fm<C> f;
  const uint8_t *q;  // [B, L] complemented read codes
  int B, L;
  const int32_t *qlen, *md, *mg;
  const uint8_t *seed_en, *active;
  const C *sb;  // [B, SL, 2] seed-region widths
  int SL;
  C *wb;  // [B, L, 2] widths; the wide variant rewrites them (gap_shadow)
  int s_mm, s_gapo, s_gape, max_gape, max_seed_diff, max_entries,
      max_del_occ, ies, max_top2, seed_len, max_steps;
  int cap, cap_a, nb, G;
  bool gape, nonstop, loggap, use_seed;
  int32_t *heads;   // wide: [B, nb] the newest slot of each score list
  uint32_t *bits;   // wide: [B, (nb + 31) / 32] the non-empty lists
  uint4 *pool;      // [B, cap] records
  int32_t *aln_m;   // [B, cap_a, 6] mm, go, ge, score, ins, del
  C *aln_kl;        // [B, cap_a, 2]
  int32_t *n_aln, *n_stk, *done_step, *n_occ, *n_walk;
  int32_t *steps;   // [2]: the longest lane's steps, the next lane
  uint8_t *ovf;
  int lane_smem;    // shared memory bytes a lane
};

// aln_score's int_log2 (bwtgap.c:99-107)
__device__ __forceinline__ int ilog2(uint32_t v) {
  int c = 0;
  if (v & 0xffff0000u) { v >>= 16; c |= 16; }
  if (v & 0xff00u) { v >>= 8; c |= 8; }
  if (v & 0xf0u) { v >>= 4; c |= 4; }
  if (v & 0xcu) { v >>= 2; c |= 2; }
  if (v & 0x2u) c |= 1;
  return c;
}

// Bytes of shared memory a lane: the list heads (compact) and the
// free-slot stack
__host__ __device__ inline int lane_smem_bytes(bool wide, int nb) {
  return ((wide ? 0 : nb * 4) + FS * 4 + 15) & ~15;
}

// Loads of the lane's own tables (the width table is rewritten by
// gap_shadow, so not through the read-only path), beside the lookup's: a
// (width, bid) pair, one 8- or 16-byte load, and a code
__device__ __forceinline__ void ld_pair(const int32_t *p, int32_t &w,
                                        int &bid) {
  asm volatile("ld.global.v2.b32 {%0, %1}, [%2];"
               : "=r"(w), "=r"(bid)
               : "l"(p));
}
__device__ __forceinline__ void ld_pair(const int64_t *p, int64_t &w,
                                        int &bid) {
  int64_t b64;
  asm volatile("ld.global.v2.b64 {%0, %1}, [%2];"
               : "=l"(w), "=l"(b64)
               : "l"(p));
  bid = (int)b64;
}
__device__ __forceinline__ int ld_now(const uint8_t *p) {
  uint32_t r;
  asm volatile("ld.global.u8 %0, [%1];" : "=r"(r) : "l"(p));
  return (int)r;
}

// the class of push candidate c: 0 (insertion), 1 (deletions 1-4), 2
// (substitutions j = 1..3 at 5-7), 3 (j = 4 at 8), and each class's bits
__device__ __forceinline__ int cls_of(int c) {
  return c == 0 ? 0 : c <= 4 ? 1 : c <= 7 ? 2 : 3;
}
__device__ __forceinline__ unsigned cls_bits(int k) {
  return k == 0 ? 1u : k == 1 ? 0x1eu : k == 2 ? 0xe0u : 0x100u;
}

template <typename C, bool WIDE>
__global__ void __launch_bounds__(K_THREADS, 16)
    gap_machine_kernel(GapArgs<C> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = a.G;
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const unsigned gm = group_mask(lane, G);
  const bool w0 = gl == 0;  // the group's writer of shared state
  unsigned own = 0;  // the push candidates this thread writes: c mod G
  for (int c = gl; c < 9; c += G) own |= 1u << c;
  const Fm<C> &f = a.f;
  C L2[5];
  load_L2(f, L2);
  const int L = a.L, cap = a.cap, cap_a = a.cap_a, nb = a.nb, SL = a.SL;
  const int s_mm = a.s_mm, s_gapo = a.s_gapo, s_gape = a.s_gape;
  const int max_gape = a.max_gape;
  const bool GAPE = a.gape, NONSTOP = a.nonstop, LOGGAP = a.loggap;
  const bool SEED = a.use_seed;
  // this group's shared memory: the list heads (compact), the free slots
  int32_t *heads = reinterpret_cast<int32_t *>(
      smem_raw + (size_t)(threadIdx.x / G) * a.lane_smem);
  int32_t *fs = heads + (WIDE ? 0 : nb);

  // the lane's state (the same in every thread of the group)
  int b = -1, phase = P_DONE, steps = 0;
  int qlen = 0, md = 0, mg = 0;
  bool seed_en = false;
  int n_stk = 0, seqc = 1, lo = 0, ft = 0, hw = 0, gfree = -1;
  Lists<WIDE> lists;
  bool have_next = false;  // the next pop, kept in registers
  Held<C, WIDE> nx;
  int best_score = 0, mdc = 0;
  C wk = 0, wl = 0;
  int wi = 0;
  Held<C, WIDE> wm;  // the entry the walk started from
  C best_cnt = 0;
  int n_aln = 0, done_step = 0, n_occ = 0, n_walk = 0;
  bool ovf = false;
  int32_t *am = nullptr;
  C *akl = nullptr, *wb = nullptr;
  const C *sb = nullptr;
  const uint8_t *q = nullptr;
  uint4 *pool = nullptr;

  // hit bookkeeping (bwtgap.c:150-176); returns true when the lane stops
  auto hit = [&](int hsc, int hmm, int hgo, int hge, int hins, int hdel,
                 int hldp, C hk, C hl) -> bool {
    if (n_aln == 0) {
      best_score = hsc;
      if (!NONSTOP) {
        const int bd = hmm + hgo + (GAPE ? hge : 0) + 1;
        mdc = md < bd ? md : bd;
      }
    }
    const bool same_best = hsc == best_score;
    const bool brk2 = !same_best && best_cnt > (C)a.max_top2;
    if (same_best)  // wraps like the plain version's coordinate dtype
      best_cnt = (C)((unsigned long long)best_cnt +
                     (unsigned long long)(hl - hk + 1));
    bool dup = false;  // tandem-repeat duplicate (bwtgap.c:166-169)
    if (hgo > 0) {
      const int na = n_aln < cap_a ? n_aln : cap_a;
      for (int s = gl; s < na; s += G)
        dup |= akl[2 * s] == hk && akl[2 * s + 1] == hl;
      dup = __any_sync(gm, dup);
    }
    if (!brk2 && !dup) {
      // gap_shadow (bwtgap.c:86-96) over width[0:ldp], G positions a round;
      // a position's rank among the equal widths from a ballot
      const C x = hl - hk + 1;
      C jj = 0;
      const int tn = hldp < L ? hldp : L;
      const unsigned below = gm & ((1u << lane) - 1);
      for (int t0 = 0; t0 < tn; t0 += G) {
        const int t = t0 + gl;
        const bool in = t < tn;
        const C w = in ? wb[2 * t] : (C)0;
        const bool eq = in && w == x;
        const unsigned bal = __ballot_sync(gm, eq);
        if (eq) {
          wb[2 * t] = f.seq_len - (jj + (C)__popc(bal & below) + 1);
          wb[2 * t + 1] = 1;
        } else if (in && w > x) {
          wb[2 * t] = w - x;
        }
        jj += (C)__popc(bal);
      }
      // the last slot is overwritten once full; n_aln keeps counting
      const int slot = n_aln < cap_a - 1 ? n_aln : cap_a - 1;
      if (w0) {
        int32_t *r = am + 6 * slot;
        r[0] = hmm; r[1] = hgo; r[2] = hge; r[3] = hsc; r[4] = hins;
        r[5] = hdel;
        akl[2 * slot] = hk;
        akl[2 * slot + 1] = hl;
      }
      __syncwarp(gm);
      if (n_aln >= cap_a) ovf = true;
      ++n_aln;
    }
    return brk2 || ovf;
  };

  for (;;) {
    if (phase == P_DONE || steps >= a.max_steps) {
      // the lane's outputs (lanes stopped by max_steps: results incomplete
      // -> host fallback), then the next lane
      if (b >= 0 && w0) {
        a.ovf[b] = (ovf || phase != P_DONE) ? 1 : 0;
        a.n_aln[b] = n_aln;
        a.n_stk[b] = n_stk;
        a.done_step[b] = done_step;
        a.n_occ[b] = n_occ;
        a.n_walk[b] = n_walk;
        atomicMax(a.steps, steps);
      }
      int nb_ = 0;
      if (w0) nb_ = atomicAdd(a.steps + 1, 1);
      b = __shfl_sync(gm, nb_, lane & ~(G - 1));
      if (b >= a.B) break;
      qlen = a.qlen[b];
      md = a.md[b];
      mg = a.mg[b];
      seed_en = a.seed_en[b] != 0;
      am = a.aln_m + (size_t)b * cap_a * 6;
      akl = a.aln_kl + (size_t)b * cap_a * 2;
      wb = a.wb + (size_t)b * L * 2;
      sb = a.sb + (size_t)b * SL * 2;
      q = a.q + (size_t)b * L;
      pool = a.pool + (size_t)b * cap * Rec<C, WIDE>::VECS;
      if constexpr (WIDE) {
        heads = a.heads + (size_t)b * nb;
        lists.w = a.bits + (size_t)b * ((nb + 31) >> 5);
      }
      lists.reset(nb, w0);
      __syncwarp(gm);
      n_stk = 0; seqc = 1; lo = nb; ft = 0; hw = 0; gfree = -1;
      steps = 0; n_aln = 0; done_step = 0; n_occ = 0; n_walk = 0;
      ovf = false;
      best_cnt = 0; wk = wl = 0; wi = 0;
      best_score =
          (md + 1) * s_mm + (mg + 1) * s_gapo + (max_gape + 1) * s_gape;
      mdc = md;
      have_next = false;
      phase = P_DONE;
      if (a.active[b]) {  // one (i=len, k=0, l=seq_len, STATE_M) entry
        nx.set(Ent<C>{0, f.seq_len, qlen, 0, 0, 0, 0, 0, ST_M, 0});
        have_next = true;
        n_stk = 1;
        phase = P_RUN;
      }
      continue;
    }

    bool done = false;
    int next = phase;
    const bool walk = phase == P_WALK;
    int fslot = -1;  // the slot this step's pop freed
    Ent<C> e = {};
    if (!walk) {
      if (n_stk > a.max_entries || n_stk == 0) {
        done = true;  // the stack-size stop (bwtgap.c:143) or empty stack
      } else {
        // pop: lowest score, most recently pushed
        if (have_next) {
          e = nx.get();
          have_next = false;
        } else {
          const int sel = heads[lo];
          int nxt;
          load_rec<C, WIDE>(pool, sel, e, nxt);
          __syncwarp(gm);
          if (w0) heads[lo] = nxt;
          if (nxt < 0) lo = lists.clear_first(lo, nb, w0);
          __syncwarp(gm);
          fslot = sel;
        }
        --n_stk;
      }
    }
    if (!done) {
      // the step's one occ4 pair (the walk's next base, or the popped
      // entry's expansion), its loads issued with those of the codes and
      // the width tables the step reads; a pop that neither walks nor
      // expands discards the lookup
      const int i2 = e.i - 1;
      const int p1 = clampi(e.i - 1, 0, L - 1), p0 = clampi(e.i - 2, 0, L - 1);
      const int ii = i2 - (qlen - a.seed_len);
      const int s0 = clampi(ii - 1, 0, SL - 1), s1 = clampi(ii, 0, SL - 1);
      C ww0 = 0, ww1 = 0, sw0 = 0, sw1 = 0;
      int wbid0 = 0, wbid1 = 0, sbid0 = 0, sbid1 = 0;
      const int qc = ld_now(q + clampi(walk ? wi - 1 : i2, 0, L - 1));
      if (!walk) {
        ld_pair(wb + 2 * p0, ww0, wbid0);
        ld_pair(wb + 2 * p1, ww1, wbid1);
        if (SEED) {
          ld_pair(sb + 2 * s0, sw0, sbid0);
          ld_pair(sb + 2 * s1, sw1, sbid1);
        }
      }
      C ok[4], ol[4], kk4[4], ll4[4];
      occ4_pair(f, L2, walk ? wk - 1 : e.k - 1, walk ? wl : e.l, gl, G, gm,
                ok, ol);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kk4[c] = L2[c] + ok[c] + 1;
        ll4[c] = L2[c] + ol[c];
      }
      if (walk) {
        // one character of bwt_match_exact_alt (bwt.c:241-256)
        ++n_occ;
        ++n_walk;
        const int j = wi - 1;
        next = P_RUN;
        if (qc <= 3) {
          const C wkn = pick(kk4, qc), wln = pick(ll4, qc);
          if (wkn <= wln) {
            wk = wkn;
            wl = wln;
            wi = j;
            if (j == 0) {
              const Ent<C> h = wm.get();
              done = hit(h.mm * s_mm + h.go * s_gapo + h.ge * s_gape, h.mm,
                         h.go, h.ge, h.ins, h.del, h.ldp, wk, wl);
            } else {
              next = P_WALK;
            }
          }
        }
      } else {
        const int score = e.mm * s_mm + e.go * s_gapo + e.ge * s_gape;
        const int used = e.mm + e.go + (GAPE ? e.ge : 0);
        const int m = mdc - used;
        if (!NONSTOP && score > best_score + s_mm) {
          done = true;  // the best-first stop (bwtgap.c:146)
        } else if (m < 0 || (e.i > 0 && m < wbid1)) {
          // too many differences for what is left of the read
        } else if (e.i == 0) {
          done = hit(score, e.mm, e.go, e.ge, e.ins, e.del, e.ldp, e.k, e.l);
        } else if (m == 0 && (GAPE || e.st == ST_M || e.ge == max_gape)) {
          wk = e.k;  // the exact-match walk starts next step
          wl = e.l;
          wi = e.i;
          wm.set(e);
          next = P_WALK;
        } else {
          // expansion (bwtgap.c:178-253)
          ++n_occ;
          const C occv = e.l - e.k + 1;
          const bool in_band = i2 > 0;
          const bool w_block = in_band && wbid0 > m - 1;
          bool allow_diff = !w_block;
          bool allow_M = !(in_band && !w_block && wbid0 == m - 1 &&
                           wbid1 == m - 1 && ww0 == ww1);
          if (SEED) {
            const int m_seed = a.max_seed_diff - used;
            const bool sgate = seed_en && in_band && ii > 0;
            const bool s_block = sgate && sbid0 > m_seed - 1;
            allow_diff = allow_diff && !s_block;
            allow_M = allow_M && !(sgate && !s_block && sbid0 == m_seed - 1 &&
                                   sbid1 == m_seed - 1 && sw0 == sw1);
          }
          const int tmp = LOGGAP ? ilog2((uint32_t)(e.ge + e.go)) / 2 + 1
                                 : e.go + e.ge;
          const bool ggate = allow_diff && i2 >= a.ies + tmp &&
                             qlen - i2 >= a.ies + tmp;
          const bool stM = e.st == ST_M, stI = e.st == ST_I;
          const bool stD = e.st == ST_D;
          const bool dM = stM && e.go < mg;
          const bool dD = stD && e.ge < max_gape &&
                          (e.ge + e.go < mdc || occv < (C)a.max_del_occ);
          const bool both = allow_diff && allow_M;
          // the candidates in the reference's push order: 0 an M-state gap
          // open (insertion) or I-state extension; 1-4 deletions by base;
          // 5-8 substitutions j = 1..4 (bwtgap.c:232-246; when allow_M is
          // off but the exact char exists, only the j = 4 match push, the
          // elif at bwtgap.c:247-253); a score a class of them
          int scc[4];
          scc[0] = e.mm * s_mm + (e.go + stM) * s_gapo +
                   (e.ge + stI) * s_gape;
          scc[1] = e.mm * s_mm + (e.go + dM) * s_gapo + (e.ge + dD) * s_gape;
          scc[2] = (e.mm + 1) * s_mm + e.go * s_gapo + e.ge * s_gape;
          scc[3] = qc > 3 ? scc[2] : score;
          unsigned vm = ggate && ((stM && e.go < mg) ||
                                  (stI && e.ge < max_gape)) ? 1u : 0u;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            vm |= ggate && (dM || dD) && kk4[c] <= ll4[c] ? 2u << c : 0u;
#pragma unroll
          for (int jv = 1; jv <= 4; ++jv) {
            const int cj = (qc + jv) & 3;
            vm |= pick(kk4, cj) <= pick(ll4, cj) &&
                          (both || (jv == 4 && qc < 4))
                      ? 1u << (4 + jv) : 0u;
          }
          // the push plan, the same in every thread: the first nfree valid
          // children are pushed; the newest on the list just popped is the
          // next pop, the others take slots
          const int base = n_stk, nfree = cap - n_stk;
          const int n_push = __popc(vm);
          unsigned pm = vm;
          for (int c = 8; c >= 0 && __popc(pm) > nfree; --c)
            pm &= ~(1u << c);
          int bkc[4], max_sc = 0;
          bool off_lists = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            bkc[k] = scc[k] < 0 ? 0 : (scc[k] < nb ? scc[k] : nb - 1);
            if (vm & cls_bits(k)) {
              // past the lists only with ovf set (SCORE_CAP), or never
              max_sc = scc[k] > max_sc ? scc[k] : max_sc;
              off_lists |= scc[k] < 0 || (scc[k] >= nb && scc[k] < SCORE_CAP);
            }
          }
          unsigned same_bk[4];  // the children whose list is class k's
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            same_bk[k] = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              same_bk[k] |= bkc[j] == bkc[k] ? cls_bits(j) : 0u;
          }
          // the list just popped (its score's) holds the next pop
          const int bkp = score;
          unsigned on_p = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            on_p |= bkc[k] == bkp ? cls_bits(k) : 0u;
          on_p &= pm;
          const int cc = on_p ? 31 - __clz(on_p) : -1;
          const unsigned sm = cc >= 0 ? pm & ~(1u << cc) : pm;
          const int n_st = __popc(sm);
          auto child = [&](int c) -> Ent<C> {
            const bool in_mm = c >= 5 && (c < 8 || qc > 3);
            const int cj = c <= 4 ? c - 1 : (qc + c - 4) & 3;
            Ent<C> ce;
            ce.k = c == 0 ? e.k : pick(kk4, cj);
            ce.l = c == 0 ? e.l : pick(ll4, cj);
            ce.i = c >= 1 && c <= 4 ? e.i : i2;
            ce.mm = e.mm + (in_mm ? 1 : 0);
            ce.go = c == 0 ? e.go + stM : c <= 4 ? e.go + dM : e.go;
            ce.ge = c == 0 ? e.ge + stI : c <= 4 ? e.ge + dD : e.ge;
            ce.ins = e.ins + (c == 0 ? 1 : 0);
            ce.del = e.del + (c >= 1 && c <= 4 ? 1 : 0);
            ce.st = c == 0 ? ST_I : c <= 4 ? ST_D : ST_M;
            ce.ldp = c <= 4 || in_mm ? ce.i : 0;
            return ce;
          };
          if (cc >= 0) nx.set(child(cc));
          if (n_st) {
            // slots: the one just freed, the free-slot stack, the
            // high-water mark, then chunks of the pool's free list
            const int have_f = fslot >= 0 ? 1 : 0;
            while (have_f + ft + (cap - hw) < n_st) {
              const int4 *ch = reinterpret_cast<const int4 *>(
                  pool + (size_t)gfree * Rec<C, WIDE>::VECS);
              const int4 c0 = ch[0], c1 = ch[1];
              __syncwarp(gm);
              if (w0) {
                fs[ft] = c0.x; fs[ft + 1] = c0.y; fs[ft + 2] = c0.z;
                fs[ft + 3] = c0.w; fs[ft + 4] = c1.x; fs[ft + 5] = c1.y;
                fs[ft + 6] = c1.z; fs[ft + 7] = gfree;
              }
              __syncwarp(gm);
              ft += CHUNK + 1;
              gfree = c1.w;
            }
            // the r-th child that takes a slot takes slot_of(r)
            auto slot_of = [&](int r) -> int {
              const int r2 = r - have_f;
              return r2 < 0 ? fslot : r2 < ft ? fs[ft - 1 - r2]
                                              : hw + r2 - ft;
            };
            // each class's list head, read before any write of this step
            int hd[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              hd[k] = (sm & same_bk[k]) && lists.has(bkc[k]) ? heads[bkc[k]]
                                                             : -1;
            __syncwarp(gm);
            // child c by thread c mod G: its slot, its link (the previous
            // child on its list, or the list's head), its record, and the
            // list's head when it is the list's newest
            for (unsigned rest = sm & own; rest; rest &= rest - 1) {
              const int c = __ffs(rest) - 1;
              const int k = cls_of(c);
              const unsigned same = pick(same_bk, k);
              const unsigned below = sm & ((1u << c) - 1);
              const int sl = slot_of(__popc(below));
              const unsigned prev = below & same;
              const int lk =
                  prev ? slot_of(__popc(sm & ((1u << (31 - __clz(prev))) - 1)))
                       : pick(hd, k);
              store_rec<C, WIDE>(pool, sl, child(c), lk);
              if (!(sm & same & ~((2u << c) - 1))) heads[pick(bkc, k)] = sl;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (sm & cls_bits(k)) {
                lists.set(bkc[k], w0);
                lo = bkc[k] < lo ? bkc[k] : lo;
              }
            const int used_f = n_st < have_f ? n_st : have_f;
            const int from_fs = n_st - used_f < ft ? n_st - used_f : ft;
            hw += n_st - used_f - from_fs;
            ft -= from_fs;
            if (used_f) fslot = -1;
          }
          have_next = cc >= 0;
          if (max_sc >= SCORE_CAP || seqc + n_push >= SEQ_CAP ||
              n_push > nfree || off_lists)
            ovf = true;
          seqc += n_push;
          n_stk = base + (n_push < nfree ? n_push : nfree);
          done = ovf;
        }
      }
      __syncwarp(gm);
    }
    if (fslot >= 0) {  // the popped slot, not taken by a child
      if (ft < FS) {
        if (w0) fs[ft] = fslot;
        ++ft;
      } else {  // spill 7 of the stack into it, onto the chunk list
        if (w0) {
          int4 *ch = reinterpret_cast<int4 *>(
              pool + (size_t)fslot * Rec<C, WIDE>::VECS);
          ch[0] = make_int4(fs[ft - 7], fs[ft - 6], fs[ft - 5], fs[ft - 4]);
          ch[1] = make_int4(fs[ft - 3], fs[ft - 2], fs[ft - 1], gfree);
        }
        ft -= CHUNK;
        gfree = fslot;
      }
      __syncwarp(gm);
    }
    ++steps;
    if (done) {
      phase = P_DONE;
      done_step = steps;
    } else {
      phase = next;
    }
  }
}

template <typename C, bool WIDE>
int launch_gap(const GapArgs<C> &a, cudaStream_t stream) {
  auto kern = gap_machine_kernel<C, WIDE>;
  const int lanes_blk = K_THREADS / a.G;
  const int smem = lanes_blk * a.lane_smem;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, K_THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (a.B + lanes_blk - 1) / lanes_blk;
  const int grid = need < per_sm * n_sm ? need : per_sm * n_sm;
  kern<<<grid, K_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename C>
Fm<C> make_fm(const uint32_t *occtab, int nw, const int64_t *L2,
              int64_t primary, int64_t seq_len) {
  return Fm<C>{occtab, nw, nw == 8 ? 0 : 2, L2, (C)primary, (C)seq_len};
}

template <typename C>
int gap_launch(const Fm<C> &fm, const uint8_t *q, int B, int L,
               const int32_t *qlen, const int32_t *md, const int32_t *mg,
               const uint8_t *seed_en, const void *sb, int SL, void *wb,
               const uint8_t *active, const int32_t *scal, int max_steps,
               int cap, int cap_a, int nb, int flags, int wide,
               int32_t *heads, uint32_t *bits, void *pool, int32_t *aln_m,
               void *aln_kl, int32_t *n_aln, int32_t *n_stk,
               int32_t *done_step, int32_t *n_occ, int32_t *n_walk,
               uint8_t *ovf, int32_t *steps, cudaStream_t s) {
  GapArgs<C> a{fm, q, B, L, qlen, md, mg, seed_en, active,
               (const C *)sb, SL, (C *)wb,
               scal[0], scal[1], scal[2], scal[3], scal[4], scal[5],
               scal[6], scal[7], scal[8], scal[9], max_steps,
               cap, cap_a, nb, fm.nw / 4,
               (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0,
               (flags & 8) != 0,
               heads, bits, (uint4 *)pool, aln_m, (C *)aln_kl,
               n_aln, n_stk, done_step, n_occ, n_walk, steps, ovf,
               lane_smem_bytes(wide != 0, nb)};
  if (!wide && (L > PACK_L || nb > 32 * NBW || scal[3] > PACK_D))
    return (int)cudaErrorInvalidValue;
  return wide ? launch_gap<C, true>(a, s) : launch_gap<C, false>(a, s);
}

}  // namespace

// K7w: widths [B, L, 2] of the codes q [B, L], 2R threads a read
extern "C" int bwa_cal_width(int coord64, const uint32_t *occtab, int nw,
                             const int64_t *L2, int64_t primary,
                             int64_t seq_len, const uint8_t *q, int B, int L,
                             void *out, void *stream) {
  if (nw != 8 && nw != 32) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return 0;
  const int G = nw / 4;
  const int grid = (int)(((int64_t)B * G + W_THREADS - 1) / W_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (coord64)
    cal_width_kernel<int64_t><<<grid, W_THREADS, 0, s>>>(
        make_fm<int64_t>(occtab, nw, L2, primary, seq_len), q, B, L,
        (int64_t *)out, G);
  else
    cal_width_kernel<int32_t><<<grid, W_THREADS, 0, s>>>(
        make_fm<int32_t>(occtab, nw, L2, primary, seq_len), q, B, L,
        (int32_t *)out, G);
  return (int)cudaGetLastError();
}

// K7: flags = GAPE | NONSTOP << 1 | LOGGAP << 2 | use_seed << 3;
// scal = s_mm, s_gapo, s_gape, max_gape, max_seed_diff, max_entries,
// max_del_occ, indel_end_skip, max_top2, seed_len (host array); nb score
// lists; wide: the wide-record variant, with heads [B, nb] and bits
// [B, (nb + 31) / 32] (else unused); pool [B, cap] records of 32 bytes
// (wide: 48 or 64); n_occ [B]: each lane's steps that read an occ4 pair,
// n_walk [B]: those of them that walk (one base's count at two ends is
// all the walk needs; a bound counts both); steps [2] zeroed: the longest lane's steps and
// the lane counter of the persistent grid
extern "C" int bwa_gap_machine(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *md, const int32_t *mg,
    const uint8_t *seed_en, const void *sb, int SL, void *wb,
    const uint8_t *active, const int32_t *scal, int max_steps, int cap,
    int cap_a, int nb, int flags, int wide, int32_t *heads, uint32_t *bits,
    void *pool, int32_t *aln_m, void *aln_kl, int32_t *n_aln, int32_t *n_stk,
    int32_t *done_step, int32_t *n_occ, int32_t *n_walk, uint8_t *ovf,
    int32_t *steps, void *stream) {
  if (nw != 8 && nw != 32) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (cap < 1 || cap_a < 1 || nb < 1 || L < 1 || SL < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (coord64)
    return gap_launch(make_fm<int64_t>(occtab, nw, L2, primary, seq_len), q,
                      B, L, qlen, md, mg, seed_en, sb, SL, wb, active, scal,
                      max_steps, cap, cap_a, nb, flags, wide, heads, bits,
                      pool, aln_m, aln_kl, n_aln, n_stk, done_step, n_occ,
                      n_walk, ovf, steps, s);
  return gap_launch(make_fm<int32_t>(occtab, nw, L2, primary, seq_len), q, B,
                    L, qlen, md, mg, seed_en, sb, SL, wb, active, scal,
                    max_steps, cap, cap_a, nb, flags, wide, heads, bits,
                    pool, aln_m, aln_kl, n_aln, n_stk, done_step, n_occ,
                    n_walk, ovf, steps, s);
}
