// The banded ksw_extend2 device code shared by kernel K2 (ksw_band.cu: the
// mem extension passes and extend_band_pallas) and kernel K5 (ksw_full.cu:
// extend_batch_pallas).  One extension problem is swept in band-relative
// coordinates p = j - (i - W), W = P/2 - 1: the band of P slots slides one
// query column right per target row i, so every cell the recurrence may
// write in row i (columns i - w .. i + w + 1, w <= W) is a slot.
//
// Per target row i (the plain version is ops/ksw_band.py::sweep_row):
//   * the band slides one column right: the slot leaving on the left never
//     re-enters the band (its lower end max(beg, i - w) never decreases),
//     and the column entering on the right, i + W + 1, holds its first-row
//     eh init (ksw.c:445-449): no row has written it yet;
//   * the diagonal H(i-1, j-1) is the slot's own H, E(i-1, j) the slot's
//     own E, and F is an in-row prefix max of max(M - oe_ins, 0) +
//     j*e_ins;
//   * the row max with its largest column (ties go to the larger column)
//     feeds z-drop, and the first/last non-zero cells set the adaptive
//     band of the next row; the eh[end] end cell takes h_last;
//   * when beg > 0 the band's first cell gets NEG (H of the column left of
//     it, out of band), not ksw_extend2's 0: the next row comes out the
//     same, and the plain versions hold the kernels to it.
// A problem stops at the first row where it is done (row max 0 or z-drop):
// nothing after that row can change an output.  Query codes come from a
// flat code array (read coordinates and a direction, or host-built rows),
// target codes from the 2-bit .pac (reverse complement on the reverse
// half, bns_get_seq, bntseq.c:403-424) or from host-built rows; positions
// are int64.
//
// Two layouts:
//
// Warp path, P <= 1024: ksw_band_warp, one warp per problem, four problems
// a 128-thread block.  Lane l owns S = P/32 (rounded up to a multiple of
// 4) consecutive slots, pad = 32*S - P dead slots at the front of lane 0
// (their columns lie left of every band).  H, E and the query codes (four
// a register) stay in registers, and a row has no block barrier, only
// warp primitives (ops/ksw_band.py::warp_row is the same arithmetic in
// plain PyTorch):
//   * slide (every row, row 0 included: the band starts one column to
//     the left): the lane's registers shift by one, three
//     __shfl_down_sync bring slot 0 of the next lane;
//   * F: a max-scan over the lane's own slots and an exclusive prefix max
//     of the lane totals (five __shfl_up_sync steps);
//   * H(i, j-1) for the next row: the lane's registers, one
//     __shfl_up_sync for the slot below the lane;
//   * row max and its largest column: two __reduce_max_sync (REDUX);
//     h_last a third; the next band's first and last non-zero columns two
//     independent reductions over bit masks of the in-band cells, with
//     the eh[end_r] end cell added after them;
//   * the target code and the query code entering slot P-1 come from
//     32-row chunks loaded a chunk ahead, so no row waits on a global load.
// What bounds it: the rows of one problem form a chain, so a launch lasts
// as long as its longest problem's rows times the latency of one row
// (about 450 instructions at S = 8 behind a chain of shuffles and REDUX
// reductions); operations and bytes sit two orders of magnitude below.
// Registers (ptxas -v, sm_90a): 64 a thread at S = 4, 96 at S = 8, 127 at
// S = 12, 159 at S = 16, 196 at S = 20, 255 at S = 24 to 32; no spills.
//
// Wide path, any P > 1024 (a multiple of 32): ksw_band_wide, one block
// per problem.  The band lives in a ring of P slots, indexed by query
// column mod P, so the slide moves nothing: the slot that leaves takes the
// column that enters.  The ring (H and E as an int2 and the query code, 9
// bytes a slot) sits in dynamic shared memory up to WIDE_SMEM_BYTES (about
// 25,000 slots), above that in a per-problem global scratch band that the
// wrapper allocates (it stays in L2).  Thread t owns the S consecutive
// slots t*S .. t*S+S-1, S = ceil(P/NT) made odd, so the 32 lanes' strided
// ring accesses fall in 32 different banks; NT = 1024 when the launch has
// no more problems than the card has SMs, 512 above.  Target and entering
// query codes come in 32-row chunks a chunk ahead, as on the warp path.
// A row:
//   * pass 1: M over the thread's slots and its total of max(M - oe_ins,
//     0) + j*e_ins; a warp scan of the totals; the warp totals to shared
//     memory; barrier A; each warp's prefix from the warps below (one
//     REDUX);
//   * pass 2: F, H(i, j), E(i+1, j) and H(i, j-1) for the thread's slots
//     but its first (which needs the slot below, held by the thread
//     below); the thread's max with its largest column and h_last; warp
//     REDUX, the warp values and each warp's last H to shared memory;
//     barrier B; the row max, its largest column and h_last from the
//     warp values (REDUX); z-drop;
//   * the first slot's H(i, j-1) (a shuffle, or the warp below's last H),
//     the eh[end_r] end cell, the first and last non-zero cells: warp
//     REDUX, to shared memory; barrier C; the next row's band.
// Three block barriers a row; 57 registers (61 with the global ring), no
// spills.  What bounds it at P = 4480: not the slots' arithmetic (20
// operations a cell take 0.7 us a row on one SM) but each row's chain:
// with one problem an SM a row costs 2.4 us at P = 2304 and 3.3 us at
// P = 4480 on an H100 (bench_kernel.py, chip_smoke.py).  Every warp
// repeats the row's bookkeeping (the code chunk, the band ends, about 13
// REDUX, 7 shuffles, z-drop), and after each barrier the warps run the
// same dependent chain of reductions at once, so little of its latency is
// hidden.  More threads a block shorten the in-thread loops, fewer repeat
// less bookkeeping: 1024 threads beat 512 by 8% with 32-68 problems and
// lost 2-32% with 256; 256 and 128 threads were slower than 512 at all
// but one tested shape.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;        // problems (warps) a block on the warp path
constexpr int WIDE_NT = 1024;   // most threads a block on the wide path
// shared memory the wide path's ring may take; a wider ring goes to the
// global scratch band (ops/ksw_band.py::WIDE_SMEM_BYTES is the same)
constexpr int WIDE_SMEM_BYTES = 224 * 1024;

__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }

// first-row eh init (ksw.c:445-449) in closed form; col1: column 1 holds
// e1 whatever qlen (K5's rule, from bwa_tpu/ops/ksw_pallas.py::_mk_kernel;
// no output depends on it, since column 1 is in no band when qlen < 2)
__device__ __forceinline__ int eh_init(int j, int h0, int e1, int e_ins,
                                       int qlen, bool col1 = false) {
  if (col1 && j == 1) return e1;
  if (j < 0 || j > qlen) return 0;
  if (j == 0) return h0;
  if (j == 1) return e1;
  int fill = e1 - (j - 1) * e_ins;
  int prev = e1 - (j - 2) * e_ins;
  return prev > e_ins ? fill : 0;
}

struct BandArgs {
  const uint8_t *pac;     // 2-bit packed forward reference
  int64_t l_pac;
  const uint8_t *qflat;   // flat read codes of the batch
  int64_t nq;
  // host-array mode (ts != nullptr): problem r's query is qflat[r*q_stride
  // ...] forwards, its target ts[r*t_stride ...]; qbase/qdir/tbase/tdir
  // and the .pac are not read
  const uint8_t *ts;
  int64_t q_stride, t_stride;
  const int64_t *qbase, *tbase;
  const int32_t *qdir, *qlen, *tdir, *tlen, *w, *h0;
  int32_t *out;           // [n, 7]: score qle tle gtle gscore max_off rows
  int n, P, W;            // problems of this launch, band (the widest one
                          // when pw is set), W = P/2 - 1
  int mat[25];
  int o_del, e_del, o_ins, e_ins, zdrop;
  // warp or block k of the launch sweeps problem perm[k] (k without perm)
  const int32_t *perm;
  const int32_t *pw;      // wide path: each problem's own band (or P)
  int col1;               // eh_init's col1 rule (K5)
  uint8_t *scratch;       // wide path: the rings in global memory, one
  int64_t scratch_stride; // per block, scratch_stride bytes apart (or
                          // nullptr: the ring in shared memory)
};

__device__ __forceinline__ int q_at(const BandArgs &a, int64_t qb, int qd,
                                    int ql, int64_t jq) {
  if (jq < 0 || jq >= ql) return 4;
  int64_t idx = qb + (int64_t)qd * jq;
  idx = idx < 0 ? 0 : (idx > a.nq - 1 ? a.nq - 1 : idx);
  return a.qflat[idx];
}

// The raw loads of one row's codes, decoded later: the target byte t with
// how to decode it (tm = -1: t is the code; else the 2-bit shift in bits
// 0-2 and the reverse-complement flag in bit 3), and the query code q
// entering slot P-1.
struct RowLoad {
  int t, tm, q;
};

__device__ __forceinline__ RowLoad row_load(const BandArgs &a, bool arrays,
                                            int64_t qb, int qd, int qlen,
                                            int64_t tb, int td, int tlen,
                                            int r, int P, int W) {
  RowLoad x{4, -1, 4};
  if (r >= tlen) return x;
  if (arrays) {
    x.t = a.ts[tb + r];
  } else {
    const int64_t two_l = a.l_pac * 2;
    int64_t pc = tb + (int64_t)td * r;
    pc = pc < 0 ? 0 : (pc > two_l - 1 ? two_l - 1 : pc);
    const bool fwd = pc < a.l_pac;
    const int64_t f = fwd ? pc : two_l - 1 - pc;
    x.t = a.pac[f >> 2];
    x.tm = (int)(((~f) & 3) << 1) | (fwd ? 0 : 8);
  }
  x.q = q_at(a, qb, qd, qlen, (int64_t)r - W + P - 1);
  return x;
}

// target code in bits 0-7, entering query code in bits 8-15
__device__ __forceinline__ int row_codes(const RowLoad &x) {
  const int t = x.tm < 0 ? x.t
                         : (((x.t >> (x.tm & 7)) & 3) ^ (x.tm >> 3 ? 3 : 0));
  return t | (x.q << 8);
}

// A problem's coordinates and constants, as every path reads them.
struct Problem {
  int64_t qb, tb;
  int qd, td, qlen, tlen, w, h0, e1;
};

__device__ __forceinline__ Problem problem(const BandArgs &a, int prob,
                                           bool arrays) {
  Problem p;
  p.qb = arrays ? prob * a.q_stride : a.qbase[prob];
  p.tb = arrays ? prob * a.t_stride : a.tbase[prob];
  p.qd = arrays ? 1 : a.qdir[prob];
  p.td = arrays ? 1 : a.tdir[prob];
  p.qlen = a.qlen[prob];
  p.tlen = a.tlen[prob];
  p.w = a.w[prob];
  p.h0 = a.h0[prob];
  const int e1 = p.h0 - (a.o_ins + a.e_ins);
  p.e1 = e1 > 0 ? e1 : 0;
  return p;
}

// The scalar bookkeeping of ksw_extend2 after a row's reductions: gscore,
// the best cell, z-drop.  Returns true when the problem is done.
struct Track {
  int mx, mx_i, mx_j, mx_ie, gsc, mx_off;
};

__device__ __forceinline__ bool track_row(const BandArgs &a, Track &t, int i,
                                          int mrow, int mj, int h_last,
                                          bool at_end) {
  if (at_end && h_last >= t.gsc) {
    t.mx_ie = i;
    t.gsc = h_last;
  }
  const bool brk0 = mrow == 0;
  const bool imp = !brk0 && mrow > t.mx;
  if (imp) {
    t.mx_i = i;
    const int d = mj - i < 0 ? i - mj : mj - i;
    t.mx_off = t.mx_off > d ? t.mx_off : d;
    t.mx_j = mj;
  }
  bool brkz = false;
  if (!brk0 && !imp && a.zdrop > 0) {
    const int d_i = i - t.mx_i, d_j = mj - t.mx_j;
    if (d_i > d_j) brkz = t.mx - mrow - (d_i - d_j) * a.e_del > a.zdrop;
    else brkz = t.mx - mrow - (d_j - d_i) * a.e_ins > a.zdrop;
  }
  if (imp) t.mx = mrow;
  return brk0 || brkz;
}

__device__ __forceinline__ void write_out(const BandArgs &a, int prob,
                                          const Track &t, int rows) {
  int32_t *o = a.out + (int64_t)prob * 7;
  o[0] = t.mx;
  o[1] = t.mx_j + 1;
  o[2] = t.mx_i + 1;
  o[3] = t.mx_ie + 1;
  o[4] = t.gsc;
  o[5] = t.mx_off;
  o[6] = rows;  // target rows swept (work diagnostic)
}

template <int S>
__global__ void __launch_bounds__(32 * WARPS) ksw_band_warp(BandArgs a) {
  static_assert(S % 4 == 0 && S <= 32, "four query codes a register");
  constexpr int NQ = S / 4;
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = a.mat[threadIdx.x];
  __syncthreads();  // the only block barrier: before any row
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (k >= a.n) return;
  const int prob = a.perm ? a.perm[k] : k;
  const int P = a.P, W = a.W, pad = 32 * S - P;
  const bool arrays = a.ts != nullptr;
  const Problem pr = problem(a, prob, arrays);
  const int qlen = pr.qlen, tlen = pr.tlen, w = pr.w, h0 = pr.h0;
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int e_del = a.e_del, e_ins = a.e_ins, e1 = pr.e1;

  // the band as it stands before row 0's slide (column p - W - 1 at band
  // slot p), so that every row, row 0 included, starts with the same
  // slide; slot k of this lane is band slot lane*S + k - pad
  int H[S], E[S];
  uint32_t Q[NQ];
#pragma unroll
  for (int m = 0; m < NQ; ++m) Q[m] = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int p = lane * S + k - pad;
    H[k] = p >= 0 ? eh_init(p - W - 1, h0, e1, e_ins, qlen, a.col1) : 0;
    E[k] = 0;
    const int q = p >= 0 ? q_at(a, pr.qb, pr.qd, qlen, p - W - 1) : 4;
    Q[k >> 2] |= (uint32_t)q << (8 * (k & 3));
  }
  // codes of rows 0-31 now, of rows 32-63 in flight
  int cur = row_codes(row_load(a, arrays, pr.qb, pr.qd, qlen, pr.tb, pr.td,
                               tlen, lane, P, W));
  RowLoad nxt = row_load(a, arrays, pr.qb, pr.qd, qlen, pr.tb, pr.td, tlen,
                         32 + lane, P, W);
  Track tr{h0, -1, -1, -1, -1, 0};
  int beg = 0, end = qlen, rows = 0;

  for (int i = 0; i < tlen; ++i) {
    rows = i + 1;
    if (i > 0 && (i & 31) == 0) {  // next chunk: loaded 32 rows ago
      cur = row_codes(nxt);
      nxt = row_load(a, arrays, pr.qb, pr.qd, qlen, pr.tb, pr.td, tlen,
                     i + 32 + lane, P, W);
    }
    const int code = __shfl_sync(FULL, cur, i & 31);
    {  // slide the band one column right; slot P-1 takes column
       // j = i + W + 1 >= 2 with its first-row eh init (ksw.c:445-449)
      const int hin = __shfl_down_sync(FULL, H[0], 1);
      const int ein = __shfl_down_sync(FULL, E[0], 1);
      const uint32_t qin = __shfl_down_sync(FULL, Q[0], 1);
      const bool top = lane == 31;  // owns slot P-1
      const int j = i - W + P - 1;
      const int h_ent = j <= qlen && e1 - (j - 2) * e_ins > e_ins
          ? e1 - (j - 1) * e_ins : 0;
#pragma unroll
      for (int k = 0; k < S - 1; ++k) {
        H[k] = H[k + 1];
        E[k] = E[k + 1];
      }
#pragma unroll
      for (int m = 0; m < NQ - 1; ++m)
        Q[m] = __funnelshift_r(Q[m], Q[m + 1], 8);
      H[S - 1] = top ? h_ent : hin;
      E[S - 1] = top ? 0 : ein;
      Q[NQ - 1] = __funnelshift_r(Q[NQ - 1],
                                  top ? (uint32_t)(code >> 8) : qin, 8);
    }
    const int *ms = smat + (code & 0xff) * 5;
    const int beg_r = beg > i - w ? beg : i - w;
    int end_r = end < i + w + 1 ? end : i + w + 1;
    end_r = end_r < qlen ? end_r : qlen;
    int h1 = h0 - (a.o_del + e_del * (i + 1));
    h1 = h1 > 0 ? h1 : 0;
    const int h1_init = beg_r == 0 ? h1 : 0;
    const int base = lane * S - pad - W + i;  // column of the lane's slot 0

    // M and the lane total of max(M - oe_ins, 0) + j*e_ins
    int M[S];
    int tot = NEG;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int c = base + k;
      const bool inb = c >= beg_r && c < end_r;
      const int sc = ms[(Q[k >> 2] >> (8 * (k & 3))) & 0xff];
      M[k] = inb ? (H[k] != 0 ? H[k] + sc : 0) : NEG;
      // g unmasked: outside the band it is 0 (M is NEG), which yields
      // F <= 0 only, and a cell in band has H >= E >= 0
      tot = imax(tot, imax(M[k] - oe_ins, 0) + c * e_ins);
    }
    // exclusive prefix max of the lane totals (a lane below o reads its
    // own value, which leaves the max as it is)
    int v = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) v = imax(v, __shfl_up_sync(FULL, v, o));
    int run = __shfl_up_sync(FULL, v, 1);
    run = lane ? run : NEG;
    // F, H(i, j) (kept in M), E(i+1, j), the row max and h_last
    int mloc = NEG;
    uint32_t hl = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int c = base + k;
      const bool inb = c >= beg_r && c < end_r;
      const int F = c == beg_r ? 0 : run - (c - 1) * e_ins;
      run = imax(run, imax(M[k] - oe_ins, 0) + c * e_ins);
      const int hr = inb ? imax(imax(M[k], E[k]), F) : NEG;
      const int en = imax(E[k] - e_del, imax(M[k] - oe_del, 0));
      E[k] = inb ? en : E[k];
      M[k] = hr;
      mloc = imax(mloc, hr);
      hl |= c == end_r - 1 ? (uint32_t)hr : 0u;  // in band, so >= 0
    }
    // row max, then the largest column holding it: each lane finds the
    // largest of its columns holding its own max while the first
    // reduction runs, and offers it if its max is the row's
    int mrow = __reduce_max_sync(FULL, mloc);
    uint32_t eqm = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) eqm |= M[k] == mloc ? 1u << k : 0u;
    const int lcol = base + 31 - __clz(eqm);  // eqm != 0: mloc is an M[k]
    mrow = mrow > 0 ? mrow : 0;
    const int mjr = __reduce_max_sync(FULL, mloc == mrow ? lcol : -1);
    const int mj = mrow > 0 ? mjr : -1;
    const int hlr = __reduce_max_sync(FULL, (int)hl);
    const int h_last = end_r > beg_r ? hlr : h1_init;
    // the next row's H: H(i, j-1) in band (the slot below the lane's slot
    // 0 by a shuffle; below lane 0 lies slot P-1's column, never in band),
    // the old H outside, h_last at the eh[end_r] end cell; the in-band
    // non-zero cells as a bit mask
    const int below = __shfl_up_sync(FULL, M[S - 1], 1);
    uint32_t nzm = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int c = base + k;
      const bool inb = c >= beg_r && c < end_r;
      int hs = k > 0 ? M[k > 0 ? k - 1 : 0] : (lane ? below : NEG);
      hs = c >= 1 ? hs : h1_init;
      H[k] = inb ? hs : H[k];
      nzm |= inb && (H[k] | E[k]) != 0 ? 1u << k : 0u;
      H[k] = c == end_r ? h_last : H[k];
      E[k] = c == end_r ? 0 : E[k];
    }
    const int first = nzm ? base + __ffs(nzm) - 1 : 0x3fffffff;
    const int last = nzm ? base + 31 - __clz(nzm) : -0x3fffffff;

    const bool done = track_row(a, tr, i, mrow, mj, h_last, end_r == qlen);
    const int first_nz = __reduce_min_sync(FULL, first);
    int last_nz = __reduce_max_sync(FULL, last);
    const int beg_n = first_nz < end_r ? first_nz : end_r;
    // the end cell counts where its column is a slot and h_last is not 0
    if (h_last != 0 && end_r >= i - W) last_nz = imax(last_nz, end_r);
    last_nz = imax(last_nz, beg_n - 1);
    if (done) break;
    beg = beg_n;
    end = last_nz + 2 < qlen ? last_nz + 2 : qlen;
  }
  if (lane == 0) write_out(a, prob, tr, rows);
}

template <int S>
int launch_warp(const BandArgs &a, cudaStream_t stream) {
  ksw_band_warp<S><<<(a.n + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the warp path at P <= 1024 slots: S = P/32 rounded up to a multiple of 4
int run_warp(const BandArgs &a, cudaStream_t stream) {
  switch ((a.P + 127) / 128 * 4) {
    case 4: return launch_warp<4>(a, stream);
    case 8: return launch_warp<8>(a, stream);
    case 12: return launch_warp<12>(a, stream);
    case 16: return launch_warp<16>(a, stream);
    case 20: return launch_warp<20>(a, stream);
    case 24: return launch_warp<24>(a, stream);
    case 28: return launch_warp<28>(a, stream);
    default: return launch_warp<32>(a, stream);
  }
}

// slots a thread of the wide path owns at a band of P slots and nt
// threads: ceil(P/nt), made odd (conflict-free strided ring accesses)
__host__ __device__ __forceinline__ int wide_slots(int P, int nt) {
  return ((P + nt - 1) / nt) | 1;
}

template <bool SMEM>
__global__ void __launch_bounds__(WIDE_NT) ksw_band_wide(BandArgs a) {
  extern __shared__ int2 dyn[];
  __shared__ int smat[25];
  // per warp: total (A), max, its largest column, h_last, last H (B),
  // first and last non-zero column (C)
  __shared__ int s_tot[32], s_max[32], s_col[32], s_hl[32], s_hi[32];
  __shared__ int s_first[32], s_last[32];
  const int kb = blockIdx.x;
  const int prob = a.perm ? a.perm[kb] : kb;
  const int P = a.pw ? a.pw[prob] : a.P;
  const int W = P / 2 - 1;
  // the ring: H and E of query column c at HE[c mod P], its code at
  // QS[c mod P]; a.P (the launch's widest band) sizes it
  int2 *HE = SMEM ? dyn
                  : (int2 *)(a.scratch + (int64_t)kb * a.scratch_stride);
  uint8_t *QS = (uint8_t *)(HE + a.P);
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int nw = blockDim.x >> 5;
  const int S = wide_slots(P, blockDim.x);
  const int p0 = t * S;
  const int nk = P - p0 < S ? (P - p0 > 0 ? P - p0 : 0) : S;
  const int t_top = (P - 1) / S, k_top = P - 1 - t_top * S;
  const bool arrays = a.ts != nullptr;
  const Problem pr = problem(a, prob, arrays);
  const int qlen = pr.qlen, tlen = pr.tlen, w = pr.w, h0 = pr.h0;
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int e_del = a.e_del, e_ins = a.e_ins, e1 = pr.e1;

  if (t < 25) smat[t] = a.mat[t];
  // row 0's band: column p - W at slot p
  for (int k = 0; k < nk; ++k) {
    const int c = p0 + k - W;
    const int ph = c < 0 ? c + P : c;
    HE[ph] = make_int2(eh_init(c, h0, e1, e_ins, qlen, a.col1), 0);
    QS[ph] = (uint8_t)q_at(a, pr.qb, pr.qd, qlen, c);
  }
  __syncthreads();
  // codes of rows 0-31 now, of rows 32-63 in flight (every warp loads the
  // chunk; row i takes its codes from lane i % 32), as on the warp path
  int cur = row_codes(row_load(a, arrays, pr.qb, pr.qd, qlen, pr.tb, pr.td,
                               tlen, lane, P, W));
  RowLoad nxt = row_load(a, arrays, pr.qb, pr.qd, qlen, pr.tb, pr.td, tlen,
                         32 + lane, P, W);
  Track tr{h0, -1, -1, -1, -1, 0};
  int beg = 0, end = qlen, rows = 0;
  int pb = (p0 + P - W) % P;  // ring index of the thread's slot 0 at row i

  for (int i = 0; i < tlen; ++i) {
    rows = i + 1;
    if (i > 0 && (i & 31) == 0) {  // next chunk: loaded 32 rows ago
      cur = row_codes(nxt);
      nxt = row_load(a, arrays, pr.qb, pr.qd, qlen, pr.tb, pr.td, tlen,
                     i + 32 + lane, P, W);
    }
    const int code = __shfl_sync(FULL, cur, i & 31);
    if (i > 0 && t == t_top) {  // column i + W + 1 enters at slot P-1
      int ph = pb + k_top;
      ph -= ph >= P ? P : 0;
      HE[ph] = make_int2(eh_init(i - W + P - 1, h0, e1, e_ins, qlen), 0);
      QS[ph] = (uint8_t)(code >> 8);
    }
    const int *ms = smat + (code & 0xff) * 5;
    const int beg_r = beg > i - w ? beg : i - w;
    int end_r = end < i + w + 1 ? end : i + w + 1;
    end_r = end_r < qlen ? end_r : qlen;
    int h1 = h0 - (a.o_del + e_del * (i + 1));
    h1 = h1 > 0 ? h1 : 0;
    const int h1_init = beg_r == 0 ? h1 : 0;
    const int base = p0 + i - W;  // column of the thread's slot 0

    // pass 1: the thread total of max(M - oe_ins, 0) + j*e_ins (g
    // unmasked, as on the warp path)
    int tot = NEG;
    for (int k = 0, ph = pb; k < nk; ++k, ph = ph + 1 == P ? 0 : ph + 1) {
      const int c = base + k;
      const bool inb = c >= beg_r && c < end_r;
      const int h = HE[ph].x;
      const int m = inb ? (h != 0 ? h + ms[QS[ph]] : 0) : NEG;
      tot = imax(tot, imax(m - oe_ins, 0) + c * e_ins);
    }
    int v = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) v = imax(v, __shfl_up_sync(FULL, v, o));
    int run = __shfl_up_sync(FULL, v, 1);
    run = lane ? run : NEG;
    if (lane == 31) s_tot[wid] = v;
    __syncthreads();  // A
    run = imax(run, __reduce_max_sync(FULL, lane < wid ? s_tot[lane] : NEG));

    // pass 2: F, H(i, j), E(i+1, j); H(i, j-1) into every slot but the
    // first; the thread's max and its largest column, h_last, the first
    // and last non-zero in-band cells
    int mloc = NEG, lcol = -1, hl = NEG, hprev = NEG;
    int first = 0x3fffffff, last = -0x3fffffff;
    int e_new0 = 0;
    bool inb0 = false;
    for (int k = 0, ph = pb; k < nk; ++k, ph = ph + 1 == P ? 0 : ph + 1) {
      const int c = base + k;
      const bool inb = c >= beg_r && c < end_r;
      const int2 he = HE[ph];
      const int m = inb ? (he.x != 0 ? he.x + ms[QS[ph]] : 0) : NEG;
      const int F = c == beg_r ? 0 : run - (c - 1) * e_ins;
      run = imax(run, imax(m - oe_ins, 0) + c * e_ins);
      const int hr = inb ? imax(imax(m, he.y), F) : NEG;
      const int en = inb ? imax(he.y - e_del, imax(m - oe_del, 0)) : he.y;
      if (hr >= mloc) {  // columns rise: ties go to the larger
        mloc = hr;
        lcol = c;
      }
      hl = c == end_r - 1 ? hr : hl;
      int hn = he.x;
      if (k == 0) {
        e_new0 = en;
        inb0 = inb;
      } else if (inb) {
        hn = c >= 1 ? hprev : h1_init;
        if ((hn | en) != 0) {
          first = c < first ? c : first;
          last = c;
        }
      }
      HE[ph] = make_int2(hn, en);
      hprev = hr;
    }
    const int wm = __reduce_max_sync(FULL, mloc);
    const int wc = __reduce_max_sync(FULL, mloc == wm ? lcol : -1);
    const int whl = __reduce_max_sync(FULL, hl);
    const int below = __shfl_up_sync(FULL, hprev, 1);
    if (lane == 0) {
      s_max[wid] = wm;
      s_col[wid] = wc;
      s_hl[wid] = whl;
    }
    if (lane == 31) s_hi[wid] = hprev;
    __syncthreads();  // B
    const int xm = lane < nw ? s_max[lane] : NEG;
    int mrow = __reduce_max_sync(FULL, xm);
    const int mjr = __reduce_max_sync(FULL, lane < nw && xm == mrow
                                                ? s_col[lane] : -1);
    const int hlr = __reduce_max_sync(FULL, lane < nw ? s_hl[lane] : NEG);
    mrow = mrow > 0 ? mrow : 0;
    const int mj = mrow > 0 ? mjr : -1;
    const int h_last = end_r > beg_r ? hlr : h1_init;
    if (track_row(a, tr, i, mrow, mj, h_last, end_r == qlen)) break;

    // the first slot's H(i, j-1): the thread below's last H (a shuffle,
    // or the warp below's; below slot 0 lies no slot), then the eh[end_r]
    // end cell (pass 2 left the first slot's old H where it is out of band)
    if (nk > 0) {
      if (inb0) {
        const int hs = lane ? below : (wid ? s_hi[wid - 1] : NEG);
        const int hn = base >= 1 ? hs : h1_init;
        HE[pb].x = hn;
        if ((hn | e_new0) != 0) {
          first = base;
          last = last > base ? last : base;
        }
      }
      const int ke = end_r - base;
      if (ke >= 0 && ke < nk) {
        int ph = pb + ke;
        ph -= ph >= P ? P : 0;
        HE[ph] = make_int2(h_last, 0);
      }
    }
    const int wf = __reduce_min_sync(FULL, first);
    const int wl = __reduce_max_sync(FULL, last);
    if (lane == 0) {
      s_first[wid] = wf;
      s_last[wid] = wl;
    }
    __syncthreads();  // C
    const int first_nz = __reduce_min_sync(
        FULL, lane < nw ? s_first[lane] : 0x3fffffff);
    int last_nz = __reduce_max_sync(FULL,
                                    lane < nw ? s_last[lane] : -0x3fffffff);
    const int beg_n = first_nz < end_r ? first_nz : end_r;
    if (h_last != 0 && end_r >= i - W) last_nz = imax(last_nz, end_r);
    last_nz = imax(last_nz, beg_n - 1);
    beg = beg_n;
    end = last_nz + 2 < qlen ? last_nz + 2 : qlen;
    pb = pb + 1 == P ? 0 : pb + 1;
  }
  if (t == 0) write_out(a, prob, tr, rows);
}

// ring bytes of one problem at a band of P slots (int2 H/E + a code byte)
__host__ __device__ __forceinline__ int64_t wide_ring_bytes(int P) {
  return ((int64_t)P * 9 + 15) / 16 * 16;
}

// the wide path: a block per problem; a.P is the launch's widest band.
// Up to 1024 threads a block when the launch has no more problems than
// the card has SMs (each row's chain is then the bound, and more threads
// shorten it), up to 512 above (the SMs' issue rate is then the bound, and
// the bookkeeping every warp repeats costs less)
int run_wide(const BandArgs &a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int S = wide_slots(a.P, a.n <= sms ? WIDE_NT : WIDE_NT / 2);
  const int nt = ((a.P + S - 1) / S + 31) / 32 * 32;
  if (a.scratch) {
    if (a.scratch_stride < wide_ring_bytes(a.P))
      return (int)cudaErrorInvalidValue;
    ksw_band_wide<false><<<a.n, nt, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int64_t shm = wide_ring_bytes(a.P);
  if (shm > WIDE_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  // opt in past the default 48 KB of dynamic shared memory
  e = cudaFuncSetAttribute(
      ksw_band_wide<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  ksw_band_wide<true><<<a.n, nt, shm, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
