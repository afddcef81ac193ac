// Kernel K2: batched banded ksw_extend2 with in-kernel query/.pac gather.
//
// Replaces the JAX package's Pallas kernel
// bwa_tpu/ops/ksw_pallas.py::_mk_band_kernel as called through
// bwa_tpu/ops/ext_gather.py::_side_call (ExtGatherEngine.run_fused) and
// ::_ext_band_meta (ExtGatherEngine.run): one pass of mem_chain2aln seed
// extensions (ksw.c:416-515 semantics) in band-relative coordinates
// p = j - (i - W), W = P/2 - 1.  Its host-array mode (bwa_ksw_band_arrays)
// replaces the same body as called through
// bwa_tpu/ops/ksw_pallas.py::_extend_band (extend_band_pallas): query rows
// and target rows come from [n, Q] and [n, T] code arrays instead of read
// coordinates and the .pac.
//
// Per target row i (the plain version is ops/ksw_band.py::sweep_row):
//   * the band slides one column right: slot p takes slot p+1's H/E and
//     query code, and slot P-1 takes q[i-W+P-1] with the first-row eh
//     init value (stale cells keep their init, as in the reference);
//   * the diagonal H(i-1, j-1) is the slot's own H, E(i-1, j) the slot's
//     own E, and F is an in-row prefix max of max(M - oe_ins, 0) +
//     j*e_ins;
//   * the row max with its largest column (ties go to the larger column)
//     feeds z-drop, and the first/last non-zero cells set the adaptive
//     band of the next row.
// The block stops at the first row where the problem is done (row max 0
// or z-drop): nothing after that row can change an output.  The query
// windows come from the batch's flat read codes in direction qdir, the
// target rows from the 2-bit .pac with the reverse complement on the
// reverse half (bns_get_seq, bntseq.c:403-424); positions are int64.
//
// Two layouts, chosen by P in run():
//
// Warp path, P <= 1024 (every band `mem` uses at -w up to 511; the
// default -w 100 gives P = 256 and its retry P = 512): one warp per
// problem, four problems a 128-thread block.  Lane l owns S = P/32
// (rounded up to a multiple of 4) consecutive slots, pad = 32*S - P dead
// slots at the front of lane 0 (their columns lie left of every band).
// H, E and the query codes (four a register) stay in registers, and a row
// has no block barrier, only warp primitives (ops/ksw_band.py::warp_row is
// the same arithmetic in plain PyTorch):
//   * slide (every row, row 0 included: the band starts one column to
//     the left): the lane's registers shift by one, three
//     __shfl_down_sync bring slot 0 of the next lane;
//   * F: a max-scan over the lane's own slots and an exclusive prefix max
//     of the lane totals (five __shfl_up_sync steps);
//   * H(i, j-1) for the next row: the lane's registers, one
//     __shfl_up_sync for the slot below the lane;
//   * row max and its largest column: two __reduce_max_sync (REDUX), the
//     max H, then the largest column holding it (each lane offers its
//     largest column holding its own max, found while the first reduction
//     runs); h_last = H(i, end_r-1) a third; the next band's first and
//     last non-zero columns (bit masks of the lane's cells) two
//     independent reductions (__reduce_min_sync, __reduce_max_sync) over
//     the in-band cells, with the eh[end_r] end cell added after them.
//   * the target code and the query code entering slot P-1 come from
//     32-row chunks: each lane loads one row's codes of the chunk after
//     next (one coalesced step a chunk), and row i takes its codes from
//     lane i % 32 by __shfl_sync, so no row waits on a global load.
//
// What bounds the warp path: the rows of one problem form a chain, so a
// launch lasts as long as its longest problem's rows times the latency of
// one row; operations and bytes do not capture it (the per-launch bounds
// at 20 operations a band cell sit two orders of magnitude below).  A row
// is about 450 instructions at S = 8 (SASS), issued by one warp that
// mostly has its scheduler alone, behind a dependent chain of a shuffle
// for the slide, the score loads, the 6-shuffle scan, the in-lane F scan
// and two or three REDUX reductions before the loop can decide to go on;
// each lane does S cells' work on every row.  The design shortens that
// chain (no barriers, no shared-memory round trips, codes prefetched, no
// masks that cannot change a result) and fills the card with problems;
// it cannot shorten the longest problem.  chip_smoke.py prints the
// longest problem's rows and ns a row of every launch.
//
// Registers (ptxas -v, sm_90a, 128-thread blocks): 64 a thread at S = 4,
// 95 at S = 8 (P = 256), 127 at S = 12, 167 at S = 16 (P = 512), 201 at
// S = 20, 223 at S = 24, 255 at S = 28 and 32; no spills at any S.
//
// Block path, P > 1024 (-w 512-1023, and retries of w > 255): one block
// per problem, thread t owning S = 2 or 4 consecutive slots of the band
// in shared memory, the row scan and reductions across the block with
// barriers (ksw_common.cuh).

#include "ksw_common.cuh"

namespace {

using namespace ksw;

constexpr int MAX_P = 4096;   // widest band: 4 slots a thread, block path

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
  int n, P, W;
  int mat[25];
  int o_del, e_del, o_ins, e_ins, zdrop;
};

__device__ __forceinline__ int q_at(const BandArgs &a, int64_t qb, int qd,
                                    int ql, int64_t jq) {
  if (jq < 0 || jq >= ql) return 4;
  int64_t idx = qb + (int64_t)qd * jq;
  idx = idx < 0 ? 0 : (idx > a.nq - 1 ? a.nq - 1 : idx);
  return a.qflat[idx];
}

__device__ __forceinline__ int pac_at(const BandArgs &a, int64_t pos) {
  int64_t two_l = a.l_pac * 2;
  int64_t pc = pos < 0 ? 0 : (pos > two_l - 1 ? two_l - 1 : pos);
  bool fwd = pc < a.l_pac;
  int64_t f = fwd ? pc : two_l - 1 - pc;
  int code = (a.pac[f >> 2] >> (((~f) & 3) << 1)) & 3;
  return fwd ? code : 3 - code;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // problems (warps) a block on the warp path

// The raw loads of one row's codes, decoded a chunk later: the target
// byte t with how to decode it (tm = -1: t is the code; else the 2-bit
// shift in bits 0-2 and the reverse-complement flag in bit 3), and the
// query code q entering slot P-1.
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

template <int S>
__global__ void __launch_bounds__(32 * WARPS) ksw_band_warp(BandArgs a) {
  static_assert(S % 4 == 0 && S <= 32, "four query codes a register");
  constexpr int NQ = S / 4;
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = a.mat[threadIdx.x];
  __syncthreads();  // the only block barrier: before any row
  const int lane = threadIdx.x & 31;
  const int prob = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (prob >= a.n) return;
  const int P = a.P, W = a.W, pad = 32 * S - P;
  const bool arrays = a.ts != nullptr;
  const int64_t qb = arrays ? prob * a.q_stride : a.qbase[prob];
  const int64_t tb = arrays ? prob * a.t_stride : a.tbase[prob];
  const int qd = arrays ? 1 : a.qdir[prob];
  const int td = arrays ? 1 : a.tdir[prob];
  const int qlen = a.qlen[prob], tlen = a.tlen[prob];
  const int w = a.w[prob], h0 = a.h0[prob];
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int e_del = a.e_del, e_ins = a.e_ins;
  const int e1 = h0 - oe_ins > 0 ? h0 - oe_ins : 0;

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
    H[k] = p >= 0 ? eh_init(p - W - 1, h0, e1, e_ins, qlen) : 0;
    E[k] = 0;
    const int q = p >= 0 ? q_at(a, qb, qd, qlen, p - W - 1) : 4;
    Q[k >> 2] |= (uint32_t)q << (8 * (k & 3));
  }
  // codes of rows 0-31 now, of rows 32-63 in flight
  int cur = row_codes(row_load(a, arrays, qb, qd, qlen, tb, td, tlen, lane,
                               P, W));
  RowLoad nxt = row_load(a, arrays, qb, qd, qlen, tb, td, tlen, 32 + lane,
                         P, W);
  int beg = 0, end = qlen, mx = h0, mx_i = -1, mx_j = -1, mx_ie = -1;
  int gsc = -1, mx_off = 0, rows = 0;

  for (int i = 0; i < tlen; ++i) {
    rows = i + 1;
    if (i > 0 && (i & 31) == 0) {  // next chunk: loaded 32 rows ago
      cur = row_codes(nxt);
      nxt = row_load(a, arrays, qb, qd, qlen, tb, td, tlen, i + 32 + lane,
                     P, W);
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
    if (end_r == qlen && h_last >= gsc) {
      mx_ie = i;
      gsc = h_last;
    }
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

    const bool brk0 = mrow == 0;
    const bool imp = !brk0 && mrow > mx;
    if (imp) {
      mx_i = i;
      int d = mj - i < 0 ? i - mj : mj - i;
      mx_off = mx_off > d ? mx_off : d;
      mx_j = mj;
    }
    bool brkz = false;
    if (!brk0 && !imp && a.zdrop > 0) {
      int d_i = i - mx_i, d_j = mj - mx_j;
      if (d_i > d_j) brkz = mx - mrow - (d_i - d_j) * e_del > a.zdrop;
      else brkz = mx - mrow - (d_j - d_i) * e_ins > a.zdrop;
    }
    if (imp) mx = mrow;

    const int first_nz = __reduce_min_sync(FULL, first);
    int last_nz = __reduce_max_sync(FULL, last);
    const int beg_n = first_nz < end_r ? first_nz : end_r;
    // the end cell counts where its column is a slot and h_last is not 0
    if (h_last != 0 && end_r >= i - W) last_nz = imax(last_nz, end_r);
    last_nz = imax(last_nz, beg_n - 1);
    if (brk0 || brkz) break;
    beg = beg_n;
    end = last_nz + 2 < qlen ? last_nz + 2 : qlen;
  }
  if (lane == 0) {
    int32_t *o = a.out + (int64_t)prob * 7;
    o[0] = mx;
    o[1] = mx_j + 1;
    o[2] = mx_i + 1;
    o[3] = mx_ie + 1;
    o[4] = gsc;
    o[5] = mx_off;
    o[6] = rows;  // target rows swept (work diagnostic)
  }
}

template <int S>
int launch_warp(const BandArgs &a, cudaStream_t stream) {
  ksw_band_warp<S><<<(a.n + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
__global__ void __launch_bounds__(1024) ksw_band_kernel(BandArgs a) {
  extern __shared__ int smem[];
  const int P = a.P, W = a.W;
  int *sH = smem;          // [P] H(i-1, j-1) at slot p (eh[j].h)
  int *sE = sH + P;        // [P] E(i, j)
  int *sQ = sE + P;        // [P] query code at slot p
  int *sRun = sQ + P;      // [P] row scan / Hrow exchange
  __shared__ int64_t red[MAXW];
  __shared__ int wtot[MAXW];

  const int prob = blockIdx.x;
  const int p0 = threadIdx.x * S;  // this thread's slots: p0 .. p0+S-1
  const bool arrays = a.ts != nullptr;
  const int64_t qb = arrays ? prob * a.q_stride : a.qbase[prob];
  const int64_t tb = arrays ? prob * a.t_stride : a.tbase[prob];
  const int qd = arrays ? 1 : a.qdir[prob];
  const int td = arrays ? 1 : a.tdir[prob];
  const int qlen = a.qlen[prob], tlen = a.tlen[prob];
  const int w = a.w[prob], h0 = a.h0[prob];
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int e_del = a.e_del, e_ins = a.e_ins;
  const int e1 = h0 - oe_ins > 0 ? h0 - oe_ins : 0;

  // row-0 band state
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int p = p0 + k;
    sH[p] = eh_init(p - W, h0, e1, e_ins, qlen);
    sE[p] = 0;
    sQ[p] = q_at(a, qb, qd, qlen, p - W);
  }
  int beg = 0, end = qlen, mx = h0, mx_i = -1, mx_j = -1, mx_ie = -1;
  int gsc = -1, mx_off = 0, rows = 0;
  __syncthreads();

  for (int i = 0; i < tlen; ++i) {
    rows = i + 1;
    if (i > 0) {  // slide the band one column right
      const int j_ent = i - W + P - 1;
      int hn[S], en[S], qn[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int p = p0 + k;
        const bool last = p == P - 1;
        hn[k] = last ? eh_init(j_ent, h0, e1, e_ins, qlen) : sH[p + 1];
        en[k] = last ? 0 : sE[p + 1];
        qn[k] = last ? q_at(a, qb, qd, qlen, j_ent) : sQ[p + 1];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < S; ++k) {
        sH[p0 + k] = hn[k];
        sE[p0 + k] = en[k];
        sQ[p0 + k] = qn[k];
      }
      __syncthreads();
    }
    const int tci = arrays ? a.ts[tb + i] : pac_at(a, tb + (int64_t)td * i);
    const int beg_r = beg > i - w ? beg : i - w;
    int end_r = end < i + w + 1 ? end : i + w + 1;
    end_r = end_r < qlen ? end_r : qlen;
    int h1 = h0 - (a.o_del + e_del * (i + 1));
    h1 = h1 > 0 ? h1 : 0;
    const int h1_init = beg_r == 0 ? h1 : 0;

    int colj[S], Hold[S], Eold[S], M[S], e_cur[S], run[S];
    bool inband[S];
    int loc = NEG;  // prefix max over this thread's slots
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int p = p0 + k;
      colj[k] = p + (i - W);
      inband[k] = colj[k] >= beg_r && colj[k] < end_r;
      Hold[k] = sH[p];
      Eold[k] = sE[p];
      const int sc = a.mat[tci * 5 + sQ[p]];
      const int m = Hold[k] != 0 ? Hold[k] + sc : 0;
      M[k] = inband[k] ? m : NEG;
      e_cur[k] = inband[k] ? Eold[k] : NEG;
      const int g = inband[k] ? imax(M[k] - oe_ins, 0) : NEG;
      loc = imax(loc, g + colj[k] * e_ins);
      run[k] = loc;
    }
    const int pre = block_scan_max_excl(loc, wtot);
#pragma unroll
    for (int k = 0; k < S; ++k) sRun[p0 + k] = imax(pre, run[k]);
    __syncthreads();
    int Hrow[S];
    int64_t key = INT64_MIN;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int p = p0 + k;
      int F = p >= 1 ? sRun[p - 1] - (colj[k] - 1) * e_ins : NEG;
      if (colj[k] == beg_r) F = 0;
      if (!inband[k]) F = NEG;
      int hr = imax(imax(M[k], e_cur[k]), F);
      Hrow[k] = inband[k] ? hr : NEG;
      const int64_t kk = inband[k]
          ? (((int64_t)Hrow[k] << 32) | (uint32_t)colj[k]) : INT64_MIN;
      key = kk > key ? kk : key;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S; ++k) sRun[p0 + k] = Hrow[k];
    // row max and its largest column
    key = block_max64(key, red);  // also orders the sRun writes
    int mraw = key == INT64_MIN ? NEG : (int)(key >> 32);
    const int mrow = mraw > 0 ? mraw : 0;
    const int mj = mrow > 0 ? (int)(uint32_t)(key & 0xffffffffu) : -1;
    int h_last = h1_init;
    if (end_r > beg_r) h_last = sRun[end_r - 1 - (i - W)];
    if (end_r == qlen && h_last >= gsc) {
      mx_ie = i;
      gsc = h_last > gsc ? h_last : gsc;
    }
    bool nz[S];
    int first = 0x3fffffff;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int p = p0 + k;
      const int t_del = imax(M[k] - oe_del, 0);
      const int Enew = imax(e_cur[k] - e_del, t_del);
      const int Hsh = colj[k] >= 1 ? sRun[(p + P - 1) % P] : h1_init;
      int H2 = inband[k] ? Hsh : Hold[k];
      int E2 = inband[k] ? Enew : Eold[k];
      if (colj[k] == end_r) {
        H2 = h_last;
        E2 = 0;
      }
      sH[p] = H2;
      sE[p] = E2;
      nz[k] = !(H2 == 0 && E2 == 0);
      if (nz[k] && colj[k] >= beg_r && colj[k] < end_r && colj[k] < first)
        first = colj[k];
    }

    const bool brk0 = mrow == 0;
    const bool imp = !brk0 && mrow > mx;
    if (imp) {
      mx_i = i;
      int d = mj - i < 0 ? i - mj : mj - i;
      mx_off = mx_off > d ? mx_off : d;
      mx_j = mj;
    }
    bool brkz = false;
    if (!brk0 && !imp && a.zdrop > 0) {
      int d_i = i - mx_i, d_j = mj - mx_j;
      if (d_i > d_j) brkz = mx - mrow - (d_i - d_j) * e_del > a.zdrop;
      else brkz = mx - mrow - (d_j - d_i) * e_ins > a.zdrop;
    }
    if (imp) mx = mrow;

    const int first_nz = block_min32(first, red);
    const int beg_n = first_nz < end_r ? first_nz : end_r;
    int last = beg_n - 1;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (nz[k] && colj[k] >= beg_n && colj[k] <= end_r)
        last = imax(last, colj[k]);
    const int last_nz = block_max32(last, red);
    const int end_n = last_nz + 2 < qlen ? last_nz + 2 : qlen;
    if (brk0 || brkz) break;
    beg = beg_n;
    end = end_n;
  }
  if (threadIdx.x == 0) {
    int32_t *o = a.out + (int64_t)prob * 7;
    o[0] = mx;
    o[1] = mx_j + 1;
    o[2] = mx_i + 1;
    o[3] = mx_ie + 1;
    o[4] = gsc;
    o[5] = mx_off;
    o[6] = rows;  // target rows swept (work diagnostic)
  }
}

template <int S>
int launch(const BandArgs &a, cudaStream_t stream) {
  const size_t shm = (size_t)4 * a.P * sizeof(int);
  // opt in to the dynamic shared memory: from P = 3072 it and the static
  // reduction arrays pass the default 48 KB per block
  cudaError_t e = cudaFuncSetAttribute(
      ksw_band_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  ksw_band_kernel<S><<<a.n, a.P / S, shm, stream>>>(a);
  return (int)cudaGetLastError();
}

int run(BandArgs &a, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const int P = a.P;
  if (P < 32 || P > MAX_P) return (int)cudaErrorInvalidValue;
  a.W = P / 2 - 1;
  if (P <= 1024) {  // the warp path
    if (P % 32 != 0) return (int)cudaErrorInvalidValue;
    switch ((P + 127) / 128 * 4) {
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
  const int S = P <= 2048 ? 2 : 4;  // the block path
  if (P % (32 * S) != 0) return (int)cudaErrorInvalidValue;
  if (S == 2) return launch<2>(a, stream);
  return launch<4>(a, stream);
}

}  // namespace

extern "C" int bwa_ksw_band(const uint8_t *pac, int64_t l_pac,
                            const uint8_t *qflat, int64_t nq,
                            const int64_t *qbase, const int32_t *qdir,
                            const int32_t *qlen, const int64_t *tbase,
                            const int32_t *tdir, const int32_t *tlen,
                            const int32_t *w, const int32_t *h0,
                            const int32_t *mat, int o_del, int e_del,
                            int o_ins, int e_ins, int zdrop, int P, int n,
                            int32_t *out, void *stream) {
  BandArgs a{pac, l_pac, qflat, nq, nullptr, 0, 0, qbase, tbase, qdir,
             qlen, tdir, tlen, w, h0, out, n, P, 0, {0}, o_del, e_del,
             o_ins, e_ins, zdrop};
  for (int k = 0; k < 25; ++k) a.mat[k] = mat[k];
  return run(a, (cudaStream_t)stream);
}

// host-array mode: qs [n, Q] and ts [n, T] row-major code arrays
extern "C" int bwa_ksw_band_arrays(const uint8_t *qs, int64_t Q,
                                   const uint8_t *ts, int64_t T,
                                   const int32_t *qlen, const int32_t *tlen,
                                   const int32_t *w, const int32_t *h0,
                                   const int32_t *mat, int o_del, int e_del,
                                   int o_ins, int e_ins, int zdrop, int P,
                                   int n, int32_t *out, void *stream) {
  BandArgs a{nullptr, 0, qs, (int64_t)n * Q, ts, Q, T, nullptr, nullptr,
             nullptr, qlen, nullptr, tlen, w, h0, out, n, P, 0, {0}, o_del,
             e_del, o_ins, e_ins, zdrop};
  for (int k = 0; k < 25; ++k) a.mat[k] = mat[k];
  return run(a, (cudaStream_t)stream);
}
