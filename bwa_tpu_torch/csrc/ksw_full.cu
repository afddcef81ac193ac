// Kernel K5: batched full-width ksw_extend2 over host-built code rows.
//
// Replaces the JAX package's Pallas kernel
// bwa_tpu/ops/ksw_pallas.py::_mk_kernel as called through ::_extend_pallas
// (extend_batch_pallas): ksw_extend2 (ksw.c:416-515 semantics) in absolute
// query columns 0..QP-1, QP = roundup_128(Q + 1), so column qlen always
// exists for the eh[qlen] end-slot write.  Exact behaviour is kept: the
// adaptive beg/end band with stale cells (cells outside the band keep
// their last value, columns never written keep the first-row init), the
// closed-form first-row eh fill, h0 seeding, z-drop, gscore/max_ie/max_off
// bookkeeping and "ties go to the larger column".
//
// Design: one block per problem, thread t owning the S consecutive
// columns t*S .. t*S+S-1 (S = 1 up to QP = 1024, 2 up to 2048, 4 up to
// 4096, so a block never exceeds 1024 threads).  Nothing slides: H, E and
// the query codes of a thread's columns stay in its registers for the
// whole sweep.  The block sweeps the target rows and stops at the first
// row where the problem is done (row max 0 or z-drop).  Per row:
//   * F is an in-row prefix max of max(M - oe_ins, 0) + j*e_ins: a scan
//     over the thread's own columns, then a block scan of the thread
//     totals (warp shuffles, then the warp totals);
//   * the shift of the row by one column (H(i, j-1) stored at column j)
//     takes the previous thread's last column: a warp shuffle, and for a
//     warp's first lane the previous warp's last value from shared memory;
//   * block reductions give the row max with its largest column (one
//     int64 (score, column) max), and the first/last non-zero cells that
//     set the band of the next row.
//
// What bounds it: ~20 integer operations per cell on all QP columns of
// every row (the TPU kernel's shape: the band is not exploited, which is
// K2's job); the inputs are a byte per cell of the query and target rows.
// It is compute- and synchronisation-bound: each row costs eight block
// barriers, so the kernel leans on many resident blocks (one problem each).

#include "ksw_common.cuh"

namespace {

using namespace ksw;

constexpr int MAX_QP = 4096;  // widest query: 4 columns per thread

struct FullArgs {
  const uint8_t *qs;  // [n, QP] query codes (4 past the query)
  const uint8_t *ts;  // [n, T] target codes
  int64_t T;          // row stride of ts; tlen <= T
  const int32_t *qlen, *tlen, *w, *h0;
  int32_t *out;       // [n, 7]: score qle tle gtle gscore max_off rows
  int n, QP;
  int mat[25];
  int o_del, e_del, o_ins, e_ins, zdrop;
};

template <int S>
__global__ void __launch_bounds__(1024) ksw_full_kernel(FullArgs a) {
  __shared__ int64_t red[MAXW];
  __shared__ int wtot[MAXW];
  __shared__ int wlast[MAXW];  // Hrow at each warp's last column
  __shared__ int hend;         // Hrow at column end_r - 1

  const int prob = blockIdx.x;
  const int c0 = threadIdx.x * S;  // this thread's columns: c0 .. c0+S-1
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int qlen = a.qlen[prob], tlen = a.tlen[prob];
  const int w = a.w[prob], h0 = a.h0[prob];
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int e_del = a.e_del, e_ins = a.e_ins;
  const int e1 = h0 - oe_ins > 0 ? h0 - oe_ins : 0;
  const uint8_t *trow = a.ts + prob * a.T;

  // row-0 state (ksw.c:445-449): eh[0] = h0, eh[1] = e1 (whatever qlen),
  // then the closed-form fill up to qlen, 0 elsewhere
  int H[S], E[S], Q[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int col = c0 + k;
    H[k] = col == 1 ? e1 : eh_init(col, h0, e1, e_ins, qlen);
    E[k] = 0;
    Q[k] = a.qs[(int64_t)prob * a.QP + col];
  }
  int beg = 0, end = qlen, mx = h0, mx_i = -1, mx_j = -1, mx_ie = -1;
  int gsc = -1, mx_off = 0, rows = 0;

  for (int i = 0; i < tlen; ++i) {
    rows = i + 1;
    const int tci = trow[i];
    const int beg_r = beg > i - w ? beg : i - w;
    int end_r = end < i + w + 1 ? end : i + w + 1;
    end_r = end_r < qlen ? end_r : qlen;
    int h1 = h0 - (a.o_del + e_del * (i + 1));
    h1 = h1 > 0 ? h1 : 0;
    const int h1_init = beg_r == 0 ? h1 : 0;

    int M[S], e_cur[S], run[S];
    bool inband[S];
    int loc = NEG;  // prefix max over this thread's columns
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int col = c0 + k;
      inband[k] = col >= beg_r && col < end_r;
      const int m = H[k] != 0 ? H[k] + a.mat[tci * 5 + Q[k]] : 0;
      M[k] = inband[k] ? m : NEG;
      e_cur[k] = inband[k] ? E[k] : NEG;
      const int g = inband[k] ? imax(M[k] - oe_ins, 0) : NEG;
      loc = imax(loc, g + col * e_ins);
      run[k] = loc;
    }
    const int pre = block_scan_max_excl(loc, wtot);
    int Hrow[S];
    int64_t key = INT64_MIN;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int col = c0 + k;
      const int left = k == 0 ? pre : imax(pre, run[k - 1]);  // run[col-1]
      int F = col >= 1 ? left - (col - 1) * e_ins : NEG;
      if (col == beg_r) F = 0;
      if (!inband[k]) F = NEG;
      const int hr = imax(imax(M[k], e_cur[k]), F);
      Hrow[k] = inband[k] ? hr : NEG;
      const int64_t kk = inband[k]
          ? (((int64_t)Hrow[k] << 32) | (uint32_t)col) : INT64_MIN;
      key = kk > key ? kk : key;
      if (col == end_r - 1) hend = Hrow[k];
    }
    // Hrow one column to the left of this thread's first column
    const int up = __shfl_up_sync(0xffffffffu, Hrow[S - 1], 1);
    if (lane == 31) wlast[wid] = Hrow[S - 1];
    // row max and its largest column; its first barrier also publishes
    // wlast and hend
    key = block_max64(key, red);
    const int mraw = key == INT64_MIN ? NEG : (int)(key >> 32);
    const int mrow = mraw > 0 ? mraw : 0;
    const int mj = mrow > 0 ? (int)(uint32_t)(key & 0xffffffffu) : -1;
    const int h_last = end_r > beg_r ? hend : h1_init;
    if (end_r == qlen && h_last >= gsc) {
      mx_ie = i;
      gsc = h_last > gsc ? h_last : gsc;
    }
    const int hleft = lane > 0 ? up : (wid > 0 ? wlast[wid - 1] : NEG);
    bool nz[S];
    int first = 0x3fffffff;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int col = c0 + k;
      const int t_del = imax(M[k] - oe_del, 0);
      const int Enew = imax(e_cur[k] - e_del, t_del);
      const int Hsh = col >= 1 ? (k > 0 ? Hrow[k - 1] : hleft) : h1_init;
      int H2 = inband[k] ? Hsh : H[k];
      int E2 = inband[k] ? Enew : E[k];
      if (col == end_r) {  // the eh[end] slot (ksw.c:486)
        H2 = h_last;
        E2 = 0;
      }
      H[k] = H2;
      E[k] = E2;
      nz[k] = !(H2 == 0 && E2 == 0);
      if (nz[k] && col >= beg_r && col < end_r && col < first) first = col;
    }

    const bool brk0 = mrow == 0;
    const bool imp = !brk0 && mrow > mx;
    if (imp) {
      mx_i = i;
      const int d = mj - i < 0 ? i - mj : mj - i;
      mx_off = mx_off > d ? mx_off : d;
      mx_j = mj;
    }
    bool brkz = false;
    if (!brk0 && !imp && a.zdrop > 0) {
      const int d_i = i - mx_i, d_j = mj - mx_j;
      if (d_i > d_j) brkz = mx - mrow - (d_i - d_j) * e_del > a.zdrop;
      else brkz = mx - mrow - (d_j - d_i) * e_ins > a.zdrop;
    }
    if (imp) mx = mrow;

    const int first_nz = block_min32(first, red);
    const int beg_n = first_nz < end_r ? first_nz : end_r;
    int last = beg_n - 1;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (nz[k] && c0 + k >= beg_n && c0 + k <= end_r)
        last = imax(last, c0 + k);
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
int launch(const FullArgs &a, cudaStream_t stream) {
  ksw_full_kernel<S><<<a.n, a.QP / S, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// qs [n, QP] and ts [n, T] row-major code arrays; out [n, 7]
extern "C" int bwa_ksw_full(const uint8_t *qs, int QP, const uint8_t *ts,
                            int64_t T, const int32_t *qlen,
                            const int32_t *tlen, const int32_t *w,
                            const int32_t *h0, const int32_t *mat, int o_del,
                            int e_del, int o_ins, int e_ins, int zdrop,
                            int n, int32_t *out, void *stream) {
  if (n == 0) return 0;
  const int S = QP <= 1024 ? 1 : (QP <= 2048 ? 2 : 4);
  if (QP < 32 || QP > MAX_QP || QP % (32 * S) != 0)
    return (int)cudaErrorInvalidValue;
  FullArgs a{qs, ts, T, qlen, tlen, w, h0, out, n, QP, {0}, o_del, e_del,
             o_ins, e_ins, zdrop};
  for (int k = 0; k < 25; ++k) a.mat[k] = mat[k];
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 1) return launch<1>(a, st);
  if (S == 2) return launch<2>(a, st);
  return launch<4>(a, st);
}
