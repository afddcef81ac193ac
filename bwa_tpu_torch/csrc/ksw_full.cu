// Kernel K5: batched ksw_extend2 over host-built code rows, each problem
// swept in a window of its own band width.
//
// Replaces the JAX package's Pallas kernel
// bwa_tpu/ops/ksw_pallas.py::_mk_kernel as called through ::_extend_pallas
// (extend_batch_pallas): ksw_extend2 (ksw.c:416-515 semantics) over query
// rows in absolute columns 0..QP-1, QP = roundup_128(Q + 1), with a
// band-clamped w for each problem.  That kernel sweeps all QP columns of
// every target row; row i of a problem can only write columns i - w ..
// i + w + 1 (its band and the eh[end] end cell), so K5 sweeps a window of
// P = roundup_128(2w + 2) slots that slides one column a row, exactly as
// K2 sweeps its band.  That is exact: a column left of the window never
// re-enters the band (max(beg, i - w) never decreases), and a column
// right of it has not been written since row 0, so it enters the window
// holding its closed-form first-row value.  Every output, stale cell and
// eh[end] slot comes out as in the full-width sweep, with K5's own rules:
// column 1's init is e1 whatever qlen (BandArgs::col1), NEG in the band's
// first cell when beg > 0, ties to the larger column, out[:, 6] the rows
// swept.  ops/ksw_full.py::window_rows is this decomposition in plain
// PyTorch; ops/ksw_full.py::full_rows, the full-width sweep, is the plain
// version K5 is held to.
//
// Layout: the wrapper orders the problems by window class (P = 128 ...
// 1024, then wider) and, inside a class, longest target first, and passes
// that order (perm) with the count of each class.  Each class of up to
// 1024 slots is one launch of K2's warp path at its P (a warp per
// problem); the wider problems are one launch of K2's wide path (a block
// per problem), each at its own P (pw).  The launches run one after the
// other on the caller's stream.  What bounds each launch is in
// ksw_band.cuh: the longest problem's row chain, and on the wide path the
// SMs' issue rate when its problems outnumber the blocks that fit at once.

#include "ksw_band.cuh"

constexpr int K5_CLASSES = 9;  // P = 128 * (c + 1) for c < 8, then wide

// qs [n, QP] and ts [n, T] row-major code arrays; perm [n] the problems in
// class order, counts [K5_CLASSES] (host) the problems of each class, pw
// [n] each problem's window, p_wide the widest window of the last class;
// out [n, 7]
extern "C" int bwa_ksw_full(const uint8_t *qs, int QP, const uint8_t *ts,
                            int64_t T, const int32_t *qlen,
                            const int32_t *tlen, const int32_t *w,
                            const int32_t *h0, const int32_t *mat, int o_del,
                            int e_del, int o_ins, int e_ins, int zdrop,
                            int n, const int32_t *perm, const int32_t *pw,
                            const int *counts, int p_wide, uint8_t *scratch,
                            int64_t scratch_stride, int32_t *out,
                            void *stream) {
  if (n == 0) return 0;
  BandArgs a{nullptr, 0, qs, (int64_t)n * QP, ts, QP, T, nullptr, nullptr,
             nullptr, qlen, nullptr, tlen, w, h0, out, 0, 0, 0, {0}, o_del,
             e_del, o_ins, e_ins, zdrop, nullptr, nullptr, 1, scratch,
             scratch_stride};
  for (int k = 0; k < 25; ++k) a.mat[k] = mat[k];
  cudaStream_t st = (cudaStream_t)stream;
  int off = 0;
  for (int c = 0; c < K5_CLASSES; ++c) {
    if (counts[c] < 0 || off + counts[c] > n)
      return (int)cudaErrorInvalidValue;
    if (counts[c] == 0) continue;
    a.n = counts[c];
    a.perm = perm + off;
    off += counts[c];
    int rc;
    if (c < K5_CLASSES - 1) {
      a.P = 128 * (c + 1);
      a.W = a.P / 2 - 1;
      rc = run_warp(a, st);
    } else {
      if (p_wide <= 1024 || p_wide % 32 != 0)
        return (int)cudaErrorInvalidValue;
      a.P = p_wide;
      a.pw = pw;
      rc = run_wide(a, st);
    }
    if (rc != 0) return rc;
  }
  return off == n ? 0 : (int)cudaErrorInvalidValue;
}
