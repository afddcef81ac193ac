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
// One band P for the launch, any multiple of 32: the warp path
// (ksw_band.cuh::ksw_band_warp) up to P = 1024, which covers every band
// `mem` uses at -w up to 511 (the default -w 100 gives P = 256 and its
// retry P = 512); the wide path (ksw_band.cuh::ksw_band_wide) above, for
// -w 512 and up and every retry of w > 255 (-w 1100: P = 2304, retry
// 4480).  The design, what bounds each path, and the row in detail are in
// ksw_band.cuh.

#include "ksw_band.cuh"

namespace {

int run(BandArgs &a, cudaStream_t stream) {
  if (a.n == 0) return 0;
  if (a.P < 32 || a.P % 32 != 0) return (int)cudaErrorInvalidValue;
  a.W = a.P / 2 - 1;
  return a.P <= 1024 ? run_warp(a, stream) : run_wide(a, stream);
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
                            uint8_t *scratch, int64_t scratch_stride,
                            int32_t *out, void *stream) {
  BandArgs a{pac, l_pac, qflat, nq, nullptr, 0, 0, qbase, tbase, qdir,
             qlen, tdir, tlen, w, h0, out, n, P, 0, {0}, o_del, e_del,
             o_ins, e_ins, zdrop, nullptr, nullptr, 0, scratch,
             scratch_stride};
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
                                   int n, uint8_t *scratch,
                                   int64_t scratch_stride, int32_t *out,
                                   void *stream) {
  BandArgs a{nullptr, 0, qs, (int64_t)n * Q, ts, Q, T, nullptr, nullptr,
             nullptr, qlen, nullptr, tlen, w, h0, out, n, P, 0, {0}, o_del,
             e_del, o_ins, e_ins, zdrop, nullptr, nullptr, 0, scratch,
             scratch_stride};
  for (int k = 0; k < 25; ++k) a.mat[k] = mat[k];
  return run(a, (cudaStream_t)stream);
}
