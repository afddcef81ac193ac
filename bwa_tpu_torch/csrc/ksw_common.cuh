// Pieces shared by the ksw_extend2 kernels K2 (ksw_band.cu) and K5
// (ksw_full.cu): the first-row eh init and the block-wide reductions and
// scan that every DP row needs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ksw {

constexpr int NEG = -(1 << 30);
constexpr int MAXW = 32;  // warps per block (1024 threads)

// first-row eh init (ksw.c:445-449) in closed form
__device__ __forceinline__ int eh_init(int j, int h0, int e1, int e_ins,
                                       int qlen) {
  if (j < 0 || j > qlen) return 0;
  if (j == 0) return h0;
  if (j == 1) return e1;
  int fill = e1 - (j - 1) * e_ins;
  int prev = e1 - (j - 2) * e_ins;
  return prev > e_ins ? fill : 0;
}

__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }

// block-wide reductions: every thread gets the result
__device__ int64_t block_max64(int64_t v, int64_t *red) {
  for (int o = 16; o > 0; o >>= 1) {
    int64_t u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int nw = blockDim.x >> 5;
  int64_t r = red[0];
  for (int k = 1; k < nw; ++k) r = red[k] > r ? red[k] : r;
  __syncthreads();
  return r;
}

__device__ int block_min32(int v, int64_t *red) {
  return (int)-block_max64(-(int64_t)v, red);
}

__device__ int block_max32(int v, int64_t *red) {
  return (int)block_max64((int64_t)v, red);
}

// exclusive prefix max over the block (thread order): the max of the
// values of all lower threads, NEG for thread 0
__device__ int block_scan_max_excl(int v, int *wtot) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = imax(u, v);
  }
  int ex = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) ex = NEG;
  if (lane == 31) wtot[wid] = v;
  __syncthreads();
  int pre = NEG;
  for (int k = 0; k < wid; ++k) pre = imax(wtot[k], pre);
  __syncthreads();
  return imax(pre, ex);
}

}  // namespace ksw
