// K1's occ lookup, shared by the kernels that extend FM-index intervals on
// the fused occtab: csrc/seed_machine.cu (K1 and its state mode, K12 and
// K13) and csrc/smem_batch.cu (K10a, K10b, K11).
//
// The occtab is [n_rows, 4 + NW] uint32: a row's four base counts before
// it, then NW = 8R text words of 16 two-bit codes (R = 1 or 4 disk blocks
// of 128 positions a row; index/fmindex.py::build_occtab).  A group of
// G = 2R threads extends one interval by one base: half the group counts
// B[0..k1], half B[0..k2], each thread WPT = 8 text words (two 16-byte
// loads) plus the row's counts, all issued together, so that both lookups
// cost one memory latency; a shuffle reduction of packed 10-bit counts
// within each half and one exchange between the halves finish bwt_extend's
// counting half.  Every thread of the warp must call it (its shuffles name
// every thread); groups of one warp may extend different intervals.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t M55 = 0x55555555u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WPT = 8;  // occtab words a thread reads for one lookup

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
// A: any argument struct with the occtab, primary and seq_len.
template <typename C, int NW, typename A>
__device__ __forceinline__ void extend_c(const A &a, const C L2[5], C k1,
                                         C k2, int gl, int c, C &nb, C &sz,
                                         C &above) {
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

}  // namespace
