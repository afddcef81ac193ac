// The occ lookups of the kernels that extend FM-index intervals on the
// fused occtab: extend_c, K1's (csrc/seed_machine.cu: K1 and its state
// mode, K12 and K13), and glookup, the group lookup of K1's refill mode and
// K8 (csrc/seed_machine.cu) and of K10a, K10b and K11 (csrc/smem_batch.cu).
//
// The occtab is [n_rows, 4 + NW] uint32: a row's four base counts before
// it, then NW = 8R text words of 16 two-bit codes (R = 1 or 4 disk blocks
// of 128 positions a row; index/fmindex.py::build_occtab).  A group of
// G = 2R threads extends one interval by one base.  extend_c: half the
// group counts B[0..k1], half B[0..k2], each thread WPT = 8 text words (two
// 16-byte loads) plus the row's counts, all issued together, so that both
// lookups cost one memory latency; a shuffle reduction of packed 10-bit
// counts within each half and one exchange between the halves finish
// bwt_extend's counting half.  glookup (below): each thread one 16-byte
// word load an end, the row read once when both ends share it.  Every
// thread of the warp must call either (their shuffles name every thread);
// groups of one warp may extend different intervals.

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

// ---------------------------------------------------------------------------
// The group lookup (glookup) of K8 and of K1's refill mode (csrc/
// seed_machine.cu) and of K10a, K10b and K11 (csrc/smem_batch.cu): one
// interval extended by a
// group of G = 2R threads (2 for R = 1 occtab rows, 8 for R = 4), thread gl
// holding text words 4gl..4gl+3 of a row (positions 64gl..64gl+63).  Both
// ends of the interval (k1 and k2) usually lie in one row: then the row's
// counts and the thread's four words are loaded once and counted for both,
// else each end loads its own.  A thread loads only words that hold
// positions at or below its end; k == -1 and k == seq_len load nothing.
// ---------------------------------------------------------------------------

// A 16-byte read-only load that the compiler keeps in program order with
// the others (it would otherwise sink the counts load below the popcounts,
// a second round trip)
__device__ __forceinline__ uint4 ldg_now(const uint4 *p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// The threads of the caller's group, G a group
__device__ __forceinline__ unsigned group_mask(int lane, int G) {
  return G == 32 ? FULL : ((1u << G) - 1) << (lane & ~(G - 1));
}

// The top `bits` bits of a word (none for bits <= 0, all for bits >= 32)
__device__ __forceinline__ uint32_t top_bits(int bits) {
  return __funnelshift_rc(0u, FULL, (unsigned)(bits > 0 ? bits : 0));
}

// A thread's four words, bit 2f set where field f holds base c (eq) or a
// base above c (gt), two words a register: word 2v in the even bits, word
// 2v + 1 in the odd bits
struct QuadBits {
  uint32_t e01, e23, g01, g23;
};

// gx, gy, gz: the base-c masks of gt = (hi & (gx | (lo & gz))) | (lo & gy)
template <bool ABOVE>
__device__ __forceinline__ QuadBits quad_bits(const uint4 &w, uint32_t pat,
                                              uint32_t gx, uint32_t gy,
                                              uint32_t gz) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t e[4], g[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t x = ~(ws[u] ^ pat);
    e[u] = x & (x >> 1) & M55;
    g[u] = ABOVE ? (((ws[u] >> 1) & (gx | (ws[u] & gz))) | (ws[u] & gy)) & M55
                 : 0u;
  }
  return QuadBits{e[0] | (e[1] << 1), e[2] | (e[3] << 1),
                  g[0] | (g[1] << 1), g[2] | (g[3] << 1)};
}

// The thread's counts of base c (low 16 bits) and, with ABOVE, of the bases
// above c (high 16 bits) among the first bits / 2 positions of its words
template <bool ABOVE>
__device__ __forceinline__ uint32_t quad_count(const QuadBits &q, int bits) {
  const uint32_t m01 = (top_bits(bits) & M55) | (top_bits(bits - 32) & ~M55);
  const uint32_t m23 =
      (top_bits(bits - 64) & M55) | (top_bits(bits - 96) & ~M55);
  uint32_t n = __popc(q.e01 & m01) + __popc(q.e23 & m23);
  if (ABOVE) n |= (__popc(q.g01 & m01) + __popc(q.g23 & m23)) << 16;
  return n;
}

// v[i] of four values, i in [0, 4), by selects (no branch, no local memory)
template <typename T>
__device__ __forceinline__ T sel4(T v0, T v1, T v2, T v3, int i) {
  const T lo = (i & 1) ? v1 : v0, hi = (i & 1) ? v3 : v2;
  return (i & 2) ? hi : lo;
}

// L2[c] and L2[c + 1] for a base c in [0, 4)
template <typename C>
__device__ __forceinline__ C l2_at(const C L2[5], int c) {
  return sel4(L2[0], L2[1], L2[2], L2[3], c);
}
template <typename C>
__device__ __forceinline__ C l2_next(const C L2[5], int c) {
  return sel4(L2[1], L2[2], L2[3], L2[4], c);
}

template <typename C>
__device__ __forceinline__ C count_of(const uint4 &cnt, int c) {
  return (C)sel4(cnt.x, cnt.y, cnt.z, cnt.w, c);
}

template <typename C>
__device__ __forceinline__ C count_above(const uint4 &cnt, int c) {
  return (c < 1 ? (C)cnt.y : 0) + (c < 2 ? (C)cnt.z : 0) +
         (c < 3 ? (C)cnt.w : 0);
}

// bwt_extend's counting half for base c by the caller's group: every thread
// leaves with o1 = occ(k1)[c], o2 = occ(k2)[c] (bwt_occ4, bwt.c:169-186:
// k == -1 gives zeros, k == seq_len the L2 differences) and, with ABOVE,
// ab = the sum over c' > c of occ(k2)[c'] - occ(k1)[c'].  The whole warp
// calls it at once (its shuffles name every thread): a group with nothing
// to extend passes k1 = k2 = -1 and loads nothing.
// A: any argument struct with the occtab, primary and seq_len.
template <typename C, int NW, bool ABOVE, typename A>
__device__ __forceinline__ void glookup(const A &a, const C L2[5], C k1, C k2,
                                        int c, int gl, C &o1, C &o2, C &ab) {
  constexpr int G = NW / 4, RB = NW == 8 ? 0 : 2, PR = 128 << RB;
  const bool z1 = k1 == -1 || k1 == a.seq_len;
  const bool z2 = k2 == -1 || k2 == a.seq_len;
  C kk1 = k1 - (k1 >= a.primary ? 1 : 0), kk2 = k2 - (k2 >= a.primary ? 1 : 0);
  kk1 = kk1 < 0 ? 0 : (kk1 > a.seq_len - 1 ? a.seq_len - 1 : kk1);
  kk2 = kk2 < 0 ? 0 : (kk2 > a.seq_len - 1 ? a.seq_len - 1 : kk2);
  const C r1 = kk1 >> (7 + RB), r2 = kk2 >> (7 + RB);
  const bool same = r1 == r2 && !z1 && !z2;
  // bits of the thread's words at positions up to each end
  const int b1 = 2 * ((int)(kk1 & (PR - 1)) + 1 - 64 * gl);
  const int b2 = 2 * ((int)(kk2 & (PR - 1)) + 1 - 64 * gl);
  const uint4 *row1 = reinterpret_cast<const uint4 *>(
      a.occtab + (size_t)r1 * (4 + NW));
  const uint4 *row2 = reinterpret_cast<const uint4 *>(
      a.occtab + (size_t)r2 * (4 + NW));
  const uint4 zz = make_uint4(0, 0, 0, 0);
  uint4 c1 = zz, c2 = zz, w1 = zz, w2 = zz;
  if (!z1) {
    c1 = ldg_now(row1);
    if (b1 > 0 || (same && b2 > 0)) w1 = ldg_now(row1 + 1 + gl);
  }
  if (!z2 && !same) {
    c2 = ldg_now(row2);
    if (b2 > 0) w2 = ldg_now(row2 + 1 + gl);
  }
  const uint32_t pat = (uint32_t)c * 0x55555555u;
  const uint32_t gx = c < 2 ? FULL : 0u, gy = c == 0 ? FULL : 0u,
                 gz = c == 2 ? FULL : 0u;
  const QuadBits q1 = quad_bits<ABOVE>(w1, pat, gx, gy, gz);
  uint32_t n1 = z1 ? 0u : quad_count<ABOVE>(q1, b1), n2;
  if (same) {
    n2 = quad_count<ABOVE>(q1, b2);
    c2 = c1;
  } else {
    n2 = z2 ? 0u
            : quad_count<ABOVE>(quad_bits<ABOVE>(w2, pat, gx, gy, gz), b2);
  }
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    n1 += __shfl_xor_sync(FULL, n1, off);
    n2 += __shfl_xor_sync(FULL, n2, off);
  }
  o1 = count_of<C>(c1, c) + (C)(n1 & 0xffff);
  o2 = count_of<C>(c2, c) + (C)(n2 & 0xffff);
  const C tot_c = l2_next(L2, c) - l2_at(L2, c);
  if (k1 == a.seq_len) o1 = tot_c;
  if (k2 == a.seq_len) o2 = tot_c;
  if (ABOVE) {
    C a1 = count_above<C>(c1, c) + (C)(n1 >> 16);
    C a2 = count_above<C>(c2, c) + (C)(n2 >> 16);
    const C tot_above = L2[4] - l2_next(L2, c);
    if (k1 == a.seq_len) a1 = tot_above;
    if (k2 == a.seq_len) a2 = tot_above;
    ab = a2 - a1;
  }
}

}  // namespace
