// Shared 64-bit occ decode over the framework's interleaved FM blocks:
// per 128 bases one 64-byte cache line holding 4 int64 counts + 8
// uint32 packed-base words (the reference's bwt.h:73-80 interleaving
// rationale, re-tiled).  All native engines (btgap, btsam, bsw2) use
// these; the 32-bit per-word loops they replaced averaged 4.5
// iterations per decode vs 2.5 here, with 64-bit popcounts.
//
// Word-pair convention: v = (w[2i] << 32) | w[2i+1] puts base 0 of the
// pair at bits 62-63, so a "keep top nkeep bases" mask covers 32 bases
// per iteration.
#pragma once

#include <cstdint>

namespace occ64 {

struct View {
  const uint8_t *inter;
  int64_t seq_len, primary;
  const int64_t *L2;  // [5]
};

static inline const int64_t *blk_cnt(const View &g, int64_t blk) {
  return (const int64_t *)(g.inter + blk * 64);
}
static inline const uint32_t *blk_words(const View &g, int64_t blk) {
  return (const uint32_t *)(g.inter + blk * 64 + 32);
}

static inline uint64_t wpair(const uint32_t *w, int i) {
  return ((uint64_t)w[2 * i] << 32) | w[2 * i + 1];
}

static inline uint64_t keep_top(int nkeep) {  // nkeep in [1,32]
  return nkeep == 32 ? ~0ull : ~((1ull << ((32 - nkeep) << 1)) - 1ull);
}

static const uint64_t VM55 = 0x5555555555555555ull;

// one 32-base word-pair, all four bases, valid-position mask vm
static inline void acc4(uint64_t word, uint64_t vm, int64_t a[4]) {
  uint64_t hi = (word >> 1) & VM55, lo = word & VM55;
  a[3] += __builtin_popcountll(hi & lo);
  a[2] += __builtin_popcountll(hi & ~lo);
  a[1] += __builtin_popcountll(lo & ~hi);
  a[0] += __builtin_popcountll(vm & ~hi & ~lo);
}

// one 32-base word-pair, single base given as xor-selects nh/nl
// (nh = (c&2)?0:~0, nl = (c&1)?0:~0)
static inline int64_t acc1(uint64_t word, uint64_t vm, uint64_t nh,
                           uint64_t nl) {
  uint64_t hi = (word >> 1) & VM55, lo = word & VM55;
  return __builtin_popcountll((hi ^ nh) & (lo ^ nl) & vm);
}

// The decode loops below keep the masked tail pair OUT of the loop (the
// reference's bwt_occ discipline, bwt.c:120-126): full pairs run with a
// constant vm and no per-iteration mask select.

// occ of all four bases at k (bwt_occ4, bwt.c:169-187)
static inline void occ4(const View &g, int64_t k, int64_t cnt[4]) {
  if (k == -1) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  if (k == g.seq_len) {
    for (int c = 0; c < 4; ++c) cnt[c] = g.L2[c + 1] - g.L2[c];
    return;
  }
  if (k >= g.primary) --k;
  int64_t blk = k >> 7;
  int kw = (int)((k >> 5) & 3), kb = (int)(k & 31);
  const uint32_t *w = blk_words(g, blk);
  int64_t a[4] = {0, 0, 0, 0};
  for (int i = 0; i < kw; ++i) acc4(wpair(w, i), VM55, a);
  uint64_t mk = keep_top(kb + 1);
  acc4(wpair(w, kw) & mk, mk & VM55, a);
  const int64_t *cp = blk_cnt(g, blk);
  cnt[0] = cp[0] + a[0];
  cnt[1] = cp[1] + a[1];
  cnt[2] = cp[2] + a[2];
  cnt[3] = cp[3] + a[3];
}

// single-base occ (bwt_occ, bwt.c:107-130)
static inline int64_t occ1(const View &g, int64_t k, int c) {
  if (k == -1) return 0;
  if (k == g.seq_len) return g.L2[c + 1] - g.L2[c];
  if (k >= g.primary) --k;
  int64_t blk = k >> 7;
  int kw = (int)((k >> 5) & 3), kb = (int)(k & 31);
  const uint32_t *w = blk_words(g, blk);
  uint64_t nh = (c & 2) ? 0ull : ~0ull;
  uint64_t nl = (c & 1) ? 0ull : ~0ull;
  int64_t acc = 0;
  for (int i = 0; i < kw; ++i) acc += acc1(wpair(w, i), VM55, nh, nl);
  uint64_t mk = keep_top(kb + 1);
  acc += acc1(wpair(w, kw) & mk, mk & VM55, nh, nl);
  return blk_cnt(g, blk)[c] + acc;
}

// bwt_2occ-style shared-block single-base pair (bwt.c:132-163): one
// block decode serves occ(k, c) and occ(l, c) when both land in the
// same 128-base block
static inline void occ1_pair(const View &g, int64_t k, int64_t l, int c,
                             int64_t *ok, int64_t *ol) {
  int64_t _k = k - (k >= g.primary);
  int64_t _l = l - (l >= g.primary);
  if (k == -1 || l == -1 || k == g.seq_len || l == g.seq_len ||
      (_k >> 7) != (_l >> 7)) {
    *ok = occ1(g, k, c);
    *ol = occ1(g, l, c);
    return;
  }
  int64_t blk = _k >> 7;
  int kw = (int)((_k >> 5) & 3), kb = (int)(_k & 31);
  int lw = (int)((_l >> 5) & 3), lb = (int)(_l & 31);
  const uint32_t *w = blk_words(g, blk);
  uint64_t nh = (c & 2) ? 0ull : ~0ull;
  uint64_t nl = (c & 1) ? 0ull : ~0ull;
  int64_t acc = 0;
  for (int i = 0; i < kw; ++i) acc += acc1(wpair(w, i), VM55, nh, nl);
  // pair kw splits at kb (k <= l, so kw <= lw and kb <= lb if equal)
  uint64_t wkw = wpair(w, kw);
  uint64_t mk = keep_top(kb + 1);
  int64_t acck = acc + acc1(wkw & mk, mk & VM55, nh, nl);
  uint64_t ml = keep_top(lb + 1);
  if (kw < lw) {
    acc += acc1(wkw, VM55, nh, nl);
    for (int i = kw + 1; i < lw; ++i)
      acc += acc1(wpair(w, i), VM55, nh, nl);
    acc += acc1(wpair(w, lw) & ml, ml & VM55, nh, nl);
  } else {
    acc += acc1(wkw & ml, ml & VM55, nh, nl);
  }
  const int64_t base = blk_cnt(g, blk)[c];
  *ok = base + acck;
  *ol = base + acc;
}

// bwt_2occ4-style shared-block pair (bwt.c:189-220): one pass over one
// cache line yields both counts when k and l share a block
static inline void occ4_pair(const View &g, int64_t k, int64_t l,
                             int64_t cntk[4], int64_t cntl[4]) {
  int64_t _k = k - (k >= g.primary);
  int64_t _l = l - (l >= g.primary);
  if (k == -1 || l == -1 || k == g.seq_len || l == g.seq_len ||
      (_l >> 7) != (_k >> 7)) {
    occ4(g, k, cntk);
    occ4(g, l, cntl);
    return;
  }
  int64_t blk = _k >> 7;
  int kw = (int)((_k >> 5) & 3), kb = (int)(_k & 31);
  int lw = (int)((_l >> 5) & 3), lb = (int)(_l & 31);
  const uint32_t *w = blk_words(g, blk);
  const int64_t *cp = blk_cnt(g, blk);
  int64_t a[4] = {0, 0, 0, 0};
  for (int i = 0; i < kw; ++i) acc4(wpair(w, i), VM55, a);
  // pair kw splits at kb (k <= l, so kw <= lw and kb <= lb if equal)
  uint64_t wkw = wpair(w, kw);
  uint64_t mk = keep_top(kb + 1);
  {
    int64_t t[4] = {a[0], a[1], a[2], a[3]};
    acc4(wkw & mk, mk & VM55, t);
    for (int c = 0; c < 4; ++c) cntk[c] = cp[c] + t[c];
  }
  uint64_t ml = keep_top(lb + 1);
  if (kw < lw) {
    acc4(wkw, VM55, a);
    for (int i = kw + 1; i < lw; ++i) acc4(wpair(w, i), VM55, a);
    acc4(wpair(w, lw) & ml, ml & VM55, a);
  } else {
    acc4(wkw & ml, ml & VM55, a);
  }
  for (int c = 0; c < 4; ++c) cntl[c] = cp[c] + a[c];
}

// BWT character at $-removed position x (bwt_B0, bwt.h:71)
static inline int B0(const View &g, int64_t x) {
  uint32_t word = blk_words(g, x >> 7)[(x >> 4) & 7];
  return (word >> ((15 - (x & 15)) << 1)) & 3;
}

// one inverse-Psi step (bwt_invPsi, bwt.c:53-59)
static inline int64_t inv_psi(const View &g, int64_t k) {
  int64_t x = k - (k > g.primary);
  int c = B0(g, x);
  int64_t occ_kc;
  if (k == g.seq_len) {
    occ_kc = g.L2[c + 1] - g.L2[c];
  } else if (k == -1) {
    occ_kc = 0;
  } else {
    occ_kc = occ1(g, k, c);
  }
  int64_t r = g.L2[c] + occ_kc;
  return k == g.primary ? 0 : r;
}

}  // namespace occ64
