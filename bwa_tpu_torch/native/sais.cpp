// Suffix-array construction by induced sorting (SA-IS), after
// Nong, Zhang & Chan, "Two Efficient Algorithms for Linear Time Suffix
// Array Construction" (IEEE ToC 2011).  Clean-room implementation,
// templated on the index width so the same code serves texts below and
// above 2^31 characters (GRCh38 fwd+rev is ~6.2e9).
//
// Replaces the reference's is.c (<=50Mbp in-memory path) and the whole
// bwt_gen.c/QSufSort.c blockwise constructor: with 125GB of host RAM we
// can afford the full 64-bit suffix array in one shot, which is both
// simpler and much faster than the 2009-era bounded-memory approach.
//
// Exposed C ABI (used via ctypes):
//   sais_u8_i32(text, n, sa_out)  -- n < 2^31
//   sais_u8_i64(text, n, sa_out)  -- arbitrary n
// Both compute the suffix array of text[0..n-1] (plain suffix order with
// an implicit end-of-text sentinel smaller than every character).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Core recursion.  T has a unique smallest sentinel at position n-1.
// K = alphabet size (sentinel is character 0).
template <typename I, typename CharT>
void sais_rec(const CharT *T, I *SA, I n, I K) {
  if (n == 1) { SA[0] = 0; return; }

  // --- classify suffix types: st[i] true iff suffix i is S-type
  std::vector<bool> st(n);
  st[n - 1] = true;
  for (I i = n - 2; i >= 0; --i) {
    st[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && st[i + 1]);
    if (i == 0) break;
  }
  auto is_lms = [&](I i) -> bool { return i > 0 && st[i] && !st[i - 1]; };

  std::vector<I> cnt((size_t)K), bkt((size_t)K);
  for (I c = 0; c < K; ++c) cnt[c] = 0;
  for (I i = 0; i < n; ++i) ++cnt[T[i]];
  auto bkt_heads = [&]() { I s = 0; for (I c = 0; c < K; ++c) { bkt[c] = s; s += cnt[c]; } };
  auto bkt_tails = [&]() { I s = 0; for (I c = 0; c < K; ++c) { s += cnt[c]; bkt[c] = s; } };

  auto induce = [&]() {
    // L-type: left-to-right from bucket heads
    bkt_heads();
    for (I i = 0; i < n; ++i) {
      I j = SA[i];
      if (j > 0 && !st[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
    }
    // S-type: right-to-left from bucket tails
    bkt_tails();
    for (I i = n - 1; i >= 0; --i) {
      I j = SA[i];
      if (j > 0 && st[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
      if (i == 0) break;
    }
  };

  // --- stage 1: sort LMS substrings by one induction round
  for (I i = 0; i < n; ++i) SA[i] = -1;
  bkt_tails();
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[T[i]]] = i;
  induce();

  // compact the (substring-)sorted LMS positions to the front
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (SA[i] > 0 && is_lms(SA[i])) SA[n1++] = SA[i];

  // name LMS substrings; names go to SA[n1 + pos/2]
  for (I i = n1; i < n; ++i) SA[i] = -1;
  I name = 0;
  I prev = -1;
  for (I i = 0; i < n1; ++i) {
    I pos = SA[i];
    bool differ = false;
    if (prev < 0) differ = true;
    else {
      for (I d = 0;; ++d) {
        if (pos + d >= n || prev + d >= n ||
            T[pos + d] != T[prev + d] || st[pos + d] != st[prev + d]) {
          differ = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d)))
          break;  // equal so far and both hit the next LMS boundary
      }
    }
    if (differ) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  // gather names into the reduced string T1 at the tail of SA
  I j = n - 1;
  for (I i = n - 1; i >= n1; --i) {
    if (SA[i] >= 0) SA[j--] = SA[i];
    if (i == n1) break;
  }
  I *T1 = SA + n - n1;
  I *SA1 = SA;

  // --- stage 2: recurse if names collide
  if (name < n1) {
    sais_rec<I, I>(T1, SA1, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) SA1[T1[i]] = i;
  }

  // --- stage 3: induce the full SA from fully sorted LMS suffixes
  // rewrite T1 as the LMS positions in text order
  I k = 0;
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) T1[k++] = i;
  for (I i = 0; i < n1; ++i) SA1[i] = T1[SA1[i]];
  for (I i = n1; i < n; ++i) SA[i] = -1;
  bkt_tails();
  for (I i = n1 - 1; i >= 0; --i) {
    I pos = SA[i];
    SA[i] = -1;
    SA[--bkt[T[pos]]] = pos;
    if (i == 0) break;
  }
  induce();
}

// Wrapper: plain suffix order over byte text without an in-band sentinel.
// We shift the alphabet by +1 and append a 0 sentinel; the resulting
// SA'[0] == n (sentinel) is dropped.
template <typename I>
int sais_u8(const uint8_t *text, I n, I *sa_out) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  std::vector<uint8_t> T((size_t)n + 1);
  for (I i = 0; i < n; ++i) T[i] = (uint8_t)(text[i] + 1);  // requires text < 255
  T[n] = 0;
  std::vector<I> SA((size_t)n + 1);
  sais_rec<I, uint8_t>(T.data(), SA.data(), n + 1, 257);
  std::memcpy(sa_out, SA.data() + 1, sizeof(I) * (size_t)n);
  return 0;
}

// Big-text variant: construct directly into a caller-provided buffer of
// n+1 entries (SA'[0] = n is the sentinel row; callers slice it off as a
// view).  Avoids the extra n-entry allocation + copy of sais_u8 — at
// GRCh38 scale (6.2e9 chars, int64) that second buffer is 50 GB.
template <typename I>
int sais_u8_full(const uint8_t *text, I n, I *sa_full) {
  if (n < 0) return -1;
  if (n == 0) { sa_full[0] = 0; return 0; }
  std::vector<uint8_t> T((size_t)n + 1);
  for (I i = 0; i < n; ++i) T[i] = (uint8_t)(text[i] + 1);  // requires text < 255
  T[n] = 0;
  sais_rec<I, uint8_t>(T.data(), sa_full, n + 1, 257);
  return 0;
}

}  // namespace

extern "C" {

int sais_u8_i32(const uint8_t *text, int32_t n, int32_t *sa_out) {
  return sais_u8<int32_t>(text, n, sa_out);
}

int sais_u8_i64(const uint8_t *text, int64_t n, int64_t *sa_out) {
  return sais_u8<int64_t>(text, n, sa_out);
}

int sais_u8_full_i32(const uint8_t *text, int32_t n, int32_t *sa_full) {
  return sais_u8_full<int32_t>(text, n, sa_full);
}

int sais_u8_full_i64(const uint8_t *text, int64_t n, int64_t *sa_full) {
  return sais_u8_full<int64_t>(text, n, sa_full);
}

}  // extern "C"
