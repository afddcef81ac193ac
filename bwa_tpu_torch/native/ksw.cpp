// Host-side scalar affine-gap DP kernels.
//
// These are the executable specification for the batched TPU kernels in
// ops/ksw*.py and serve the low-volume host bookkeeping calls (hit patching,
// final CIGAR for odd shapes).  Semantics must match the reference ksw.c
// cell-for-cell -- including the banded extension's adaptive band/z-drop
// early exits (ksw.c:416-515), the banded global DP's direction encoding
// (ksw.c:540-642), and the striped local SW's segment layout, saturating
// arithmetic and capped lazy-F loop (ksw.c:122-370), all of which are
// observable in the output.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

inline int imax(int a, int b) { return a > b ? a : b; }
inline int imin(int a, int b) { return a < b ? a : b; }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Banded extension from a seed (the behaviour of ksw_extend2).
// Returns the best local score; fills qle/tle (local end), gtle/gscore
// (to-query-end), max_off (max off-diagonal distance at improvements).
//
// Derivation note: re-implemented from the recurrence, but the byte-identity
// contract pins nearly every numeric decision to the reference kernel
// (ksw.c:416-515): the cell evaluation order, the zero-floored local
// recurrence, the band cap computed through a double-precision quotient, the
// adaptive band trim, the tie direction of the row maximum and the z-drop
// discount are all observable in SAM bytes, so they are reproduced
// decision-for-decision.  Where the contract leaves freedom (buffer layout,
// state tracking, scan organization) the code is this repo's own.
int bt_ksw_extend2(int qlen, const uint8_t *query, int tlen, const uint8_t *target,
                   int m, const int8_t *mat, int o_del, int e_del, int o_ins,
                   int e_ins, int w, int end_bonus, int zdrop, int h0,
                   int *_qle, int *_tle, int *_gtle, int *_gscore, int *_max_off) {
  const int open_ext_d = o_del + e_del, open_ext_i = o_ins + e_ins;

  // score profile: prof[c*qlen + j] = mat score of target char c vs query[j]
  std::vector<int8_t> prof((size_t)m * qlen);
  for (int c = 0; c < m; ++c) {
    int8_t *row = &prof[(size_t)c * qlen];
    for (int j = 0; j < qlen; ++j) row[j] = mat[c * m + query[j]];
  }

  // rolling row of paired (h, e) cells — one stream, not two: at the top
  // of a cell body row[j].h holds H(i-1,j-1) (the diagonal just ahead of
  // the cursor) and row[j].e holds E(i,j).  Row -1 is the seed row: h0 at
  // the seed column, decayed leftward by insertions.
  struct Roll { int32_t h, e; };
  std::vector<Roll> row((size_t)qlen + 2, Roll{0, 0});
  row[0].h = h0;
  if (h0 > open_ext_i) row[1].h = h0 - open_ext_i;
  for (int j = 2; j <= qlen; ++j) {
    if (row[j - 1].h <= e_ins) break;
    row[j].h = row[j - 1].h - e_ins;
  }

  // cap the band at the widest gap any positive-scoring alignment could
  // carry (the double-precision rounding here is observable)
  int sc_max = 0;
  for (int a = 0; a < m * m; ++a) sc_max = imax(sc_max, mat[a]);
  auto widest_gap = [&](int open, int ext) {
    return imax((int)((double)(qlen * sc_max + end_bonus - open) / ext + 1.), 1);
  };
  w = imin(w, widest_gap(o_ins, e_ins));
  w = imin(w, widest_gap(o_del, e_del));

  int best = h0, best_i = -1, best_j = -1, off_max = 0;
  int end_i = -1, end_score = -1;  // best score that reaches the query end
  int lo = 0, hi = qlen;           // live band over query columns
  for (int i = 0; i < tlen; ++i) {
    const int8_t *sc = &prof[(size_t)target[i] * qlen];
    lo = imax(lo, i - w);
    hi = imin(hi, imin(i + w + 1, qlen));
    // left neighbour entering the band: column -1 still reaches the seed
    // cell through a run of deletions while the band touches it
    int left = lo == 0 ? imax(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    int f = 0, row_max = 0, row_argmax = -1;
    for (int j = lo; j < hi; ++j) {
      // invariants: row[j] = (H(i-1,j-1), E(i,j)), left = H(i,j-1),
      // f = F(i,j)
      const int diag = row[j].h;
      int e = row[j].e;
      row[j].h = left;
      const int match = diag ? diag + sc[j] : 0;  // no extension out of a dead cell
      const int h = imax(imax(match, e), f);
      left = h;
      // ties move the argmax forward; ternary forms keep this loop
      // branchless (cmov) — an if-update here measurably mispredicts
      row_argmax = h >= row_max ? j : row_argmax;
      row_max = h >= row_max ? h : row_max;
      const int open_d = imax(match - open_ext_d, 0);
      e = imax(e - e_del, open_d);
      row[j].e = e;
      const int open_i = imax(match - open_ext_i, 0);
      f = imax(f - e_ins, open_i);
    }
    row[hi].h = left;
    row[hi].e = 0;
    if (hi == qlen && left >= end_score) { end_score = left; end_i = i; }
    if (row_max == 0) break;  // the whole band died
    if (row_max > best) {
      best = row_max;
      best_i = i;
      best_j = row_argmax;
      off_max = imax(off_max, abs(row_argmax - i));
    } else if (zdrop > 0) {
      // kill the extension once the score fell zdrop below the best after
      // discounting the unavoidable gap between the two cells
      const int di = i - best_i, dj = row_argmax - best_j;
      const int drop = best - row_max -
                       (di > dj ? (di - dj) * e_del : (dj - di) * e_ins);
      if (drop > zdrop) break;
    }
    // adaptive band: trim leading/trailing columns that went dead
    int j = lo;
    while (j < hi && row[j].h == 0 && row[j].e == 0) ++j;
    lo = j;
    j = hi;
    while (j >= lo && row[j].h == 0 && row[j].e == 0) --j;
    hi = imin(j + 2, qlen);
  }
  if (_qle) *_qle = best_j + 1;
  if (_tle) *_tle = best_i + 1;
  if (_gtle) *_gtle = end_i + 1;
  if (_gscore) *_gscore = end_score;
  if (_max_off) *_max_off = off_max;
  return best;
}

#ifdef __AVX2__
// ---------------------------------------------------------------------------
// Anti-diagonal AVX2 fast path for the banded global DP.  Exact: the same
// recurrences and direction-bit rules as the scalar loop below, evaluated
// by anti-diagonals (all band cells of one diagonal are independent, so
// 16 int16 lanes run at once).  In-band values are bounded (gated), junk
// beyond the band is pinned near -30000 by saturating arithmetic and can
// rebound at most one add before mixing with a real operand, so every
// comparison that decides a score or a z-bit orders identically to the
// scalar int32 code.  z is stored by diagonal; the backtrack below walks
// it with (i + j, i - lo[d]) indexing but replicates ksw.c:624-638
// decision-for-decision.  Returns false -> caller runs the scalar path.
static bool global2_diag_avx2(int qlen, const uint8_t *query, int tlen,
                              const uint8_t *target, int m, const int8_t *mat,
                              int o_del, int e_del, int o_ins, int e_ins,
                              int w, int *n_cigar_out, uint32_t *cigar_out,
                              int cigar_cap, int *score_out) {
  if (m != 5 || qlen < 2 || tlen < 2 || w < 4) return false;
  const int A = mat[0], B = mat[1], C = mat[24];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      if (mat[i * 5 + j] != (i == j ? A : B)) return false;
  for (int i = 0; i < 5; ++i)
    if (mat[i * 5 + 4] != C || mat[20 + i] != C) return false;
  if (w < (qlen > tlen ? qlen - tlen : tlen - qlen) + 1) return false;
  {  // int16 range check: all in-band values stay within +-27000
    long bound = (long)(qlen > tlen ? qlen : tlen) + 2;
    long mabs = imax(imax(A < 0 ? -A : A, B < 0 ? -B : B), C < 0 ? -C : C);
    if (bound * (mabs + imax(e_del, e_ins)) + imax(o_del, o_ins) > 27000)
      return false;
  }
  const int16_t NEG = -30000;
  const bool want_cigar = n_cigar_out != nullptr && cigar_out != nullptr;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int ndiag = qlen + tlen - 1;

  // per-diagonal band ranges over i (target row): |2i - d| <= w plus edges
  std::vector<int32_t> lov(ndiag), hiv(ndiag);
  std::vector<int64_t> zoff(ndiag + 1, 0);
  for (int d = 0; d < ndiag; ++d) {
    int lo = 0;
    if (d - (qlen - 1) > lo) lo = d - (qlen - 1);
    if (d > w && (d - w + 1) >> 1 > lo) lo = (d - w + 1) >> 1;
    int hi = tlen - 1;
    if (d < hi) hi = d;
    if ((d + w) >> 1 < hi) hi = (d + w) >> 1;
    if (lo > hi) return false;  // band pinch: let the scalar handle it
    lov[d] = lo;
    hiv[d] = hi;
    zoff[d + 1] = zoff[d] + (hi - lo + 1);
  }
  std::vector<uint8_t> z;
  if (want_cigar) z.resize((size_t)zoff[ndiag] + 64);

  const int PAD = 16, n = tlen + 3 * PAD;
  std::vector<int16_t> bufs((size_t)7 * n, NEG);
  int16_t *base = bufs.data() + PAD;
  int16_t *Hrot[3] = {base, base + n, base + 2 * n};  // Hrot[0]=d-2, [2]=d
  int16_t *Ep = base + 3 * n, *Ec = base + 4 * n;
  int16_t *Fp = base + 5 * n, *Fc = base + 6 * n;
  std::vector<int16_t> t16((size_t)tlen + 2 * PAD, 4),
      q16r((size_t)qlen + 2 * PAD, 4);
  for (int i = 0; i < tlen; ++i) t16[i] = target[i];
  // lane i of diagonal d needs query[d - i] = q16r[qlen - 1 - d + i]
  for (int j = 0; j < qlen; ++j) q16r[j] = query[qlen - 1 - j];

  const __m256i vA = _mm256_set1_epi16((int16_t)A),
                vB = _mm256_set1_epi16((int16_t)B),
                vC = _mm256_set1_epi16((int16_t)C),
                v3 = _mm256_set1_epi16(3),
                vEd = _mm256_set1_epi16((int16_t)e_del),
                vEi = _mm256_set1_epi16((int16_t)e_ins),
                vOEd = _mm256_set1_epi16((int16_t)oe_del),
                vOEi = _mm256_set1_epi16((int16_t)oe_ins),
                k1 = _mm256_set1_epi16(1), k2 = _mm256_set1_epi16(2),
                k4 = _mm256_set1_epi16(4), k32 = _mm256_set1_epi16(0x20);

  int score = 0;
  for (int d = 0; d < ndiag; ++d) {
    const int lo = lov[d], hi = hiv[d];
    int16_t *Hm2 = Hrot[0], *Hc = Hrot[2];
    // boundary patches into the input buffers (scalar init semantics:
    // H(-1,c) = c<0 ? 0 : -(o_ins+e_ins*(c+1)); H(i,-1) = -(o_del+
    // e_del*(i+1)); E/F outside the band = -inf)
    if (lo == 0) {
      int c = d - 1;  // H(-1, d-1) feeds M at lane 0
      Hm2[-1] = c < 0 ? 0 : (c + 1 <= w ? (int16_t)(-(o_ins + e_ins * (c + 1)))
                                        : NEG);
      Ep[-1] = NEG;
    } else if (d - 2 * lo + 1 > w) {
      Ep[lo - 1] = NEG;  // top-left neighbour above the band
    }
    if (hi == d) {
      if (d >= 1) Hm2[d - 1] = (int16_t)(-(o_del + e_del * d));  // H(d-1,-1)
      Fp[d] = NEG;  // row start: F(d, 0) = -inf
    } else if (d - 1 - 2 * hi < -w) {
      Fp[hi] = NEG;  // bottom-left neighbour below the band
    }
    const int qbase = qlen - 1 - d;
    uint8_t *zp = want_cigar ? z.data() + zoff[d] - lo : nullptr;
    for (int i = lo; i <= hi; i += 16) {
      __m256i t = _mm256_loadu_si256((const __m256i *)(t16.data() + i));
      __m256i q =
          _mm256_loadu_si256((const __m256i *)(q16r.data() + qbase + i));
      __m256i eq = _mm256_cmpeq_epi16(t, q);
      __m256i amb = _mm256_or_si256(_mm256_cmpgt_epi16(t, v3),
                                    _mm256_cmpgt_epi16(q, v3));
      __m256i s = _mm256_blendv_epi8(vB, vA, eq);
      s = _mm256_blendv_epi8(s, vC, amb);
      __m256i Hd = _mm256_loadu_si256((const __m256i *)(Hm2 + i - 1));
      __m256i M = _mm256_adds_epi16(Hd, s);
      __m256i e = _mm256_loadu_si256((const __m256i *)(Ep + i - 1));
      __m256i f = _mm256_loadu_si256((const __m256i *)(Fp + i));
      __m256i mask_e = _mm256_cmpgt_epi16(e, M);        // d bit0
      __m256i dsel = _mm256_and_si256(mask_e, k1);
      __m256i h = _mm256_max_epi16(M, e);
      __m256i mask_f = _mm256_cmpgt_epi16(f, h);        // d <- 2
      dsel = _mm256_blendv_epi8(dsel, k2, mask_f);
      h = _mm256_max_epi16(h, f);
      __m256i esub = _mm256_subs_epi16(e, vEd);
      __m256i me = _mm256_subs_epi16(M, vOEd);
      __m256i bit2 = _mm256_and_si256(_mm256_cmpgt_epi16(esub, me), k4);
      __m256i enew = _mm256_max_epi16(esub, me);
      __m256i fsub = _mm256_subs_epi16(f, vEi);
      __m256i mf = _mm256_subs_epi16(M, vOEi);
      __m256i bit5 = _mm256_and_si256(_mm256_cmpgt_epi16(fsub, mf), k32);
      __m256i fnew = _mm256_max_epi16(fsub, mf);
      _mm256_storeu_si256((__m256i *)(Hc + i), h);
      _mm256_storeu_si256((__m256i *)(Ec + i), enew);
      _mm256_storeu_si256((__m256i *)(Fc + i), fnew);
      if (zp) {
        __m256i dd = _mm256_or_si256(_mm256_or_si256(dsel, bit2), bit5);
        dd = _mm256_packus_epi16(dd, dd);
        dd = _mm256_permute4x64_epi64(dd, 0xD8);
        _mm_storeu_si128((__m128i *)(zp + i), _mm256_castsi256_si128(dd));
      }
    }
    if (d == ndiag - 1) score = Hc[tlen - 1];
    int16_t *h0 = Hrot[0];
    Hrot[0] = Hrot[1];
    Hrot[1] = Hrot[2];
    Hrot[2] = h0;
    std::swap(Ep, Ec);
    std::swap(Fp, Fc);
  }

  if (want_cigar) {  // backtrack: ksw.c:624-638 over the diagonal z layout
    std::vector<uint32_t> cig;
    auto push = [&](int op, int len) {
      if (cig.empty() || op != (int)(cig.back() & 0xf))
        cig.push_back((uint32_t)len << 4 | op);
      else
        cig.back() += (uint32_t)len << 4;
    };
    int i = tlen - 1;
    int k = (i + w + 1 < qlen ? i + w + 1 : qlen) - 1;
    int which = 0;
    while (i >= 0 && k >= 0) {
      int d = i + k;
      int col = i - lov[d];
      if (col < 0 || col > hiv[d] - lov[d]) break;  // infeasible band
      which = z[(size_t)zoff[d] + col] >> (which << 1) & 3;
      if (which == 0) {
        push(0, 1);
        --i;
        --k;
      } else if (which == 1) {
        push(2, 1);
        --i;
      } else {
        push(1, 1);
        --k;
      }
    }
    if (i >= 0) push(2, i + 1);
    if (k >= 0) push(1, k + 1);
    int nc = (int)cig.size();
    *n_cigar_out = nc;
    if (nc <= cigar_cap)
      for (int x = 0; x < nc; ++x) cigar_out[x] = cig[nc - 1 - x];
  }
  *score_out = score;
  return true;
}
#endif  // __AVX2__

// ---------------------------------------------------------------------------
// Banded global alignment with backtrack (the behaviour of ksw_global2).
// cigar_out has capacity cigar_cap uint32s; *n_cigar set to the count
// (or the required count if it exceeds the capacity -> caller retries).
//
// Derivation note (same contract as bt_ksw_extend2 above): the direction-bit
// tie rules, the MINUS_INF boundary encoding and the backtrack decision
// order (ksw.c:540-642) are observable through the CIGAR, so the recurrence
// is reproduced decision-for-decision; layout and organization are the
// repo's own, and the AVX2 anti-diagonal fast path above has no reference
// counterpart at all.
int bt_ksw_global2(int qlen, const uint8_t *query, int tlen, const uint8_t *target,
                   int m, const int8_t *mat, int o_del, int e_del, int o_ins,
                   int e_ins, int w, int *n_cigar_out, uint32_t *cigar_out,
                   int cigar_cap) {
  const int MINUS_INF = -0x40000000;
  const int open_ext_d = o_del + e_del, open_ext_i = o_ins + e_ins;
  const bool want_cigar = n_cigar_out != nullptr && cigar_out != nullptr;
  if (n_cigar_out) *n_cigar_out = 0;
#ifdef __AVX2__
  {
    int sc;
    if (global2_diag_avx2(qlen, query, tlen, target, m, mat, o_del, e_del,
                          o_ins, e_ins, w, n_cigar_out, cigar_out, cigar_cap,
                          &sc))
      return sc;
  }
#endif

  const int n_col = imin(qlen, 2 * w + 1);
  std::vector<uint8_t> z;  // per-cell direction bytes, row-major in the band
  if (want_cigar) z.resize((size_t)n_col * tlen);
  std::vector<int8_t> prof((size_t)m * qlen);
  for (int c = 0; c < m; ++c) {
    int8_t *row = &prof[(size_t)c * qlen];
    for (int j = 0; j < qlen; ++j) row[j] = mat[c * m + query[j]];
  }

  // row -1: leading insertions down to the band edge, -inf beyond it
  std::vector<int32_t> H(qlen + 2), E(qlen + 2);
  H[0] = 0;
  E[0] = MINUS_INF;
  for (int j = 1; j <= qlen; ++j) {
    H[j] = j <= w ? -(o_ins + e_ins * j) : MINUS_INF;
    E[j] = MINUS_INF;
  }

  for (int i = 0; i < tlen; ++i) {
    const int8_t *sc = &prof[(size_t)target[i] * qlen];
    const int lo = imax(i - w, 0);
    const int hi = imin(i + w + 1, qlen);
    int32_t f = MINUS_INF;
    int32_t left = lo == 0 ? -(o_del + e_del * (i + 1)) : MINUS_INF;
    uint8_t *zrow = want_cigar ? &z[(size_t)i * n_col] : nullptr;
    for (int j = lo; j < hi; ++j) {
      // invariants: H[j] = H(i-1,j-1), E[j] = E(i,j), left = H(i,j-1),
      // f = F(i,j).  dir bits: 0/1 = H from M, 1/2 in bits 0-1 = from
      // E/F; bit 2 = E extends a deletion; bit 5 = F extends an insertion.
      // ternary forms keep the loop branchless (cmov); dir bit rules:
      // bits 0-1 = H source (0 diag, 1 E, 2 F), bit 2 = E extends a
      // deletion, bit 5 = F extends an insertion
      const int32_t diag = H[j] + sc[j];
      int32_t e = E[j];
      H[j] = left;
      uint8_t dir = diag >= e ? 0 : 1;
      int32_t h = diag >= e ? diag : e;
      dir = h >= f ? dir : 2;
      h = h >= f ? h : f;
      left = h;
      const int32_t og_d = diag - open_ext_d;
      e -= e_del;
      dir |= e > og_d ? 1 << 2 : 0;
      e = e > og_d ? e : og_d;
      E[j] = e;
      const int32_t og_i = diag - open_ext_i;
      f -= e_ins;
      dir |= f > og_i ? 2 << 4 : 0;
      f = f > og_i ? f : og_i;
      if (zrow) zrow[j - lo] = dir;
    }
    H[hi] = left;
    E[hi] = MINUS_INF;
  }
  const int score = H[qlen];

  if (want_cigar) {
    // backtrack (the decision order of ksw.c:624-638); run-length encode
    // in reverse then flip
    std::vector<uint32_t> cig;
    auto push = [&](int op, int len) {
      if (cig.empty() || op != (int)(cig.back() & 0xf))
        cig.push_back((uint32_t)len << 4 | op);
      else
        cig.back() += (uint32_t)len << 4;
    };
    int i = tlen - 1;
    int k = imin(i + w + 1, qlen) - 1;
    int trace = 0;
    while (i >= 0 && k >= 0) {
      const int col = k - imax(i - w, 0);
      if (col < 0 || col >= n_col) break;  // infeasible band: UB in the
                                           // reference; stop cleanly here
      trace = z[(size_t)i * n_col + col] >> (trace << 1) & 3;
      if (trace == 0) { push(0, 1); --i; --k; }
      else if (trace == 1) { push(2, 1); --i; }
      else { push(1, 1); --k; }
    }
    if (i >= 0) push(2, i + 1);
    if (k >= 0) push(1, k + 1);
    const int nc = (int)cig.size();
    *n_cigar_out = nc;
    if (nc <= cigar_cap)
      for (int x = 0; x < nc; ++x) cigar_out[x] = cig[nc - 1 - x];
  }
  return score;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Striped local Smith-Waterman (ksw_u8/ksw_i16/ksw_align2 semantics).
//
// We emulate the 128-bit striped layout lane-for-lane: query profile entry
// for lane position p = i/NL + (i%NL)*slen; the lazy-F pass is capped at 16
// wrap-arounds exactly like the SIMD code, because that cap is observable.

namespace {

struct LocalResult {
  int score, te, qe, score2, te2, tb, qb;
};

// one striped pass; SZ=1 -> uint8 lanes of 16 with +shift bias, SZ=2 ->
// int16 lanes of 8, unbiased
template <int SZ>
LocalResult striped_sw(int qlen, const uint8_t *query, int tlen,
                       const uint8_t *target, int m, const int8_t *mat,
                       int o_del, int e_del, int o_ins, int e_ins, int xtra) {
  LocalResult r{0, -1, -1, -1, -1, -1, -1};
  const int NL = SZ == 1 ? 16 : 8;           // lanes per vector
  const int slen = (qlen + NL - 1) / NL;     // segment length
  int shift = 0, mmax = 0;
  if (SZ == 1) {
    int mn = 127;
    for (int a = 0; a < m * m; ++a) { mn = imin(mn, mat[a]); mmax = imax(mmax, mat[a]); }
    shift = (uint8_t)(256 - mn);             // bias, as uint8_t
  } else {
    for (int a = 0; a < m * m; ++a) mmax = imax(mmax, mat[a]);
  }
  const int minsc = (xtra & 0x10000 /*KSW_XSUBO*/) ? (xtra & 0xffff) : 0x10000;
  const int endsc = (xtra & 0x20000 /*KSW_XSTOP*/) ? (xtra & 0xffff) : 0x10000;
  const int SAT = SZ == 1 ? 255 : 32767;

  // query profile in striped order
  std::vector<int32_t> qp((size_t)m * slen * NL);
  {
    int t = 0;
    for (int a = 0; a < m; ++a) {
      const int8_t *ma = mat + a * m;
      for (int i = 0; i < slen; ++i)
        for (int k = i; k < slen * NL; k += slen)
          qp[t++] = (k >= qlen ? 0 : ma[query[k]]) + (SZ == 1 ? shift : 0);
    }
  }
  auto sat_add = [&](int a, int b) { int v = a + b; return SZ == 1 ? imin(v, SAT) : imin(v, SAT); };
  auto sat_sub = [&](int a, int b) { int v = a - b; return v < 0 ? 0 : v; };

  std::vector<int32_t> H0((size_t)slen * NL, 0), H1((size_t)slen * NL, 0),
      E((size_t)slen * NL, 0), Hmax((size_t)slen * NL, 0);
  std::vector<uint64_t> b;
  int gmax = 0, te = -1;

  for (int i = 0; i < tlen; ++i) {
    const int32_t *S = &qp[(size_t)target[i] * slen * NL];
    std::vector<int32_t> f(NL, 0), maxv(NL, 0), h(NL);
    // h = H0[slen-1] shifted by one lane (lane 0 <- 0)
    h[0] = 0;
    for (int l = 1; l < NL; ++l) h[l] = H0[(size_t)(slen - 1) * NL + l - 1];
    for (int j = 0; j < slen; ++j) {
      for (int l = 0; l < NL; ++l) {
        int hv;
        if (SZ == 1) {
          hv = sat_sub(sat_add(h[l], S[j * NL + l]), shift);
        } else {
          hv = imin(h[l] + S[j * NL + l], SAT);  // adds_epi16 (no negative sat needed here)
        }
        int e = E[j * NL + l];
        hv = imax(hv, e);
        hv = imax(hv, f[l]);
        maxv[l] = imax(maxv[l], hv);
        H1[j * NL + l] = hv;
        e = sat_sub(e, e_del);
        int t2 = sat_sub(hv, o_del + e_del);
        E[j * NL + l] = imax(e, t2);
        f[l] = sat_sub(f[l], e_ins);
        t2 = sat_sub(hv, o_ins + e_ins);
        f[l] = imax(f[l], t2);
        h[l] = H0[j * NL + l];
      }
    }
    // lazy-F: up to 16 wrap-arounds (mirrors ksw.c:201-211,321-331)
    bool done = false;
    for (int k = 0; k < 16 && !done; ++k) {
      // f <<= one lane
      for (int l = NL - 1; l > 0; --l) f[l] = f[l - 1];
      f[0] = 0;
      for (int j = 0; j < slen; ++j) {
        bool all_le = true;
        for (int l = 0; l < NL; ++l) {
          int hv = imax(H1[j * NL + l], f[l]);
          H1[j * NL + l] = hv;
          int hq = sat_sub(hv, o_ins + e_ins);
          f[l] = sat_sub(f[l], e_ins);
          if (SZ == 1 ? (sat_sub(f[l], hq) != 0) : (f[l] > hq)) all_le = false;
        }
        if (all_le) { done = true; break; }
      }
    }
    int im = 0;
    for (int l = 0; l < NL; ++l) im = imax(im, maxv[l]);
    if (im >= minsc) {
      if (b.empty() || (int32_t)(uint32_t)b.back() + 1 != i)
        b.push_back((uint64_t)im << 32 | (uint32_t)i);
      else if ((int)(b.back() >> 32) < im)
        b.back() = (uint64_t)im << 32 | (uint32_t)i;
    }
    if (im > gmax) {
      gmax = im; te = i;
      Hmax = H1;
      if ((SZ == 1 && gmax + shift >= 255) || gmax >= endsc) break;
    }
    std::swap(H0, H1);
  }

  if (SZ == 1) {
    r.score = gmax + shift < 255 ? gmax : 255;
    r.te = te;
    if (r.score == 255) return r;  // qe/score2 not recovered at saturation
  } else {
    r.score = gmax;
    r.te = te;
  }
  {
    int best = -1;
    const int tot = slen * NL;
    for (int i = 0; i < tot; ++i) {
      int v = Hmax[(size_t)(i / NL) * NL + i % NL];
      // flat index i walks lanes fastest in the C code's byte order:
      // value at byte i is segment j=i/NL? No: memory order is
      // [vector j][lane l]; i = j*NL + l; query position = i/NL + (i%NL)*slen
      int qpos = i / NL + (i % NL) * slen;
      if (v > best) { best = v; r.qe = qpos; }
      else if (v == best && qpos < r.qe) r.qe = qpos;
    }
    if (!b.empty()) {
      int ii = (r.score + mmax - 1) / mmax;
      int low = te - ii, high = te + ii;
      for (size_t x = 0; x < b.size(); ++x) {
        int e = (int32_t)(uint32_t)b[x];
        if ((e < low || e > high) && (int)(b[x] >> 32) > r.score2) {
          r.score2 = (int)(b[x] >> 32);
          r.te2 = e;
        }
      }
    }
  }
  return r;
}

#if defined(__SSE2__)
#include <emmintrin.h>

// SSE2 striped SW — the same uint8/int16 lane arithmetic as striped_sw
// above (which is the exactness spec), vectorized 16/8 lanes per op.
template <int SZ>
LocalResult striped_sw_simd(int qlen, const uint8_t *query, int tlen,
                            const uint8_t *target, int m, const int8_t *mat,
                            int o_del, int e_del, int o_ins, int e_ins,
                            int xtra) {
  LocalResult r{0, -1, -1, -1, -1, -1, -1};
  const int NL = SZ == 1 ? 16 : 8;
  const int slen = (qlen + NL - 1) / NL;
  int shift = 0, mmax = 0;
  if (SZ == 1) {
    int mn = 127;
    for (int a = 0; a < m * m; ++a) { mn = imin(mn, mat[a]); mmax = imax(mmax, mat[a]); }
    shift = (uint8_t)(256 - mn);
  } else {
    for (int a = 0; a < m * m; ++a) mmax = imax(mmax, mat[a]);
  }
  const int minsc = (xtra & 0x10000) ? (xtra & 0xffff) : 0x10000;
  const int endsc = (xtra & 0x20000) ? (xtra & 0xffff) : 0x10000;

  // scratch reused across calls (flt_seeds/mate-SW issue tens of
  // thousands of calls per batch; per-call malloc+value-init of five
  // vectors was measurable).  H0/E are re-zeroed below; qp/H1/Hmax are
  // fully overwritten before any read.
  static thread_local std::vector<__m128i> qp, H0, H1, E, Hmax;
  qp.resize((size_t)m * slen);
  H0.resize(slen);
  H1.resize(slen);
  E.resize(slen);
  Hmax.resize(slen);
  {  // striped query profile
    if (SZ == 1) {
      int8_t *t = (int8_t *)qp.data();
      size_t p = 0;
      for (int a = 0; a < m; ++a) {
        const int8_t *ma = mat + a * m;
        for (int i = 0; i < slen; ++i)
          for (int k = i; k < slen * NL; k += slen)
            t[p++] = (int8_t)((k >= qlen ? 0 : ma[query[k]]) + shift);
      }
    } else {
      int16_t *t = (int16_t *)qp.data();
      size_t p = 0;
      for (int a = 0; a < m; ++a) {
        const int8_t *ma = mat + a * m;
        for (int i = 0; i < slen; ++i)
          for (int k = i; k < slen * NL; k += slen)
            t[p++] = k >= qlen ? 0 : ma[query[k]];
      }
    }
  }
  const __m128i zero = _mm_setzero_si128();
  const __m128i shift_v = _mm_set1_epi8((char)shift);
  const __m128i oe_del_v = SZ == 1 ? _mm_set1_epi8((char)(o_del + e_del))
                                   : _mm_set1_epi16(o_del + e_del);
  const __m128i e_del_v = SZ == 1 ? _mm_set1_epi8((char)e_del)
                                  : _mm_set1_epi16(e_del);
  const __m128i oe_ins_v = SZ == 1 ? _mm_set1_epi8((char)(o_ins + e_ins))
                                   : _mm_set1_epi16(o_ins + e_ins);
  const __m128i e_ins_v = SZ == 1 ? _mm_set1_epi8((char)e_ins)
                                  : _mm_set1_epi16(e_ins);
  std::fill(H0.begin(), H0.end(), zero);
  std::fill(E.begin(), E.end(), zero);
  static thread_local std::vector<uint64_t> b;
  b.clear();
  int gmax = 0, te = -1;

  for (int i = 0; i < tlen; ++i) {
    const __m128i *S = &qp[(size_t)target[i] * slen];
    __m128i f = zero, maxv = zero;
    __m128i h = _mm_slli_si128(H0[slen - 1], SZ);  // shift one lane
    for (int j = 0; j < slen; ++j) {
      __m128i e = E[j], hv;
      if (SZ == 1) {
        hv = _mm_subs_epu8(_mm_adds_epu8(h, S[j]), shift_v);
        hv = _mm_max_epu8(hv, e);
        hv = _mm_max_epu8(hv, f);
        maxv = _mm_max_epu8(maxv, hv);
        H1[j] = hv;
        e = _mm_subs_epu8(e, e_del_v);
        __m128i t2 = _mm_subs_epu8(hv, oe_del_v);
        E[j] = _mm_max_epu8(e, t2);
        f = _mm_subs_epu8(f, e_ins_v);
        t2 = _mm_subs_epu8(hv, oe_ins_v);
        f = _mm_max_epu8(f, t2);
      } else {
        hv = _mm_adds_epi16(h, S[j]);
        hv = _mm_max_epi16(hv, e);
        hv = _mm_max_epi16(hv, f);
        maxv = _mm_max_epi16(maxv, hv);
        H1[j] = hv;
        e = _mm_subs_epu16(e, e_del_v);
        __m128i t2 = _mm_subs_epu16(hv, oe_del_v);
        E[j] = _mm_max_epi16(e, t2);
        f = _mm_subs_epu16(f, e_ins_v);
        t2 = _mm_subs_epu16(hv, oe_ins_v);
        f = _mm_max_epi16(f, t2);
      }
      h = H0[j];
    }
    for (int k = 0; k < 16; ++k) {  // lazy-F (cap observable: 16 rounds)
      f = _mm_slli_si128(f, SZ);
      bool done = false;
      for (int j = 0; j < slen; ++j) {
        if (SZ == 1) {
          H1[j] = _mm_max_epu8(H1[j], f);
          __m128i hq = _mm_subs_epu8(H1[j], oe_ins_v);
          f = _mm_subs_epu8(f, e_ins_v);
          __m128i cmp = _mm_cmpeq_epi8(_mm_subs_epu8(f, hq), zero);
          if (_mm_movemask_epi8(cmp) == 0xffff) { done = true; break; }
        } else {
          H1[j] = _mm_max_epi16(H1[j], f);
          __m128i hq = _mm_subs_epu16(H1[j], oe_ins_v);
          f = _mm_subs_epu16(f, e_ins_v);
          __m128i cmp = _mm_cmpgt_epi16(f, hq);
          if (_mm_movemask_epi8(cmp) == 0) { done = true; break; }
        }
      }
      if (done) break;
    }
    int im = 0;
    if (SZ == 1) {
      const uint8_t *mv = (const uint8_t *)&maxv;
      for (int l = 0; l < 16; ++l) im = imax(im, mv[l]);
    } else {
      const int16_t *mv = (const int16_t *)&maxv;
      for (int l = 0; l < 8; ++l) im = imax(im, mv[l]);
    }
    if (im >= minsc) {
      if (b.empty() || (int32_t)(uint32_t)b.back() + 1 != i)
        b.push_back((uint64_t)im << 32 | (uint32_t)i);
      else if ((int)(b.back() >> 32) < im)
        b.back() = (uint64_t)im << 32 | (uint32_t)i;
    }
    if (im > gmax) {
      gmax = im; te = i;
      Hmax = H1;
      if ((SZ == 1 && gmax + shift >= 255) || gmax >= endsc) break;
    }
    std::swap(H0, H1);
  }

  // if no row ever improved gmax, Hmax was never assigned this call —
  // restore the fresh-allocation semantics the qe scan below expects
  if (te < 0) std::fill(Hmax.begin(), Hmax.end(), zero);
  if (SZ == 1) {
    r.score = gmax + shift < 255 ? gmax : 255;
    r.te = te;
    if (r.score == 255) return r;
  } else {
    r.score = gmax;
    r.te = te;
  }
  {
    int best = -1;
    const int tot = slen * NL;
    for (int i2 = 0; i2 < tot; ++i2) {
      int v = SZ == 1 ? ((const uint8_t *)Hmax.data())[i2]
                      : ((const int16_t *)Hmax.data())[i2];
      int qpos = i2 / NL + (i2 % NL) * slen;
      if (v > best) { best = v; r.qe = qpos; }
      else if (v == best && qpos < r.qe) r.qe = qpos;
    }
    if (!b.empty()) {
      int ii = (r.score + mmax - 1) / mmax;
      int low = te - ii, high = te + ii;
      for (size_t x = 0; x < b.size(); ++x) {
        int e = (int32_t)(uint32_t)b[x];
        if ((e < low || e > high) && (int)(b[x] >> 32) > r.score2) {
          r.score2 = (int)(b[x] >> 32);
          r.te2 = e;
        }
      }
    }
  }
  return r;
}
#endif  // __SSE2__

}  // namespace

// out[7] = {score, te, qe, score2, te2, tb, qb}
extern "C" void bt_ksw_align2(int qlen, uint8_t *query, int tlen, uint8_t *target, int m,
                   const int8_t *mat, int o_del, int e_del, int o_ins, int e_ins,
                   int use_byte, int use_start, int use_subo, int use_stop,
                   int thres, int *out) {
  int xtra = (use_subo ? 0x10000 : 0) | (use_stop ? 0x20000 : 0) |
             ((use_subo || use_stop) ? (thres & 0xffff) : 0);
#if defined(__SSE2__)
  LocalResult r = use_byte
      ? striped_sw_simd<1>(qlen, query, tlen, target, m, mat, o_del, e_del, o_ins, e_ins, xtra)
      : striped_sw_simd<2>(qlen, query, tlen, target, m, mat, o_del, e_del, o_ins, e_ins, xtra);
#else
  LocalResult r = use_byte
      ? striped_sw<1>(qlen, query, tlen, target, m, mat, o_del, e_del, o_ins, e_ins, xtra)
      : striped_sw<2>(qlen, query, tlen, target, m, mat, o_del, e_del, o_ins, e_ins, xtra);
#endif
  // start-position recovery by reversed re-alignment (ksw.c:392-400)
  if (use_start && !(use_subo && r.score < thres)) {
    // reference reverses the first qe+1/te+1 chars IN PLACE and reruns with
    // the full tlen (ksw.c:393-396); query length becomes qe+1
    std::vector<uint8_t> rq(query, query + r.qe + 1), rt(target, target + tlen);
    for (int i = 0; i < (int)rq.size() / 2; ++i) std::swap(rq[i], rq[rq.size() - 1 - i]);
    for (int i = 0; i < (r.te + 1) / 2; ++i) std::swap(rt[i], rt[r.te - i]);
    int xtra2 = 0x20000 | r.score;
#if defined(__SSE2__)
    LocalResult rr = use_byte
        ? striped_sw_simd<1>(r.qe + 1, rq.data(), tlen, rt.data(), m, mat, o_del, e_del, o_ins, e_ins, xtra2)
        : striped_sw_simd<2>(r.qe + 1, rq.data(), tlen, rt.data(), m, mat, o_del, e_del, o_ins, e_ins, xtra2);
#else
    LocalResult rr = use_byte
        ? striped_sw<1>(r.qe + 1, rq.data(), tlen, rt.data(), m, mat, o_del, e_del, o_ins, e_ins, xtra2)
        : striped_sw<2>(r.qe + 1, rq.data(), tlen, rt.data(), m, mat, o_del, e_del, o_ins, e_ins, xtra2);
#endif
    if (r.score == rr.score) { r.tb = r.te - rr.te; r.qb = r.qe - rr.qe; }
  }
  out[0] = r.score; out[1] = r.te; out[2] = r.qe; out[3] = r.score2;
  out[4] = r.te2; out[5] = r.tb; out[6] = r.qb;
}
