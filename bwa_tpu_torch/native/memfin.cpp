// BWA-MEM host finalization in C++: everything after device seeding for
// the single-end path — chaining, chain filtering, seed extension,
// dedup/patch, primary marking, mapQ, CIGAR/MD/NM and SAM text — for a
// whole read batch in one call.
//
// This is a native port of the (oracle-byte-exact) Python modules
// bwa_tpu/mem/{chain,extend,primary,cigar,sam}.py; its output is asserted
// byte-identical against both the Python path and the reference bwa in
// tests.  The Python implementations remain the readable spec; this file
// exists because per-read bookkeeping in Python costs ~0.5 ms/read while
// the same work here costs ~10 us.

#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "trace.h"

namespace {

// ---------------------------------------------------------------------------
// options / reference view
// ---------------------------------------------------------------------------

struct MemOpt {  // subset of mem_opt_t used by the finalize stages
  int a, b, o_del, e_del, o_ins, e_ins;
  int pen_clip5, pen_clip3, w, zdrop;
  int T, flag, min_seed_len, min_chain_weight, max_chain_extend;
  int max_occ, max_chain_gap;
  double mask_level, drop_ratio, XA_drop_ratio, mask_level_redun;
  double mapQ_coef_len, mapQ_coef_fac;
  int max_XA_hits, max_XA_hits_alt;
  int pen_unpaired, max_matesw, max_ins;  // PE stages
  int8_t mat[25];
};

// flag bits (bwamem.h)
enum {
  MEM_F_NOPAIRING = 0x4,
  MEM_F_ALL = 0x8,
  MEM_F_NO_MULTI = 0x10,
  MEM_F_NO_RESCUE = 0x20,
  MEM_F_SOFTCLIP = 0x200,
  MEM_F_PRIMARY5 = 0x800,
  MEM_F_KEEP_SUPP_MAPQ = 0x1000,
  MEM_F_XB = 0x2000,
};

struct ContigView {
  const int64_t *offset;   // [n]
  const int32_t *len;      // [n]
  const uint8_t *is_alt;   // [n]
  const char *names;       // concatenated, NUL-separated
  const int32_t *name_off; // [n]
  int32_t n;
};

struct RefView {
  const uint8_t *pac;  // packed forward 2-bit
  int64_t l_pac;
  ContigView bns;
};

inline int pac_at(const RefView &r, int64_t k) {
  return r.pac[k >> 2] >> ((~k & 3) << 1) & 3;
}

// bns_get_seq (bntseq.c:403-424) into out; returns length or -1
inline int64_t get_seq(const RefView &r, int64_t beg, int64_t end,
                       std::vector<uint8_t> &out) {
  if (end < beg) std::swap(beg, end);
  if (end > r.l_pac << 1) end = r.l_pac << 1;
  if (beg < 0) beg = 0;
  if (beg >= r.l_pac || end <= r.l_pac) {
    out.resize(end - beg);
    if (beg >= r.l_pac) {
      int64_t beg_f = (r.l_pac << 1) - 1 - end;
      int64_t end_f = (r.l_pac << 1) - 1 - beg;
      int64_t l = 0;
      for (int64_t k = end_f; k > beg_f; --k) out[l++] = 3 - pac_at(r, k);
    } else {
      int64_t l = 0;
      for (int64_t k = beg; k < end; ++k) out[l++] = pac_at(r, k);
    }
    return (int64_t)out.size();
  }
  out.clear();
  return 0;
}

inline int pos2rid(const RefView &r, int64_t pos_f) {
  if (pos_f >= r.l_pac) return -1;
  int left = 0, mid = 0, right = r.bns.n;
  while (left < right) {
    mid = (left + right) >> 1;
    if (pos_f >= r.bns.offset[mid]) {
      if (mid == r.bns.n - 1) break;
      if (pos_f < r.bns.offset[mid + 1]) break;
      left = mid + 1;
    } else right = mid;
  }
  return mid;
}

inline int64_t depos(const RefView &r, int64_t pos, int *is_rev) {
  *is_rev = pos >= r.l_pac;
  return *is_rev ? (r.l_pac << 1) - 1 - pos : pos;
}

inline int intv2rid(const RefView &r, int64_t rb, int64_t re) {
  if (rb < r.l_pac && re > r.l_pac) return -2;
  int is_rev;
  int rid_b = pos2rid(r, depos(r, rb, &is_rev));
  int rid_e = rb < re ? pos2rid(r, depos(r, re - 1, &is_rev)) : rid_b;
  return rid_b == rid_e ? rid_b : -1;
}

// bns_fetch_seq (bntseq.c:426-451)
inline void fetch_seq(const RefView &r, int64_t &beg, int64_t mid,
                      int64_t &end, int *rid, std::vector<uint8_t> &out) {
  if (end < beg) std::swap(beg, end);
  int is_rev;
  int64_t pos_f = depos(r, mid, &is_rev);
  *rid = pos2rid(r, pos_f);
  int64_t far_beg = r.bns.offset[*rid];
  int64_t far_end = far_beg + r.bns.len[*rid];
  if (is_rev) {
    int64_t tmp = far_beg;
    far_beg = (r.l_pac << 1) - far_end;
    far_end = (r.l_pac << 1) - tmp;
  }
  beg = beg > far_beg ? beg : far_beg;
  end = end < far_end ? end : far_end;
  get_seq(r, beg, end, out);
}

// ---------------------------------------------------------------------------
// ksort.h-identical introsort (tie permutation is observable)
// ---------------------------------------------------------------------------

template <typename T, typename LT>
void insertsort_(T *s, T *t, LT lt) {
  for (T *i = s + 1; i < t; ++i)
    for (T *j = i; j > s && lt(*j, *(j - 1)); --j) std::swap(*j, *(j - 1));
}

template <typename T, typename LT>
void combsort_(size_t n, T *a, LT lt) {
  const double shrink = 1.2473309501039786540366528676643;
  size_t gap = n;
  bool do_swap;
  do {
    if (gap > 2) {
      gap = (size_t)(gap / shrink);
      if (gap == 9 || gap == 10) gap = 11;
    }
    do_swap = false;
    for (T *i = a; i < a + n - gap; ++i) {
      T *j = i + gap;
      if (lt(*j, *i)) { std::swap(*i, *j); do_swap = true; }
    }
  } while (do_swap || gap > 2);
  if (gap != 1) insertsort_(a, a + n, lt);
}

template <typename T, typename LT>
void ks_introsort(size_t n, T *a, LT lt) {
  if (n < 1) return;
  if (n == 2) {
    if (lt(a[1], a[0])) std::swap(a[0], a[1]);
    return;
  }
  int d = 2;
  while ((1ul << d) < n) ++d;
  struct Frame { T *left, *right; int depth; };
  std::vector<Frame> stack;
  T *s = a, *t = a + n - 1;
  d <<= 1;
  for (;;) {
    if (s < t) {
      if (--d == 0) {
        combsort_(t - s + 1, s, lt);
        t = s;
        continue;
      }
      T *i = s, *j = t, *k = i + ((j - i) >> 1) + 1;
      if (lt(*k, *i)) {
        if (lt(*k, *j)) k = j;
      } else k = lt(*j, *i) ? i : j;
      T rp = *k;
      if (k != t) std::swap(*k, *t);
      for (;;) {
        do ++i; while (lt(*i, rp));
        do --j; while (i <= j && lt(rp, *j));
        if (j <= i) break;
        std::swap(*i, *j);
      }
      std::swap(*i, *t);
      if (i - s > t - i) {
        if (i - s > 16) stack.push_back({s, i - 1, d});
        s = t - i > 16 ? i + 1 : t;
      } else {
        if (t - i > 16) stack.push_back({i + 1, t, d});
        t = i - s > 16 ? i - 1 : s;
      }
    } else {
      if (stack.empty()) {
        insertsort_(a, a + n, lt);
        return;
      }
      s = stack.back().left; t = stack.back().right; d = stack.back().depth;
      stack.pop_back();
    }
  }
}

inline uint64_t hash_64(uint64_t key) {
  key += ~(key << 32);
  key ^= key >> 22;
  key += ~(key << 13);
  key ^= key >> 8;
  key += key << 3;
  key ^= key >> 15;
  key += ~(key << 27);
  key ^= key >> 31;
  return key;
}

// ---------------------------------------------------------------------------
// DP kernels (from ksw.cpp, same TU-external C symbols)
// ---------------------------------------------------------------------------

extern "C" int bt_ksw_extend2(int, const uint8_t *, int, const uint8_t *,
                              int, const int8_t *, int, int, int, int, int,
                              int, int, int, int *, int *, int *, int *,
                              int *);
extern "C" int bt_ksw_global2(int, const uint8_t *, int, const uint8_t *,
                              int, const int8_t *, int, int, int, int, int,
                              int *, uint32_t *, int);
extern "C" void bt_ksw_align2(int, uint8_t *, int, uint8_t *, int,
                              const int8_t *, int, int, int, int, int, int,
                              int, int, int, int *);

// ---------------------------------------------------------------------------
// pipeline data
// ---------------------------------------------------------------------------

struct Seed { int64_t rbeg; int32_t qbeg, len, score; };

struct Chain {
  int rid;
  int64_t pos;
  std::vector<Seed> seeds;
  int is_alt = 0;
  uint32_t w = 0;
  int kept = 0, first = -1;
  double frac_rep = 0.0;
};

struct Reg {
  int64_t rb = 0, re = 0;
  int qb = 0, qe = 0, rid = -1;
  int score = 0, truesc = 0, sub = 0, alt_sc = 0, csub = 0, sub_n = 0;
  int w = 0, seedcov = 0, secondary = -1, secondary_all = -1;
  int seedlen0 = 0, n_comp = 1, is_alt = 0;
  double frac_rep = 0.0;
  uint64_t hash = 0;
};

const int INT_MAX_ = 0x7fffffff;

// ---------------------------------------------------------------------------
// chaining (bwamem.c:216-341)
// ---------------------------------------------------------------------------

int chain_weight(const Chain &c) {
  int64_t end;
  int w = 0, tmp;
  for (int which = 0; which < 2; ++which) {
    int tot = 0;
    end = 0;
    for (const Seed &s : c.seeds) {
      int64_t beg = which == 0 ? s.qbeg : s.rbeg;
      if (beg >= end) tot += s.len;
      else if (beg + s.len > end) tot += beg + s.len - end;
      end = end > beg + s.len ? end : beg + s.len;
    }
    if (which == 0) tmp = tot, w = 0;
    else w = tot < tmp ? tot : tmp;
  }
  return w < (1 << 30) ? w : (1 << 30) - 1;
}

bool test_and_merge(const MemOpt &o, int64_t l_pac, Chain &c, const Seed &p,
                    int seed_rid) {
  const Seed &last = c.seeds.back();
  int64_t qend = last.qbeg + last.len, rend = last.rbeg + last.len;
  if (seed_rid != c.rid) return false;
  if (p.qbeg >= c.seeds[0].qbeg && p.qbeg + p.len <= qend &&
      p.rbeg >= c.seeds[0].rbeg && p.rbeg + p.len <= rend)
    return true;
  if ((last.rbeg < l_pac || c.seeds[0].rbeg < l_pac) && p.rbeg >= l_pac)
    return false;
  int64_t x = p.qbeg - last.qbeg, y = p.rbeg - last.rbeg;
  if (y >= 0 && x - y <= o.w && y - x <= o.w &&
      x - last.len < o.max_chain_gap && y - last.len < o.max_chain_gap) {
    c.seeds.push_back(p);
    return true;
  }
  return false;
}

// per-read chaining; ivs arrays describe the read's intervals; rbegs is the
// flattened occurrence positions with per-interval extents
void chain_read(const MemOpt &o, const RefView &r, int l_query, int n_iv,
                const int64_t *iv_x2, const int32_t *iv_start,
                const int32_t *iv_end, const int64_t *rbegs,
                const int32_t *rbeg_off, std::vector<Chain> &chains) {
  int64_t l_pac = r.l_pac;
  if (l_query < o.min_seed_len) return;
  // frac_rep
  int64_t b = 0, e = 0, l_rep = 0;
  for (int i = 0; i < n_iv; ++i) {
    if (iv_x2[i] <= o.max_occ) continue;
    int sb = iv_start[i], se = iv_end[i];
    if (sb > e) l_rep += e - b, b = sb, e = se;
    else e = e > se ? e : se;
  }
  l_rep += e - b;
  // sorted-by-pos chain list emulating the kbtree
  std::vector<int64_t> keys;
  for (int i = 0; i < n_iv; ++i) {
    int slen = iv_end[i] - iv_start[i];
    for (int32_t t = rbeg_off[i]; t < rbeg_off[i + 1]; ++t) {
      Seed s{rbegs[t], iv_start[i], slen, slen};
      int rid = intv2rid(r, s.rbeg, s.rbeg + s.len);
      if (rid < 0) continue;
      bool to_add = false;
      if (!chains.empty()) {
        // lower = rightmost chain with pos <= rbeg
        int lo = 0, hi = (int)keys.size();
        while (lo < hi) {
          int mid = (lo + hi) >> 1;
          if (keys[mid] <= s.rbeg) lo = mid + 1;
          else hi = mid;
        }
        int idx = lo - 1;
        if (idx < 0 || !test_and_merge(o, l_pac, chains[idx], s, rid))
          to_add = true;
      } else to_add = true;
      if (to_add) {
        int lo = 0, hi = (int)keys.size();
        while (lo < hi) {
          int mid = (lo + hi) >> 1;
          if (keys[mid] <= s.rbeg) lo = mid + 1;
          else hi = mid;
        }
        Chain c;
        c.rid = rid;
        c.pos = s.rbeg;
        c.seeds.push_back(s);
        c.is_alt = r.bns.is_alt[rid] ? 1 : 0;
        keys.insert(keys.begin() + lo, s.rbeg);
        chains.insert(chains.begin() + lo, std::move(c));
      }
    }
  }
  for (Chain &c : chains) c.frac_rep = (double)l_rep / l_query;
}

void chain_flt(const MemOpt &o, std::vector<Chain> &chains) {
  if (chains.empty()) return;
  std::vector<Chain> a;
  for (Chain &c : chains) {
    c.first = -1;
    c.kept = 0;
    c.w = chain_weight(c);
    if ((int)c.w >= o.min_chain_weight) a.push_back(std::move(c));
  }
  chains.clear();
  if (a.empty()) return;
  ks_introsort(a.size(), a.data(),
               [](const Chain &x, const Chain &y) { return x.w > y.w; });
  a[0].kept = 3;
  std::vector<int> kept_idx{0};
  auto chn_beg = [](const Chain &c) { return c.seeds[0].qbeg; };
  auto chn_end = [](const Chain &c) {
    return c.seeds.back().qbeg + c.seeds.back().len;
  };
  for (size_t i = 1; i < a.size(); ++i) {
    bool large_ovlp = false, drop = false;
    for (int j : kept_idx) {
      int b_max = std::max(chn_beg(a[j]), chn_beg(a[i]));
      int e_min = std::min(chn_end(a[j]), chn_end(a[i]));
      if (e_min > b_max && (!a[j].is_alt || a[i].is_alt)) {
        int li = chn_end(a[i]) - chn_beg(a[i]);
        int lj = chn_end(a[j]) - chn_beg(a[j]);
        int min_l = std::min(li, lj);
        if (e_min - b_max >= min_l * o.mask_level &&
            min_l < o.max_chain_gap) {
          large_ovlp = true;
          if (a[j].first < 0) a[j].first = (int)i;
          if (a[i].w < a[j].w * o.drop_ratio &&
              (int)(a[j].w - a[i].w) >= o.min_seed_len * 2) {
            drop = true;
            break;
          }
        }
      }
    }
    if (!drop) {
      kept_idx.push_back((int)i);
      a[i].kept = large_ovlp ? 2 : 3;
    }
  }
  for (int j : kept_idx)
    if (a[j].first >= 0) a[a[j].first].kept = 1;
  size_t i = 0;
  int k = 0;
  for (; i < a.size(); ++i) {
    if (a[i].kept == 0 || a[i].kept == 3) continue;
    if (++k >= o.max_chain_extend) break;
  }
  for (; i < a.size(); ++i)
    if (a[i].kept < 3) a[i].kept = 0;
  for (Chain &c : a)
    if (c.kept != 0) chains.push_back(std::move(c));
}

// mem_flt_chained_seeds (bwamem.c:597-641); long reads only
void flt_chained_seeds(const MemOpt &o, const RefView &r, int l_query,
                       const uint8_t *q, std::vector<Chain> &chains) {
  const int MEM_SHORT_EXT = 50, MEM_SHORT_LEN = 200;
  double min_l = o.min_chain_weight
                     ? 1.1 * o.min_chain_weight
                     : 5.5 * log((double)l_query);
  if (min_l > 0.05 * l_query) return;
  int min_hsp = (int)(o.a * min_l + 0.499);
  for (Chain &c : chains) {
    std::vector<Seed> kept;
    for (Seed &s : c.seeds) {
      int score = -1;
      if (s.len < MEM_SHORT_LEN) {
        int qb = std::max(s.qbeg - MEM_SHORT_EXT, 0);
        int qe = std::min(s.qbeg + s.len + MEM_SHORT_EXT, l_query);
        int64_t rb = std::max(s.rbeg - MEM_SHORT_EXT, (int64_t)0);
        int64_t re = std::min(s.rbeg + s.len + MEM_SHORT_EXT, r.l_pac << 1);
        int64_t mid = (s.rbeg + s.rbeg + s.len) >> 1;
        if (rb < r.l_pac && r.l_pac < re) {
          if (mid < r.l_pac) re = r.l_pac;
          else rb = r.l_pac;
        }
        if (!(qe - qb >= MEM_SHORT_LEN || re - rb >= MEM_SHORT_LEN)) {
          int rid;
          std::vector<uint8_t> rseq;
          fetch_seq(r, rb, mid, re, &rid, rseq);
          std::vector<uint8_t> qv(q + qb, q + qe);
          int out[7];
          bt_ksw_align2(qe - qb, qv.data(), (int)rseq.size(), rseq.data(), 5,
                        o.mat, o.o_del, o.e_del, o.o_ins, o.e_ins,
                        /*byte*/ 0, /*start*/ 1, /*subo*/ 0, /*stop*/ 0, 0,
                        out);
          score = out[0];
        }
      }
      s.score = score;
      if (s.score < 0 || s.score >= min_hsp) {
        s.score = s.score < 0 ? s.len * o.a : s.score;
        kept.push_back(s);
      }
    }
    c.seeds = kept;
  }
}

// ---------------------------------------------------------------------------
// extension (bwamem.c:647-812)
// ---------------------------------------------------------------------------

int cal_max_gap(const MemOpt &o, int qlen) {
  int l_del = (int)((double)(qlen * o.a - o.o_del) / o.e_del + 1.);
  int l_ins = (int)((double)(qlen * o.a - o.o_ins) / o.e_ins + 1.);
  int l = l_del > l_ins ? l_del : l_ins;
  l = l > 1 ? l : 1;
  return l < o.w << 1 ? l : o.w << 1;
}

// The extension window [rmax0, rmax1) around a chain (bwamem.c:656-670),
// pre-clamp; the contig clamp happens through fetch_seq/clamp_rmax.
static void chain_rmax(const MemOpt &o, const RefView &r, int l_query,
                       const Chain &c, int64_t &rmax0, int64_t &rmax1) {
  int64_t l_pac = r.l_pac;
  rmax0 = l_pac << 1;
  rmax1 = 0;
  for (const Seed &t : c.seeds) {
    int64_t b = t.rbeg - (t.qbeg + cal_max_gap(o, t.qbeg));
    int64_t e = t.rbeg + t.len + (l_query - t.qbeg - t.len) +
                cal_max_gap(o, l_query - t.qbeg - t.len);
    rmax0 = rmax0 < b ? rmax0 : b;
    rmax1 = rmax1 > e ? rmax1 : e;
  }
  rmax0 = rmax0 > 0 ? rmax0 : 0;
  rmax1 = rmax1 < l_pac << 1 ? rmax1 : l_pac << 1;
  if (rmax0 < l_pac && l_pac < rmax1) {
    if (c.seeds[0].rbeg < l_pac) rmax1 = l_pac;
    else rmax0 = l_pac;
  }
}

// bns_fetch_seq's coordinate clamp without the sequence copy.
static void clamp_rmax(const RefView &r, int64_t &beg, int64_t mid,
                       int64_t &end) {
  int is_rev;
  int64_t pos_f = depos(r, mid, &is_rev);
  int rid = pos2rid(r, pos_f);
  int64_t far_beg = r.bns.offset[rid];
  int64_t far_end = far_beg + r.bns.len[rid];
  if (is_rev) {
    int64_t tmp = far_beg;
    far_beg = (r.l_pac << 1) - far_end;
    far_end = (r.l_pac << 1) - tmp;
  }
  beg = beg > far_beg ? beg : far_beg;
  end = end < far_end ? end : far_end;
}

// The per-chain seed processing order (score-desc introsort permutation,
// bwamem.c:684-688) — shared by the job enumeration and the serial loop
// so speculative extension results line up by a running job counter.
static void chain_srt(const Chain &c, std::vector<uint64_t> &srt) {
  size_t n = c.seeds.size();
  srt.resize(n);
  for (size_t i = 0; i < n; ++i)
    srt[i] = (uint64_t)c.seeds[i].score << 32 | i;
  ks_introsort(n, srt.data(),
               [](uint64_t x, uint64_t y) { return x < y; });
}

// Speculative-extension job table: one row per (chain, seed-in-srt-order),
// emitted for EVERY seed (the serial loop's containment skip depends on
// earlier extension results, but the extension of one seed is a pure
// function of geometry — skipped seeds' results are simply unused).
// Row layout (8 int64): q_base, l_query, qbeg, slen, rbeg, rmax0, rmax1,
// h0 (= slen * o.a).  first[j] marks the FIRST seed the serial loop will
// process in each chain (top of srt order): that seed is extended with
// near certainty, while later seeds are almost always containment-skipped
// (oracle gprof: ~20x more jobs than consumed extensions, PERF.md r4) —
// the callback may therefore resolve only the first-marked jobs and leave
// the rest at the EXT_UNRESOLVED sentinel; chain2aln runs the scalar DP
// inline for the rare consumed-but-unresolved job.
static void collect_ext_jobs(const MemOpt &o, const RefView &r, int l_query,
                             int64_t q_base,
                             const std::vector<Chain> &chains,
                             std::vector<int64_t> &meta,
                             std::vector<uint8_t> &first) {
  std::vector<uint64_t> srt;
  for (const Chain &c : chains) {
    if (c.seeds.empty()) continue;
    int64_t rmax0, rmax1;
    chain_rmax(o, r, l_query, c, rmax0, rmax1);
    clamp_rmax(r, rmax0, c.seeds[0].rbeg, rmax1);
    chain_srt(c, srt);
    for (int k = (int)c.seeds.size() - 1; k >= 0; --k) {
      const Seed &s = c.seeds[(uint32_t)srt[k]];
      meta.push_back(q_base);
      meta.push_back(l_query);
      meta.push_back(s.qbeg);
      meta.push_back(s.len);
      meta.push_back(s.rbeg);
      meta.push_back(rmax0);
      meta.push_back(rmax1);
      meta.push_back((int64_t)s.len * o.a);
      first.push_back(k == (int)c.seeds.size() - 1 ? 1 : 0);
    }
  }
}

// per-job result sentinel: "not resolved by the callback" (a real score
// can never be INT32_MIN: extension scores are >= 0)
static constexpr int32_t EXT_UNRESOLVED = INT32_MIN;

// lres/rres: per-job speculative extension results (6 int32 each:
// score, qle, tle, gtle, gscore, aw) produced by the batch-extension
// callback; when non-null the DP calls below are replaced by table reads
// (job_ctr advances once per seed in srt order, skipped or not).
void chain2aln(const MemOpt &o, const RefView &r, int l_query,
               const uint8_t *query, const Chain &c, std::vector<Reg> &regs,
               const int32_t *lres = nullptr, const int32_t *rres = nullptr,
               int64_t *job_ctr = nullptr) {
  const int MAX_BAND_TRY = 2;
  if (c.seeds.empty()) return;
  int64_t rmax0, rmax1;
  chain_rmax(o, r, l_query, c, rmax0, rmax1);
  int rid;
  std::vector<uint8_t> rseq;
  if (lres) {
    clamp_rmax(r, rmax0, c.seeds[0].rbeg, rmax1);
  } else {
    fetch_seq(r, rmax0, c.seeds[0].rbeg, rmax1, &rid, rseq);
  }

  size_t n = c.seeds.size();
  std::vector<uint64_t> srt;
  chain_srt(c, srt);

  for (int k = (int)n - 1; k >= 0; --k) {
    const int64_t job = job_ctr ? (*job_ctr)++ : -1;
    const Seed *s = &c.seeds[(uint32_t)srt[k]];
    size_t i;
    for (i = 0; i < regs.size(); ++i) {
      const Reg &p = regs[i];
      if (s->rbeg < p.rb || s->rbeg + s->len > p.re || s->qbeg < p.qb ||
          s->qbeg + s->len > p.qe)
        continue;
      if (s->len - p.seedlen0 > 0.1 * l_query) continue;
      int qd = s->qbeg - p.qb;
      int64_t rd = s->rbeg - p.rb;
      int max_gap = cal_max_gap(o, qd < rd ? qd : (int)rd);
      int w = max_gap < p.w ? max_gap : p.w;
      if (qd - rd < w && rd - qd < w) break;
      qd = p.qe - (s->qbeg + s->len);
      rd = p.re - (s->rbeg + s->len);
      max_gap = cal_max_gap(o, qd < rd ? qd : (int)rd);
      w = max_gap < p.w ? max_gap : p.w;
      if (qd - rd < w && rd - qd < w) break;
    }
    if (i < regs.size()) {
      size_t t;
      for (t = k + 1; t < n; ++t) {
        if (srt[t] == 0) continue;
        const Seed *u = &c.seeds[(uint32_t)srt[t]];
        if (u->len < s->len * 0.95) continue;
        if (s->qbeg <= u->qbeg && s->qbeg + s->len - u->qbeg >= s->len >> 2 &&
            u->qbeg - s->qbeg != u->rbeg - s->rbeg)
          break;
        if (u->qbeg <= s->qbeg && u->qbeg + u->len - s->qbeg >= s->len >> 2 &&
            s->qbeg - u->qbeg != s->rbeg - u->rbeg)
          break;
      }
      if (t == n) {
        srt[k] = 0;
        continue;
      }
    }

    Reg a;
    int aw0, aw1;
    a.w = aw0 = aw1 = o.w;
    a.score = a.truesc = -1;
    a.rid = c.rid;

    if (s->qbeg) {
      int qle = 0, tle = 0, gtle = 0, gscore = 0, max_off = 0;
      const int32_t *L = lres ? lres + job * 6 : nullptr;
      if (L && L[0] != EXT_UNRESOLVED) {
        a.score = L[0]; qle = L[1]; tle = L[2]; gtle = L[3]; gscore = L[4];
        aw0 = L[5];
      } else {
      // staged-callback miss: the reference text was never fetched for
      // this chain — fetch it now (clamp_rmax already ran; fetch_seq's
      // re-clamp is idempotent)
      if (lres && rseq.empty())
        fetch_seq(r, rmax0, c.seeds[0].rbeg, rmax1, &rid, rseq);
      std::vector<uint8_t> qs(s->qbeg), rs;
      for (int t = 0; t < s->qbeg; ++t) qs[t] = query[s->qbeg - 1 - t];
      int64_t tmp = s->rbeg - rmax0;
      rs.resize(tmp);
      for (int t = 0; t < (int)tmp; ++t) rs[t] = rseq[tmp - 1 - t];
      for (int t = 0; t < MAX_BAND_TRY; ++t) {
        int prev = a.score;
        aw0 = o.w << t;
        bt_trace::count(bt_trace::EXTENSIONS);
        a.score = bt_ksw_extend2(s->qbeg, qs.data(), (int)tmp, rs.data(), 5,
                                 o.mat, o.o_del, o.e_del, o.o_ins, o.e_ins,
                                 aw0, o.pen_clip5, o.zdrop, s->len * o.a,
                                 &qle, &tle, &gtle, &gscore, &max_off);
        if (a.score == prev || max_off < (aw0 >> 1) + (aw0 >> 2)) break;
      }
      }
      if (gscore <= 0 || gscore <= a.score - o.pen_clip5) {
        a.qb = s->qbeg - qle;
        a.rb = s->rbeg - tle;
        a.truesc = a.score;
      } else {
        a.qb = 0;
        a.rb = s->rbeg - gtle;
        a.truesc = gscore;
      }
    } else {
      a.score = a.truesc = s->len * o.a;
      a.qb = 0;
      a.rb = s->rbeg;
    }

    if (s->qbeg + s->len != l_query) {
      int sc0 = a.score;
      int qe = s->qbeg + s->len;
      int64_t re = s->rbeg + s->len - rmax0;
      int qle = 0, tle = 0, gtle = 0, gscore = 0, max_off = 0;
      const int32_t *R = rres ? rres + job * 6 : nullptr;
      if (R && R[0] != EXT_UNRESOLVED) {
        a.score = R[0]; qle = R[1]; tle = R[2]; gtle = R[3]; gscore = R[4];
        aw1 = R[5];
      } else {
      if (rres && rseq.empty())
        fetch_seq(r, rmax0, c.seeds[0].rbeg, rmax1, &rid, rseq);
      for (int t = 0; t < MAX_BAND_TRY; ++t) {
        int prev = a.score;
        aw1 = o.w << t;
        bt_trace::count(bt_trace::EXTENSIONS);
        a.score = bt_ksw_extend2(l_query - qe, query + qe,
                                 (int)(rmax1 - rmax0 - re), rseq.data() + re,
                                 5, o.mat, o.o_del, o.e_del, o.o_ins,
                                 o.e_ins, aw1, o.pen_clip3, o.zdrop, sc0,
                                 &qle, &tle, &gtle, &gscore, &max_off);
        if (a.score == prev || max_off < (aw1 >> 1) + (aw1 >> 2)) break;
      }
      }
      if (gscore <= 0 || gscore <= a.score - o.pen_clip3) {
        a.qe = qe + qle;
        a.re = rmax0 + re + tle;
        a.truesc += a.score - sc0;
      } else {
        a.qe = l_query;
        a.re = rmax0 + re + gtle;
        a.truesc += gscore - sc0;
      }
    } else {
      a.qe = l_query;
      a.re = s->rbeg + s->len;
    }

    a.seedcov = 0;
    for (const Seed &t : c.seeds)
      if (t.qbeg >= a.qb && t.qbeg + t.len <= a.qe && t.rbeg >= a.rb &&
          t.rbeg + t.len <= a.re)
        a.seedcov += t.len;
    a.w = aw0 > aw1 ? aw0 : aw1;
    a.seedlen0 = s->len;
    a.frac_rep = c.frac_rep;
    regs.push_back(a);
  }
}

// ---------------------------------------------------------------------------
// CIGAR generation (bwa.c:148-234) + reg2aln (bwamem.c:1119-1189)
// ---------------------------------------------------------------------------

struct Aln {
  int64_t pos = -1;
  int rid = -1, flag = 0, is_rev = 0, is_alt = 0, mapq = 0, NM = -1;
  std::vector<uint32_t> cigar;  // len<<4|op
  std::string md;
  std::string XA;
  int score = 0, sub = 0, alt_sc = 0;
};

// returns score; fills cigar/md/nm when want_cigar
int gen_cigar2(const MemOpt &o, const RefView &r, int w_, int l_query,
               const uint8_t *query_in, int64_t rb, int64_t re,
               bool want_cigar, std::vector<uint32_t> *cigar, int *NM,
               std::string *md, bool *ok) {
  *ok = false;
  if (l_query <= 0 || rb >= re || (rb < r.l_pac && re > r.l_pac)) return 0;
  std::vector<uint8_t> rseq;
  get_seq(r, rb, re, rseq);
  int64_t rlen = rseq.size();
  if (re - rb != rlen) return 0;
  std::vector<uint8_t> query(query_in, query_in + l_query);
  if (rb >= r.l_pac) {
    for (int i = 0; i < l_query >> 1; ++i)
      std::swap(query[i], query[l_query - 1 - i]);
    for (int64_t i = 0; i < rlen >> 1; ++i)
      std::swap(rseq[i], rseq[rlen - 1 - i]);
  }
  int score;
  if (l_query == re - rb && w_ == 0) {
    if (want_cigar) {
      cigar->clear();
      cigar->push_back((uint32_t)l_query << 4 | 0);
    }
    score = 0;
    for (int i = 0; i < l_query; ++i) score += o.mat[rseq[i] * 5 + query[i]];
  } else {
    int max_ins =
        (int)((double)(((l_query + 1) >> 1) * o.mat[0] - o.o_ins) / o.e_ins + 1.);
    int max_del =
        (int)((double)(((l_query + 1) >> 1) * o.mat[0] - o.o_del) / o.e_del + 1.);
    int max_gap = max_ins > max_del ? max_ins : max_del;
    max_gap = max_gap > 1 ? max_gap : 1;
    int w = (max_gap + (int)std::abs((long)(rlen - l_query)) + 1) >> 1;
    w = w < w_ ? w : w_;
    int min_w = (int)std::abs((long)(rlen - l_query)) + 3;
    w = w > min_w ? w : min_w;
    if (want_cigar) {
      int cap = l_query + (int)rlen + 4;
      cigar->resize(cap);
      int nc = 0;
      bt_trace::count(bt_trace::CIGARS);
      score = bt_ksw_global2(l_query, query.data(), (int)rlen, rseq.data(),
                             5, o.mat, o.o_del, o.e_del, o.o_ins, o.e_ins, w,
                             &nc, cigar->data(), cap);
      cigar->resize(nc);
    } else {
      bt_trace::count(bt_trace::CIGARS);
      score = bt_ksw_global2(l_query, query.data(), (int)rlen, rseq.data(),
                             5, o.mat, o.o_del, o.e_del, o.o_ins, o.e_ins, w,
                             nullptr, nullptr, 0);
    }
  }
  if (want_cigar && NM && md) {
    const char *int2base = rb < r.l_pac ? "ACGTN" : "TGCAN";
    md->clear();
    int x = 0, y = 0, u = 0, n_mm = 0, n_gap = 0;
    char buf[16];
    int n_cigar = (int)cigar->size();
    for (int k = 0; k < n_cigar; ++k) {
      int op = (*cigar)[k] & 0xf, len = (*cigar)[k] >> 4;
      if (op == 0) {
        for (int i = 0; i < len; ++i) {
          if (query[x + i] != rseq[y + i]) {
            snprintf(buf, sizeof buf, "%d", u);
            *md += buf;
            *md += int2base[rseq[y + i]];
            ++n_mm;
            u = 0;
          } else ++u;
        }
        x += len;
        y += len;
      } else if (op == 2) {
        if (k > 0 && k < n_cigar - 1) {
          snprintf(buf, sizeof buf, "%d", u);
          *md += buf;
          *md += '^';
          for (int i = 0; i < len; ++i) *md += int2base[rseq[y + i]];
          u = 0;
          n_gap += len;
        }
        y += len;
      } else if (op == 1) {
        x += len;
        n_gap += len;
      }
    }
    snprintf(buf, sizeof buf, "%d", u);
    *md += buf;
    *NM = n_mm + n_gap;
  }
  *ok = true;
  return score;
}

int infer_bw(int l1, int l2, int score, int a, int q, int r_) {
  if (l1 == l2 && l1 * a - score < (q + r_ - a) << 1) return 0;
  int w = (int)((double)((l1 < l2 ? l1 : l2) * a - score - q) / r_ + 2.);
  if (w < std::abs(l1 - l2)) w = std::abs(l1 - l2);
  return w;
}

int approx_mapq_se(const MemOpt &o, const Reg &a) {
  int sub = a.sub ? a.sub : o.min_seed_len * o.a;
  sub = a.csub > sub ? a.csub : sub;
  if (sub >= a.score) return 0;
  int l = (int)(a.qe - a.qb > a.re - a.rb ? a.qe - a.qb : a.re - a.rb);
  double identity = 1. - (double)(l * o.a - a.score) / (o.a + o.b) / l;
  int mapq;
  if (a.score == 0) mapq = 0;
  else if (o.mapQ_coef_len > 0) {
    double tmp = l < o.mapQ_coef_len ? 1. : o.mapQ_coef_fac / log((double)l);
    tmp *= identity * identity;
    mapq = (int)(6.02 * (a.score - sub) / o.a * tmp * tmp + .499);
  } else {
    mapq = (int)(30.0 * (1. - (double)sub / a.score) * log((double)a.seedcov) + .499);
    if (identity < 0.95) mapq = (int)(mapq * identity * identity + .499);
  }
  if (a.sub_n > 0) mapq -= (int)(4.343 * log(a.sub_n + 1.) + .499);
  if (mapq > 60) mapq = 60;
  if (mapq < 0) mapq = 0;
  mapq = (int)(mapq * (1. - a.frac_rep) + .499);
  return mapq;
}

Aln reg2aln(const MemOpt &o, const RefView &r, int l_query,
            const uint8_t *query, const Reg *ar) {
  Aln a;
  a.score = a.sub = 0;
  if (!ar || ar->rb < 0 || ar->re < 0) {
    a.rid = -1;
    a.pos = -1;
    a.flag |= 0x4;
    return a;
  }
  int qb = ar->qb, qe = ar->qe;
  int64_t rb = ar->rb, re = ar->re;
  a.mapq = ar->secondary < 0 ? approx_mapq_se(o, *ar) : 0;
  if (ar->secondary >= 0) a.flag |= 0x100;
  int tmp = infer_bw(qe - qb, (int)(re - rb), ar->truesc, o.a, o.o_del, o.e_del);
  int w2 = infer_bw(qe - qb, (int)(re - rb), ar->truesc, o.a, o.o_ins, o.e_ins);
  w2 = w2 > tmp ? w2 : tmp;
  if (w2 > o.w) w2 = w2 < ar->w ? w2 : ar->w;
  int last_sc = -(1 << 30), i = 0, score = 0, NM = -1;
  std::vector<uint32_t> cigar;
  std::string md;
  bool ok;
  for (;;) {
    w2 = w2 < o.w << 2 ? w2 : o.w << 2;
    score = gen_cigar2(o, r, w2, qe - qb, query + qb, rb, re, true, &cigar,
                       &NM, &md, &ok);
    assert(ok);
    if (score == last_sc || w2 == o.w << 2) break;
    last_sc = score;
    w2 <<= 1;
    if (!(++i < 3 && score < ar->truesc - o.a)) break;
  }
  a.NM = NM;
  a.md = md;
  int is_rev;
  int64_t pos = depos(r, rb < r.l_pac ? rb : re - 1, &is_rev);
  a.is_rev = is_rev;
  if (!cigar.empty()) {
    if ((cigar[0] & 0xf) == 2) {
      pos += cigar[0] >> 4;
      cigar.erase(cigar.begin());
    } else if ((cigar.back() & 0xf) == 2) {
      cigar.pop_back();
    }
  }
  if (qb != 0 || qe != l_query) {
    int clip5 = is_rev ? l_query - qe : qb;
    int clip3 = is_rev ? qb : l_query - qe;
    if (clip5) cigar.insert(cigar.begin(), (uint32_t)clip5 << 4 | 3);
    if (clip3) cigar.push_back((uint32_t)clip3 << 4 | 3);
  }
  a.cigar = cigar;
  a.rid = pos2rid(r, pos);
  assert(a.rid == ar->rid);
  a.pos = pos - r.bns.offset[a.rid];
  a.score = ar->score;
  a.sub = ar->sub > ar->csub ? ar->sub : ar->csub;
  a.is_alt = ar->is_alt;
  a.alt_sc = ar->alt_sc;
  return a;
}

// ---------------------------------------------------------------------------
// dedup/patch + primary marking (bwamem.c:417-584)
// ---------------------------------------------------------------------------

int patch_reg(const MemOpt &o, const RefView &r, const uint8_t *query,
              const Reg &a, const Reg &b, int *_w) {
  if (query == nullptr) return 0;  // mem_patch_reg with bns/pac/query==0
  const double PATCH_MAX_R_BW = 0.05, PATCH_MIN_SC_RATIO = 0.90;
  if (!query) return 0;
  assert(a.rid == b.rid && a.rb <= b.rb);
  if (a.rb < r.l_pac && b.rb >= r.l_pac) return 0;
  if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return 0;
  int w = (int)((a.re - b.rb) - (a.qe - b.qb));
  w = w > 0 ? w : -w;
  double rr = (double)(a.re - b.rb) / (b.re - a.rb) -
              (double)(a.qe - b.qb) / (b.qe - a.qb);
  rr = rr > 0. ? rr : -rr;
  if (a.re < b.rb || a.qe < b.qb) {
    if (w > o.w << 1 || rr >= PATCH_MAX_R_BW) return 0;
  } else if (w > o.w << 2 || rr >= PATCH_MAX_R_BW * 2) return 0;
  w += a.w + b.w;
  w = w < o.w << 2 ? w : o.w << 2;
  bool ok;
  int score = gen_cigar2(o, r, w, b.qe - a.qb, query + a.qb, a.rb, b.re,
                         false, nullptr, nullptr, nullptr, &ok);
  if (!ok) return 0;
  int q_s = (int)((double)(b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) *
                      (b.score + a.score) + .499);
  int r_s = (int)((double)(b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) *
                      (b.score + a.score) + .499);
  if ((double)score / (q_s > r_s ? q_s : r_s) < PATCH_MIN_SC_RATIO) return 0;
  *_w = w;
  return score;
}

int sort_dedup_patch(const MemOpt &o, const RefView &r, const uint8_t *query,
                     std::vector<Reg> &a) {
  int n = (int)a.size();
  if (n <= 1) return n;
  ks_introsort(a.size(), a.data(),
               [](const Reg &x, const Reg &y) { return x.re < y.re; });
  for (Reg &p : a) p.n_comp = 1;
  for (int i = 1; i < n; ++i) {
    Reg *p = &a[i];
    if (p->rid != a[i - 1].rid || p->rb >= a[i - 1].re + o.max_chain_gap)
      continue;
    for (int j = i - 1;
         j >= 0 && p->rid == a[j].rid && p->rb < a[j].re + o.max_chain_gap;
         --j) {
      Reg *q = &a[j];
      if (q->qe == q->qb) continue;
      int64_t orr = q->re - p->rb;
      int64_t oq = q->qb < p->qb ? q->qe - p->qb : p->qe - q->qb;
      int64_t mr = std::min(q->re - q->rb, p->re - p->rb);
      int64_t mq = std::min(q->qe - q->qb, p->qe - p->qb);
      if (orr > o.mask_level_redun * mr && oq > o.mask_level_redun * mq) {
        if (p->score < q->score) {
          p->qe = p->qb;
          break;
        } else q->qe = q->qb;
      } else if (q->rb < p->rb) {
        int w, score = patch_reg(o, r, query, *q, *p, &w);
        if (score > 0) {
          p->n_comp += q->n_comp + 1;
          p->seedcov = std::max(p->seedcov, q->seedcov);
          p->sub = std::max(p->sub, q->sub);
          p->csub = std::max(p->csub, q->csub);
          p->qb = q->qb;
          p->rb = q->rb;
          p->truesc = p->score = score;
          p->w = w;
          q->qb = q->qe;
        }
      }
    }
  }
  {
    int m = 0;
    for (int i = 0; i < n; ++i)
      if (a[i].qe > a[i].qb) a[m++] = a[i];
    a.resize(m);
    n = m;
  }
  ks_introsort(a.size(), a.data(), [](const Reg &x, const Reg &y) {
    return x.score > y.score ||
           (x.score == y.score &&
            (x.rb < y.rb || (x.rb == y.rb && x.qb < y.qb)));
  });
  for (int i = 1; i < n; ++i)
    if (a[i].score == a[i - 1].score && a[i].rb == a[i - 1].rb &&
        a[i].qb == a[i - 1].qb)
      a[i].qe = a[i].qb;
  if (n > 1) {
    std::vector<Reg> out;
    out.push_back(a[0]);
    for (int i = 1; i < n; ++i)
      if (a[i].qe > a[i].qb) out.push_back(a[i]);
    a = out;
  }
  return (int)a.size();
}

void mark_primary_core(const MemOpt &o, std::vector<Reg> &a, int n) {
  int tmp = std::max(o.a + o.b, std::max(o.o_del + o.e_del, o.o_ins + o.e_ins));
  std::vector<int> z{0};
  for (int i = 1; i < n; ++i) {
    int found = -1;
    for (int k : z) {
      int b_max = std::max(a[k].qb, a[i].qb);
      int e_min = std::min(a[k].qe, a[i].qe);
      if (e_min > b_max) {
        int min_l = std::min(a[i].qe - a[i].qb, a[k].qe - a[k].qb);
        if (e_min - b_max >= min_l * o.mask_level) {
          if (a[k].sub == 0) a[k].sub = a[i].score;
          if (a[k].score - a[i].score <= tmp &&
              (a[k].is_alt || !a[i].is_alt))
            ++a[k].sub_n;
          found = k;
          break;
        }
      }
    }
    if (found < 0) z.push_back(i);
    else a[i].secondary = found;
  }
}

int mark_primary_se(const MemOpt &o, std::vector<Reg> &a, int64_t id) {
  int n = (int)a.size();
  if (n == 0) return 0;
  int n_pri = 0;
  for (int i = 0; i < n; ++i) {
    a[i].sub = a[i].alt_sc = 0;
    a[i].secondary = a[i].secondary_all = -1;
    a[i].hash = hash_64((uint64_t)(id + i));
    if (!a[i].is_alt) ++n_pri;
  }
  ks_introsort(a.size(), a.data(), [](const Reg &x, const Reg &y) {
    return x.score > y.score ||
           (x.score == y.score &&
            (x.is_alt < y.is_alt ||
             (x.is_alt == y.is_alt && x.hash < y.hash)));
  });
  mark_primary_core(o, a, n);
  for (int i = 0; i < n; ++i) {
    a[i].secondary_all = i;
    if (!a[i].is_alt && a[i].secondary >= 0 && a[a[i].secondary].is_alt)
      a[i].alt_sc = a[a[i].secondary].score;
  }
  if (n_pri >= 0 && n_pri < n) {
    std::vector<int> z(n);
    if (n_pri > 0)
      ks_introsort(a.size(), a.data(), [](const Reg &x, const Reg &y) {
        return x.is_alt < y.is_alt ||
               (x.is_alt == y.is_alt &&
                (x.score > y.score ||
                 (x.score == y.score && x.hash < y.hash)));
      });
    for (int i = 0; i < n; ++i) z[a[i].secondary_all] = i;
    for (int i = 0; i < n; ++i) {
      if (a[i].secondary >= 0) {
        a[i].secondary_all = z[a[i].secondary];
        if (a[i].is_alt) a[i].secondary = INT_MAX_;
      } else a[i].secondary_all = -1;
    }
    if (n_pri > 0) {
      for (int i = 0; i < n_pri; ++i) {
        a[i].sub = 0;
        a[i].secondary = -1;
      }
      mark_primary_core(o, a, n_pri);
    }
  } else {
    for (int i = 0; i < n; ++i) a[i].secondary_all = a[i].secondary;
  }
  return n_pri;
}

void reorder_primary5(int T, std::vector<Reg> &a) {
  int n_pri = 0, left_st = INT_MAX_, left_k = -1;
  for (auto &p : a)
    if (p.secondary < 0 && !p.is_alt && p.score >= T) ++n_pri;
  if (n_pri <= 1) return;
  for (int k = 0; k < (int)a.size(); ++k) {
    Reg &p = a[k];
    if (p.secondary >= 0 || p.is_alt || p.score < T) continue;
    if (p.qb < left_st) left_st = p.qb, left_k = k;
  }
  if (left_k == 0) return;
  std::swap(a[0], a[left_k]);
  for (int k = 1; k < (int)a.size(); ++k) {
    Reg &p = a[k];
    if (p.secondary == 0) p.secondary = left_k;
    else if (p.secondary == left_k) p.secondary = 0;
    if (p.secondary_all == 0) p.secondary_all = left_k;
    else if (p.secondary_all == left_k) p.secondary_all = 0;
  }
}

// ---------------------------------------------------------------------------
// SAM emission (bwamem.c:838-976) + XA (bwamem_extra.c:116-172)
// ---------------------------------------------------------------------------

const char *CIG = "MIDSH";
const char *CIGN = "MIDSHN";
const char *FWD = "ACGTN";
const char *REV = "TGCAN";

void cigar_text(const MemOpt &o, const Aln &p, int which, std::string &out) {
  if (p.cigar.empty()) {
    out += '*';
    return;
  }
  char buf[16];
  for (uint32_t cw : p.cigar) {
    int c = cw & 0xf;
    if (!(o.flag & MEM_F_SOFTCLIP) && !p.is_alt && (c == 3 || c == 4))
      c = which ? 4 : 3;
    snprintf(buf, sizeof buf, "%u", cw >> 4);
    out += buf;
    out += CIG[c];
  }
}

int rlen_of(const std::vector<uint32_t> &cig) {
  int l = 0;
  for (uint32_t c : cig)
    if ((c & 0xf) == 0 || (c & 0xf) == 2) l += c >> 4;
  return l;
}

void aln2sam(const MemOpt &o, const RefView &r, const char *name,
             const uint8_t *seq_codes, int l_seq, const char *qual,
             const char *comment, int n, const std::vector<Aln> &list,
             int which, const Aln *m_, const char *rg_id, std::string &str) {
  Aln p = list[which];
  Aln m;
  bool have_m = m_ != nullptr;
  if (have_m) m = *m_;
  char buf[32];
  // flags (bwamem.c:858-866)
  p.flag |= have_m ? 0x1 : 0;
  p.flag |= p.rid < 0 ? 0x4 : 0;
  p.flag |= (have_m && m.rid < 0) ? 0x8 : 0;
  if (p.rid < 0 && have_m && m.rid >= 0) {  // copy mate position over
    p.rid = m.rid;
    p.pos = m.pos;
    p.is_rev = m.is_rev;
    p.cigar.clear();
  }
  if (have_m && m.rid < 0 && p.rid >= 0) {
    m.rid = p.rid;
    m.pos = p.pos;
    m.is_rev = p.is_rev;
    m.cigar.clear();
  }
  p.flag |= p.is_rev ? 0x10 : 0;
  p.flag |= (have_m && m.is_rev) ? 0x20 : 0;

  str += name;
  str += '\t';
  snprintf(buf, sizeof buf, "%d", (p.flag & 0xffff) | (p.flag & 0x10000 ? 0x100 : 0));
  str += buf;
  str += '\t';
  if (p.rid >= 0) {
    str += r.bns.names + r.bns.name_off[p.rid];
    str += '\t';
    snprintf(buf, sizeof buf, "%lld", (long long)(p.pos + 1));
    str += buf;
    str += '\t';
    snprintf(buf, sizeof buf, "%d", p.mapq);
    str += buf;
    str += '\t';
    cigar_text(o, p, which, str);
  } else str += "*\t0\t0\t*";
  str += '\t';
  if (have_m && m.rid >= 0) {  // RNEXT/PNEXT/TLEN (bwamem.c:881-895)
    if (p.rid == m.rid) str += '=';
    else str += r.bns.names + r.bns.name_off[m.rid];
    str += '\t';
    snprintf(buf, sizeof buf, "%lld", (long long)(m.pos + 1));
    str += buf;
    str += '\t';
    if (p.rid == m.rid) {
      int64_t p0 = p.pos + (p.is_rev ? rlen_of(p.cigar) - 1 : 0);
      int64_t p1 = m.pos + (m.is_rev ? rlen_of(m.cigar) - 1 : 0);
      if (m.cigar.empty() || p.cigar.empty()) str += '0';
      else {
        snprintf(buf, sizeof buf, "%lld",
                 (long long)-(p0 - p1 + (p0 > p1 ? 1 : p0 < p1 ? -1 : 0)));
        str += buf;
      }
    } else str += '0';
  } else str += "*\t0\t0";
  str += '\t';

  if (p.flag & 0x100) {
    str += "*\t*";
  } else {
    int qb = 0, qe = l_seq;
    if (!p.cigar.empty() && which && !(o.flag & MEM_F_SOFTCLIP) && !p.is_alt) {
      if (!p.is_rev) {
        if ((p.cigar[0] & 0xf) == 4 || (p.cigar[0] & 0xf) == 3)
          qb += p.cigar[0] >> 4;
        if ((p.cigar.back() & 0xf) == 4 || (p.cigar.back() & 0xf) == 3)
          qe -= p.cigar.back() >> 4;
      } else {
        if ((p.cigar[0] & 0xf) == 4 || (p.cigar[0] & 0xf) == 3)
          qe -= p.cigar[0] >> 4;
        if ((p.cigar.back() & 0xf) == 4 || (p.cigar.back() & 0xf) == 3)
          qb += p.cigar.back() >> 4;
      }
    }
    if (!p.is_rev) {
      size_t at = str.size();  // bulk write (per-char += is measurable
      str.resize(at + (size_t)(qe - qb));  // at headline batch sizes)
      char *d = &str[at];
      for (int i = qb; i < qe; ++i) d[i - qb] = FWD[seq_codes[i]];
      str += '\t';
      if (qual) {
        str.append(qual + qb, (size_t)(qe - qb));
      } else str += '*';
    } else {
      size_t at = str.size();
      str.resize(at + (size_t)(qe - qb));
      char *d = &str[at];
      for (int i = qe - 1; i >= qb; --i) d[qe - 1 - i] = REV[seq_codes[i]];
      str += '\t';
      if (qual) {
        at = str.size();
        str.resize(at + (size_t)(qe - qb));
        d = &str[at];
        for (int i = qe - 1; i >= qb; --i) d[qe - 1 - i] = qual[i];
      } else str += '*';
    }
  }

  if (!p.cigar.empty()) {
    str += "\tNM:i:";
    snprintf(buf, sizeof buf, "%d", p.NM);
    str += buf;
    str += "\tMD:Z:";
    str += p.md;
  }
  if (have_m && !m.cigar.empty()) {
    str += "\tMC:Z:";
    cigar_text(o, m, which, str);
  }
  if (have_m) {
    str += "\tMQ:i:";
    snprintf(buf, sizeof buf, "%d", m.mapq);
    str += buf;
  }
  if (p.score >= 0) {
    str += "\tAS:i:";
    snprintf(buf, sizeof buf, "%d", p.score);
    str += buf;
  }
  if (p.sub >= 0) {
    str += "\tXS:i:";
    snprintf(buf, sizeof buf, "%d", p.sub);
    str += buf;
  }
  if (rg_id && rg_id[0]) {
    str += "\tRG:Z:";
    str += rg_id;
  }
  if (!(p.flag & 0x100)) {
    bool others = false;
    for (int i = 0; i < n; ++i)
      if (i != which && !(list[i].flag & 0x100)) { others = true; break; }
    if (others) {
      str += "\tSA:Z:";
      for (int i = 0; i < n; ++i) {
        const Aln &q = list[i];
        if (i == which || (q.flag & 0x100)) continue;
        str += r.bns.names + r.bns.name_off[q.rid];
        str += ',';
        snprintf(buf, sizeof buf, "%lld", (long long)(q.pos + 1));
        str += buf;
        str += ',';
        str += q.is_rev ? '-' : '+';
        str += ',';
        for (uint32_t cw : q.cigar) {
          snprintf(buf, sizeof buf, "%u", cw >> 4);
          str += buf;
          str += CIG[cw & 0xf];
        }
        str += ',';
        snprintf(buf, sizeof buf, "%d", q.mapq);
        str += buf;
        str += ',';
        snprintf(buf, sizeof buf, "%d", q.NM);
        str += buf;
        str += ';';
      }
    }
    if (p.alt_sc > 0) {
      snprintf(buf, sizeof buf, "\tpa:f:%.3f", (double)p.score / p.alt_sc);
      str += buf;
    }
  }
  if (!p.XA.empty()) {
    str += (o.flag & MEM_F_XB) ? "\tXB:Z:" : "\tXA:Z:";
    str += p.XA;
  }
  if (comment && comment[0]) {
    str += '\t';
    str += comment;
  }
  str += '\n';
}

int get_pri_idx(double ratio, const std::vector<Reg> &a, int i) {
  int k = a[i].secondary_all;
  if (k >= 0 && a[i].score >= a[k].score * ratio) return k;
  return -1;
}

void gen_alt(const MemOpt &o, const RefView &r, const std::vector<Reg> &regs,
             int l_query, const uint8_t *query, std::vector<std::string> &XA) {
  int n = (int)regs.size();
  XA.assign(n, "");
  std::vector<int> cnt(n, 0);
  std::vector<char> has_alt(n, 0);
  int tot = 0;
  for (int i = 0; i < n; ++i) {
    int k = get_pri_idx(o.XA_drop_ratio, regs, i);
    if (k >= 0) {
      ++cnt[k];
      ++tot;
      if (regs[i].is_alt) has_alt[k] = 1;
    }
  }
  if (tot == 0) return;
  char buf[32];
  for (int i = 0; i < n; ++i) {
    int k = get_pri_idx(o.XA_drop_ratio, regs, i);
    if (k < 0) continue;
    if (cnt[k] > o.max_XA_hits_alt || (!has_alt[k] && cnt[k] > o.max_XA_hits))
      continue;
    Aln t = reg2aln(o, r, l_query, query, &regs[i]);
    std::string s;
    s += r.bns.names + r.bns.name_off[t.rid];
    s += ',';
    s += t.is_rev ? '-' : '+';
    snprintf(buf, sizeof buf, "%lld", (long long)(t.pos + 1));
    s += buf;
    s += ',';
    for (uint32_t cw : t.cigar) {
      snprintf(buf, sizeof buf, "%u", cw >> 4);
      s += buf;
      s += CIGN[cw & 0xf];
    }
    s += ',';
    snprintf(buf, sizeof buf, "%d", t.NM);
    s += buf;
    if (o.flag & MEM_F_XB) {
      snprintf(buf, sizeof buf, ",%d,%d", t.score, t.mapq);
      s += buf;
    }
    s += ';';
    XA[k] += s;
  }
}

void reg2sam_se(const MemOpt &o, const RefView &r, const char *name,
                const uint8_t *codes, int l_seq, const char *qual,
                const char *comment, std::vector<Reg> &regs, int extra_flag,
                const Aln *mate, const char *rg_id, std::string &out) {
  std::vector<std::string> XA;
  bool have_xa = false;
  if (!(o.flag & MEM_F_ALL)) {
    gen_alt(o, r, regs, l_seq, codes, XA);
    have_xa = true;
  }
  std::vector<Aln> aa;
  int l = 0;
  for (int k = 0; k < (int)regs.size(); ++k) {
    Reg *p = &regs[k];
    if (p->score < o.T) continue;
    if (p->secondary >= 0 && (p->is_alt || !(o.flag & MEM_F_ALL))) continue;
    if (p->secondary >= 0 && p->secondary < INT_MAX_ &&
        p->score < regs[p->secondary].score * o.drop_ratio)
      continue;
    Aln q = reg2aln(o, r, l_seq, codes, p);
    assert(q.rid >= 0);
    if (have_xa) q.XA = XA[k];
    q.flag |= extra_flag;
    if (p->secondary >= 0) q.sub = -1;
    if (l && p->secondary < 0)
      q.flag |= (o.flag & MEM_F_NO_MULTI) ? 0x10000 : 0x800;
    if (!(o.flag & MEM_F_KEEP_SUPP_MAPQ) && l && !p->is_alt &&
        q.mapq > aa[0].mapq)
      q.mapq = aa[0].mapq;
    aa.push_back(std::move(q));
    ++l;
  }
  if (aa.empty()) {
    Aln t = reg2aln(o, r, l_seq, codes, nullptr);
    t.flag |= extra_flag;
    std::vector<Aln> one{t};
    aln2sam(o, r, name, codes, l_seq, qual, comment, 1, one, 0, mate,
            rg_id, out);
  } else {
    for (int k = 0; k < (int)aa.size(); ++k)
      aln2sam(o, r, name, codes, l_seq, qual, comment, (int)aa.size(), aa, k,
              mate, rg_id, out);
  }
}


// ---------------------------------------------------------------------------
// Paired-end machinery (bwamem_pair.c)
// ---------------------------------------------------------------------------

struct PeStat {  // mem_pestat_t
  int low = 0, high = 0, failed = 0;
  double avg = 0.0, std = 0.0;
};

// mem_infer_dir (bwamem_pair.c:49-56)
inline int infer_dir(int64_t l_pac, int64_t b1, int64_t b2, int64_t *dist) {
  int r1 = b1 >= l_pac, r2 = b2 >= l_pac;
  int64_t p2 = r1 == r2 ? b2 : (l_pac << 1) - 1 - b2;
  *dist = p2 > b1 ? p2 - b1 : b1 - p2;
  return (r1 == r2 ? 0 : 1) ^ (p2 > b1 ? 0 : 3);
}

// cal_sub (bwamem_pair.c:58-70)
inline int cal_sub(const MemOpt &o, const std::vector<Reg> &r) {
  for (int j = 1; j < (int)r.size(); ++j) {
    int b_max = r[j].qb > r[0].qb ? r[j].qb : r[0].qb;
    int e_min = r[j].qe < r[0].qe ? r[j].qe : r[0].qe;
    if (e_min > b_max) {
      int min_l = (int)std::min(r[j].qe - r[j].qb, r[0].qe - r[0].qb);
      if (e_min - b_max >= min_l * o.mask_level) return r[j].score;
    }
  }
  return o.min_seed_len * o.a;
}

// mem_pestat (bwamem_pair.c:72-135)
void pe_stat(const MemOpt &o, int64_t l_pac,
             const std::vector<std::vector<Reg>> &regs, PeStat pes[4]) {
  const double kMinRatio = 0.8, kOutlier = 2.0, kMapping = 3.0, kMaxStd = 4.0;
  std::vector<int64_t> isize[4];
  int n = (int)regs.size();
  for (int i = 0; i < n >> 1; ++i) {
    const std::vector<Reg> &r0 = regs[i * 2], &r1 = regs[i * 2 + 1];
    if (r0.empty() || r1.empty()) continue;
    if (cal_sub(o, r0) > kMinRatio * r0[0].score) continue;
    if (cal_sub(o, r1) > kMinRatio * r1[0].score) continue;
    if (r0[0].rid != r1[0].rid) continue;
    int64_t dist;
    int d = infer_dir(l_pac, r0[0].rb, r1[0].rb, &dist);
    if (dist && dist <= o.max_ins) isize[d].push_back(dist);
  }
  fprintf(stderr,
          "[M::mem_pestat] # candidate unique pairs for (FF, FR, RF, RR): "
          "(%ld, %ld, %ld, %ld)\n",
          (long)isize[0].size(), (long)isize[1].size(),
          (long)isize[2].size(), (long)isize[3].size());
  for (int d = 0; d < 4; ++d) {
    PeStat &r = pes[d];
    std::vector<int64_t> &q = isize[d];
    if ((int)q.size() < 10) {  // MIN_DIR_CNT
      fprintf(stderr,
              "[M::mem_pestat] skip orientation %c%c as there are not enough "
              "pairs\n", "FR"[d >> 1 & 1], "FR"[d & 1]);
      r.failed = 1;
      continue;
    }
    fprintf(stderr,
            "[M::mem_pestat] analyzing insert size distribution for "
            "orientation %c%c...\n", "FR"[d >> 1 & 1], "FR"[d & 1]);
    std::sort(q.begin(), q.end());
    int p25 = (int)q[(int)(.25 * q.size() + .499)];
    int p50 = (int)q[(int)(.50 * q.size() + .499)];
    int p75 = (int)q[(int)(.75 * q.size() + .499)];
    r.low = (int)(p25 - kOutlier * (p75 - p25) + .499);
    if (r.low < 1) r.low = 1;
    r.high = (int)(p75 + kOutlier * (p75 - p25) + .499);
    fprintf(stderr, "[M::mem_pestat] (25, 50, 75) percentile: (%d, %d, %d)\n",
            p25, p50, p75);
    fprintf(stderr,
            "[M::mem_pestat] low and high boundaries for computing mean and "
            "std.dev: (%d, %d)\n", r.low, r.high);
    int x = 0;
    r.avg = 0;
    for (int64_t v : q)
      if (v >= r.low && v <= r.high) r.avg += v, ++x;
    r.avg /= x;
    r.std = 0;
    for (int64_t v : q)
      if (v >= r.low && v <= r.high) r.std += (v - r.avg) * (v - r.avg);
    r.std = std::sqrt(r.std / x);
    fprintf(stderr, "[M::mem_pestat] mean and std.dev: (%.2f, %.2f)\n",
            r.avg, r.std);
    r.low = (int)(p25 - kMapping * (p75 - p25) + .499);
    r.high = (int)(p75 + kMapping * (p75 - p25) + .499);
    if (r.low > r.avg - kMaxStd * r.std) r.low = (int)(r.avg - kMaxStd * r.std + .499);
    if (r.high < r.avg + kMaxStd * r.std) r.high = (int)(r.avg + kMaxStd * r.std + .499);
    if (r.low < 1) r.low = 1;
    fprintf(stderr,
            "[M::mem_pestat] low and high boundaries for proper pairs: "
            "(%d, %d)\n", r.low, r.high);
  }
  size_t mx = 0;
  for (int d = 0; d < 4; ++d) mx = std::max(mx, isize[d].size());
  for (int d = 0; d < 4; ++d)
    if (pes[d].failed == 0 && isize[d].size() < mx * .05) {  // MIN_DIR_RATIO
      pes[d].failed = 1;
      fprintf(stderr, "[M::mem_pestat] skip orientation %c%c\n",
              "FR"[d >> 1 & 1], "FR"[d & 1]);
    }
}

// mem_matesw (bwamem_pair.c:137-206)
int mate_sw(const MemOpt &o, const RefView &r, const PeStat pes[4],
            const Reg &a, int l_ms, const uint8_t *ms, std::vector<Reg> &ma) {
  int skip[4];
  for (int d = 0; d < 4; ++d) skip[d] = pes[d].failed ? 1 : 0;
  for (const Reg &p : ma) {
    int64_t dist;
    int d = infer_dir(r.l_pac, a.rb, p.rb, &dist);
    if (dist >= pes[d].low && dist <= pes[d].high) skip[d] = 1;
  }
  if (skip[0] + skip[1] + skip[2] + skip[3] == 4) return 0;
  int n = 0;
  for (int d = 0; d < 4; ++d) {
    if (skip[d]) continue;
    int is_rev = (d >> 1) != (d & 1);
    int is_larger = !(d >> 1);
    std::vector<uint8_t> seq(l_ms);
    if (is_rev) {
      for (int i = 0; i < l_ms; ++i)
        seq[l_ms - 1 - i] = ms[i] < 4 ? 3 - ms[i] : 4;
    } else {
      std::copy(ms, ms + l_ms, seq.begin());
    }
    int64_t rb, re;
    if (!is_rev) {
      rb = is_larger ? a.rb + pes[d].low : a.rb - pes[d].high;
      re = (is_larger ? a.rb + pes[d].high : a.rb - pes[d].low) + l_ms;
    } else {
      rb = (is_larger ? a.rb + pes[d].low : a.rb - pes[d].high) - l_ms;
      re = is_larger ? a.rb + pes[d].high : a.rb - pes[d].low;
    }
    if (rb < 0) rb = 0;
    if (re > r.l_pac << 1) re = r.l_pac << 1;
    std::vector<uint8_t> ref;
    int rid = -1;
    if (rb < re) fetch_seq(r, rb, (rb + re) >> 1, re, &rid, ref);
    if (a.rid == rid && re - rb >= o.min_seed_len) {
      int use_byte = l_ms * o.a < 250;
      int32_t outv[7];
      bt_trace::count(bt_trace::RESCUE_TRIES);
      bt_ksw_align2(l_ms, seq.data(), (int)(re - rb), ref.data(), 5, o.mat,
                    o.o_del, o.e_del, o.o_ins, o.e_ins, use_byte,
                    /*start*/ 1, /*subo*/ 1, /*stop*/ 0,
                    o.min_seed_len * o.a, outv);
      int score = outv[0], te = outv[1], qe = outv[2], score2 = outv[3];
      int tb = outv[5], qb = outv[6];
      if (score >= o.min_seed_len && qb >= 0) {
        bt_trace::count(bt_trace::RESCUE_HITS);
        Reg b;
        b.rid = a.rid;
        b.is_alt = a.is_alt;
        b.qb = is_rev ? l_ms - (qe + 1) : qb;
        b.qe = is_rev ? l_ms - qb : qe + 1;
        b.rb = is_rev ? (r.l_pac << 1) - (rb + te + 1) : rb + tb;
        b.re = is_rev ? (r.l_pac << 1) - (rb + tb) : rb + te + 1;
        b.score = score;
        b.csub = score2;
        b.secondary = -1;
        b.seedcov = (int)(std::min(b.re - b.rb, (int64_t)(b.qe - b.qb)) >> 1);
        // insert keeping ma sorted by score (bwamem_pair.c:191-197)
        ma.push_back(b);
        int i = 0;
        while (i < (int)ma.size() - 1 && ma[i].score >= b.score) ++i;
        for (int j = (int)ma.size() - 1; j > i; --j) ma[j] = ma[j - 1];
        ma[i] = b;
      }
      ++n;
    }
    if (n) sort_dedup_patch(o, r, nullptr, ma);
  }
  return n;
}

inline int raw_mapq(int diff, int a) { return (int)(6.02 * diff / a + .499); }

struct Pair64 { uint64_t x, y; };
inline bool pair64_lt(const Pair64 &a, const Pair64 &b) {
  return a.x < b.x || (a.x == b.x && a.y < b.y);
}

// mem_pair (bwamem_pair.c:208-269); returns score or 0; fills sub/n_sub/z
int mem_pair(const MemOpt &o, const RefView &r, const PeStat pes[4],
             std::vector<Reg> a[2], int64_t id, const int n_pri[2],
             int *sub, int *n_sub, int z[2]) {
  std::vector<Pair64> v, u;
  for (int rr = 0; rr < 2; ++rr) {
    for (int i = 0; i < n_pri[rr]; ++i) {
      const Reg &e = a[rr][i];
      Pair64 p;
      int64_t xf = e.rb < r.l_pac ? e.rb : (r.l_pac << 1) - 1 - e.rb;
      p.x = (uint64_t)e.rid << 32 | (uint64_t)(xf - r.bns.offset[e.rid]);
      p.y = (uint64_t)e.score << 32 | (uint64_t)i << 2 |
            (uint64_t)(e.rb >= r.l_pac) << 1 | rr;
      v.push_back(p);
    }
  }
  ks_introsort(v.size(), v.data(), pair64_lt);
  int y[4] = {-1, -1, -1, -1};
  for (int i = 0; i < (int)v.size(); ++i) {
    for (int rr = 0; rr < 2; ++rr) {
      int dir = rr << 1 | (int)(v[i].y >> 1 & 1);
      if (pes[dir].failed) continue;
      int which = rr << 1 | ((int)(v[i].y & 1) ^ 1);
      if (y[which] < 0) continue;
      for (int k = y[which]; k >= 0; --k) {
        if ((int)(v[k].y & 3) != which) continue;
        int64_t dist = (int64_t)(v[i].x - v[k].x);
        if (dist > pes[dir].high) break;
        if (dist < pes[dir].low) continue;
        double ns = (dist - pes[dir].avg) / pes[dir].std;
        int q = (int)((v[i].y >> 32) + (v[k].y >> 32) +
                      .721 * std::log(2. * std::erfc(std::fabs(ns) *
                                                     0.7071067811865475244)) *
                          o.a + .499);
        if (q < 0) q = 0;
        Pair64 p;
        p.y = (uint64_t)k << 32 | (uint64_t)i;
        p.x = (uint64_t)q << 32 |
              (hash_64(p.y ^ (uint64_t)id << 8) & 0xffffffffu);
        u.push_back(p);
      }
    }
    y[v[i].y & 3] = i;
  }
  int ret = 0;
  *sub = *n_sub = 0;
  if (!u.empty()) {
    int tmp = std::max(o.a + o.b,
                       std::max(o.o_del + o.e_del, o.o_ins + o.e_ins));
    ks_introsort(u.size(), u.data(), pair64_lt);
    int i = (int)(u.back().y >> 32);
    int k = (int)(u.back().y & 0xffffffffu);
    z[v[i].y & 1] = (int)((v[i].y & 0xffffffffu) >> 2);
    z[v[k].y & 1] = (int)((v[k].y & 0xffffffffu) >> 2);
    ret = (int)(u.back().x >> 32);
    *sub = u.size() > 1 ? (int)(u[u.size() - 2].x >> 32) : 0;
    for (int j = (int)u.size() - 2; j >= 0; --j)
      if (*sub - (int)(u[j].x >> 32) <= tmp) ++*n_sub;
  }
  return ret;
}

// mem_sam_pe (bwamem_pair.c:276-419); fills sam0/sam1.  lap: marks the
// rescue and the pairing; the caller marks the SAM text.
int sam_pe(const MemOpt &o, const RefView &r, const PeStat pes[4],
           int64_t pair_id, const char *name, const uint8_t *codes[2],
           const int l_seq[2], const char *qual[2], const char *comment[2],
           std::vector<Reg> a[2], const char *rg_id, std::string sams[2],
           bt_trace::Lap &lap) {
  int n = 0, extra_flag = 1;
  if (!(o.flag & MEM_F_NO_RESCUE)) {  // mate rescue
    std::vector<Reg> b[2];
    for (int i = 0; i < 2; ++i)
      for (const Reg &reg : a[i])
        if (!a[i].empty() && reg.score >= a[i][0].score - o.pen_unpaired)
          b[i].push_back(reg);
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < (int)b[i].size() && j < o.max_matesw; ++j)
        n += mate_sw(o, r, pes, b[i][j], l_seq[1 - i], codes[1 - i],
                     a[1 - i]);
  }
  lap.to(bt_trace::RESCUE);
  int n_pri[2] = {mark_primary_se(o, a[0], pair_id << 1 | 0),
                  mark_primary_se(o, a[1], pair_id << 1 | 1)};
  if (o.flag & MEM_F_PRIMARY5) {
    reorder_primary5(o.T, a[0]);
    reorder_primary5(o.T, a[1]);
  }
  if (!(o.flag & MEM_F_NOPAIRING)) {
    int subo = 0, n_sub = 0, z[2] = {0, 0};
    int score = (n_pri[0] && n_pri[1])
                    ? mem_pair(o, r, pes, a, pair_id, n_pri, &subo, &n_sub, z)
                    : 0;
    if (score > 0) {
      // check multiple hits even after rescue (bwamem_pair.c:312-320)
      int is_multi[2] = {0, 0};
      for (int i = 0; i < 2; ++i)
        for (int j = 1; j < n_pri[i]; ++j)
          if (a[i][j].secondary < 0 && a[i][j].score >= o.T) {
            is_multi[i] = 1;
            break;
          }
      if (!is_multi[0] && !is_multi[1]) {
        int score_un = a[0][0].score + a[1][0].score - o.pen_unpaired;
        subo = subo > score_un ? subo : score_un;
        int q_pe = raw_mapq(score - subo, o.a);
        if (n_sub > 0) q_pe -= (int)(4.343 * std::log(n_sub + 1) + .499);
        if (q_pe < 0) q_pe = 0;
        if (q_pe > 60) q_pe = 60;
        q_pe = (int)(q_pe * (1. - .5 * (a[0][0].frac_rep +
                                        a[1][0].frac_rep)) + .499);
        int q_se[2] = {0, 0};
        if (score > score_un) {  // paired alignment preferred
          for (int i = 0; i < 2; ++i) {
            Reg &c = a[i][z[i]];
            if (c.secondary >= 0) {
              c.sub = a[i][c.secondary].score;
              c.secondary = -2;
            }
            q_se[i] = approx_mapq_se(o, c);
          }
          for (int i = 0; i < 2; ++i)
            q_se[i] = q_se[i] > q_pe ? q_se[i]
                                     : std::min(q_pe, q_se[i] + 40);
          extra_flag |= 2;
          for (int i = 0; i < 2; ++i) {
            const Reg &c = a[i][z[i]];
            q_se[i] = std::min(q_se[i], raw_mapq(c.score - c.csub, o.a));
          }
        } else {
          z[0] = z[1] = 0;
          q_se[0] = approx_mapq_se(o, a[0][0]);
          q_se[1] = approx_mapq_se(o, a[1][0]);
        }
        for (int i = 0; i < 2; ++i) {  // promote to primary (350-359)
          int k = a[i][z[i]].secondary_all;
          if (k >= 0 && k < n_pri[i]) {
            for (int j = 0; j < (int)a[i].size(); ++j)
              if (a[i][j].secondary_all == k || j == k)
                a[i][j].secondary_all = z[i];
            a[i][z[i]].secondary_all = -1;
          }
        }
        lap.to(bt_trace::PAIR);
        std::vector<std::string> XA[2];
        bool have_xa = false;
        if (!(o.flag & MEM_F_ALL)) {
          for (int i = 0; i < 2; ++i)
            gen_alt(o, r, a[i], l_seq[i], codes[i], XA[i]);
          have_xa = true;
        }
        Aln h[2];
        std::vector<Aln> aa[2];
        for (int i = 0; i < 2; ++i) {
          h[i] = reg2aln(o, r, l_seq[i], codes[i], &a[i][z[i]]);
          h[i].mapq = q_se[i];
          h[i].flag |= (0x40 << i) | extra_flag;
          if (have_xa && !XA[i].empty()) h[i].XA = XA[i][z[i]];
          aa[i].push_back(h[i]);
          if (n_pri[i] < (int)a[i].size()) {  // ALT supplementary
            const Reg &p = a[i][n_pri[i]];
            if (p.score < o.T || p.secondary >= 0 || !p.is_alt) continue;
            Aln g = reg2aln(o, r, l_seq[i], codes[i], &p);
            g.flag |= 0x800 | (0x40 << i) | extra_flag;
            if (have_xa && !XA[i].empty()) g.XA = XA[i][n_pri[i]];
            aa[i].push_back(std::move(g));
          }
        }
        for (int k = 0; k < (int)aa[0].size(); ++k)
          aln2sam(o, r, name, codes[0], l_seq[0], qual[0], comment[0],
                  (int)aa[0].size(), aa[0], k, &h[1], rg_id, sams[0]);
        for (int k = 0; k < (int)aa[1].size(); ++k)
          aln2sam(o, r, name, codes[1], l_seq[1], qual[1], comment[1],
                  (int)aa[1].size(), aa[1], k, &h[0], rg_id, sams[1]);
        return n;
      }
    }
  }
  // no_pairing (bwamem_pair.c:397-418)
  lap.to(bt_trace::PAIR);
  Aln h[2];
  for (int i = 0; i < 2; ++i) {
    int which = -1;
    if (!a[i].empty()) {
      if (a[i][0].score >= o.T) which = 0;
      else if (n_pri[i] < (int)a[i].size() &&
               a[i][n_pri[i]].score >= o.T)
        which = n_pri[i];
    }
    h[i] = reg2aln(o, r, l_seq[i], codes[i],
                   which >= 0 ? &a[i][which] : nullptr);
  }
  if (!(o.flag & MEM_F_NOPAIRING) && h[0].rid == h[1].rid && h[0].rid >= 0 &&
      !a[0].empty() && !a[1].empty()) {
    int64_t dist;
    int d = infer_dir(r.l_pac, a[0][0].rb, a[1][0].rb, &dist);
    if (!pes[d].failed && dist >= pes[d].low && dist <= pes[d].high)
      extra_flag |= 2;
  }
  reg2sam_se(o, r, name, codes[0], l_seq[0], qual[0], comment[0], a[0],
             0x41 | extra_flag, &h[1], rg_id, sams[0]);
  reg2sam_se(o, r, name, codes[1], l_seq[1], qual[1], comment[1], a[1],
             0x81 | extra_flag, &h[0], rg_id, sams[1]);
  return n;
}

// Batch-extension callback (device speculative extension): receives the
// job table from collect_ext_jobs and fills per-job left/right results
// (6 int32 each: score, qle, tle, gtle, gscore, band-used).  Installed
// from Python via mem_set_ext_cb; when set, the finalize entries below
// run chaining first for the whole batch, hand the extension problems to
// the callback in one call, then run the serial per-read loops with the
// DP calls replaced by table reads.  The callback may resolve any SUBSET
// of jobs (e.g. only the first-in-chain jobs, `first` marks them): rows
// left at EXT_UNRESOLVED fall back to the inline scalar DP when (rarely)
// consumed.
typedef void (*mem_ext_cb_t)(int64_t njobs, const int64_t *meta,
                             const uint8_t *first, int32_t *lres,
                             int32_t *rres);
static mem_ext_cb_t g_ext_cb = nullptr;

namespace {

// Phase A for the callback path: chains for every read + the job table.
void build_chains_and_jobs(
    const MemOpt &o, const RefView &r, int32_t n_reads,
    const uint8_t *codes_flat, const int64_t *l_off,
    const int32_t *iv_off, const int64_t *iv_x2, const int32_t *iv_start,
    const int32_t *iv_end, const int64_t *rbegs, const int32_t *rb_off,
    std::vector<std::vector<Chain>> &chains_all,
    std::vector<int32_t> &lres_v, std::vector<int32_t> &rres_v) {
  chains_all.resize(n_reads);
  std::vector<int64_t> meta;
  std::vector<uint8_t> first;
  const bool tr = bt_trace::on();
  for (int32_t i = 0; i < n_reads; ++i) {
    bt_trace::Lap lap(tr);
    const uint8_t *codes = codes_flat + l_off[i];
    int l_query = (int)(l_off[i + 1] - l_off[i]);
    std::vector<Chain> &chains = chains_all[i];
    int iv0 = iv_off[i], iv1 = iv_off[i + 1];
    chain_read(o, r, l_query, iv1 - iv0, iv_x2 + iv0, iv_start + iv0,
               iv_end + iv0, rbegs, rb_off + iv0, chains);
    chain_flt(o, chains);
    flt_chained_seeds(o, r, l_query, codes, chains);
    lap.to(bt_trace::CHAIN);
    collect_ext_jobs(o, r, l_query, l_off[i], chains, meta, first);
    lap.to(bt_trace::EXTEND);
  }
  bt_trace::Lap lap(tr);
  int64_t njobs = (int64_t)meta.size() / 8;
  lres_v.assign((size_t)njobs * 6, EXT_UNRESOLVED);
  rres_v.assign((size_t)njobs * 6, EXT_UNRESOLVED);
  if (njobs)
    g_ext_cb(njobs, meta.data(), first.data(), lres_v.data(), rres_v.data());
  lap.to(bt_trace::EXTEND);
}

}  // namespace

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

int memfin_opt_size() { return (int)sizeof(MemOpt); }

// One-hit CIGAR/MD/NM for the BWA-SW SAM writer (bwtsw2_aux.c:173-212
// delegates to bwa_gen_cigar2, bwa.c:160-230): pac extraction + banded
// global + MD in one call.  Returns 1 on success, 0 for the reference's
// "no cigar" cases (query empty / hit bridges the fwd/rev boundary /
// rlen mismatch), -1 if md_out is too small.  mat is the 5x5
// match/mismatch matrix fill_scmat(a, b); gap open/extend = q/r on both
// sides (bwtsw2's scoring has no del/ins asymmetry).
int bt_gen_cigar2(const uint8_t *pac, int64_t l_pac, int32_t a, int32_t b,
                  int32_t q_pen, int32_t r_pen, int32_t w_, int32_t l_query,
                  const uint8_t *query, int64_t rb, int64_t re,
                  uint32_t *cigar_out, int32_t cigar_cap,
                  int32_t *n_cigar_out, int32_t *nm_out, char *md_out,
                  int32_t md_cap, int32_t *score_out) {
  MemOpt o;
  std::memset(&o, 0, sizeof o);
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j)
      o.mat[i * 5 + j] = (i == 4 || j == 4) ? -1 : (i == j ? (int8_t)a
                                                           : (int8_t)-b);
  o.a = a;
  o.b = b;
  o.o_del = o.o_ins = q_pen;
  o.e_del = o.e_ins = r_pen;
  RefView r{pac, l_pac, ContigView{}};
  std::vector<uint32_t> cigar;
  std::string md;
  int NM = -1;
  bool ok = false;
  int score = gen_cigar2(o, r, w_, l_query, query, rb, re, true, &cigar,
                         &NM, &md, &ok);
  if (!ok) return 0;
  if ((int32_t)cigar.size() > cigar_cap || (int32_t)md.size() + 1 > md_cap)
    return -1;
  std::memcpy(cigar_out, cigar.data(), cigar.size() * sizeof(uint32_t));
  *n_cigar_out = (int32_t)cigar.size();
  std::memcpy(md_out, md.c_str(), md.size() + 1);
  *nm_out = NM;
  *score_out = score;
  return 1;
}

void mem_set_ext_cb(void *cb) { g_ext_cb = (mem_ext_cb_t)cb; }

// The calling thread's tracing (trace.h): begin zeroes it and switches it
// on; take writes the phase ns, the counts, the span count and the spans
// (5 int64 each), in trace.h's order, and switches it off.
void bt_trace_begin() {
  bt_trace::state() = bt_trace::State();
  bt_trace::state().on = true;
}

void bt_trace_take(int64_t *out) {
  bt_trace::State &s = bt_trace::state();
  int64_t *p = out;
  for (int i = 0; i < bt_trace::N_PHASES; ++i) *p++ = s.phase_ns[i];
  for (int i = 0; i < bt_trace::N_COUNTS; ++i) *p++ = s.count[i];
  *p++ = s.n_spans;
  for (int j = 0; j < bt_trace::MAX_SPANS; ++j)
    for (int k = 0; k < 5; ++k) *p++ = s.spans[j][k];
  s.on = false;
}

// Finalize a batch of SE reads.  Layout:
//  reads: codes_flat[sum l], l_off[n+1]; names/quals/comments as NUL-
//  concatenated blobs with offsets (qual_off[i]<0 -> no qual).
//  seeds: per read iv ranges [iv_off[i], iv_off[i+1]) over iv_x2/iv_start/
//  iv_end; occurrence positions rbegs with per-interval [rb_off] extents.
//  Output: SAM text appended per read into one buffer; out_off[n+1] filled.
//  Returns total SAM length, or -needed if out_cap is too small.
int64_t mem_finalize_se_batch(
    const void *opt_blob,
    // reference
    const uint8_t *pac, int64_t l_pac, const int64_t *ctg_offset,
    const int32_t *ctg_len, const uint8_t *ctg_is_alt, const char *ctg_names,
    const int32_t *ctg_name_off, int32_t n_ctg,
    // reads
    int32_t n_reads, const uint8_t *codes_flat, const int64_t *l_off,
    const char *names, const int64_t *name_off, const char *quals,
    const int64_t *qual_off, const char *comments, const int64_t *comment_off,
    int64_t id0, const int64_t *ids, const char *rg_id,
    // seeds
    const int32_t *iv_off, const int64_t *iv_x2, const int32_t *iv_start,
    const int32_t *iv_end, const int64_t *rbegs, const int32_t *rb_off,
    // out
    char *out, int64_t out_cap, int64_t *out_off) {
  const MemOpt &o = *(const MemOpt *)opt_blob;
  RefView r{pac, l_pac,
            {ctg_offset, ctg_len, ctg_is_alt, ctg_names, ctg_name_off, n_ctg}};
  std::string all;
  out_off[0] = 0;
  const bool tr = bt_trace::on();
  bt_trace::Span regions(bt_trace::FIN_REGIONS);
  const bool use_cb = g_ext_cb != nullptr;
  std::vector<std::vector<Chain>> chains_all;
  std::vector<int32_t> lres_v, rres_v;
  int64_t job_ctr = 0;
  if (use_cb)
    build_chains_and_jobs(o, r, n_reads, codes_flat, l_off, iv_off, iv_x2,
                          iv_start, iv_end, rbegs, rb_off, chains_all,
                          lres_v, rres_v);
  for (int32_t i = 0; i < n_reads; ++i) {
    const uint8_t *codes = codes_flat + l_off[i];
    int l_query = (int)(l_off[i + 1] - l_off[i]);
    std::vector<Chain> chains_local;
    int iv0 = iv_off[i], iv1 = iv_off[i + 1];
    bt_trace::Lap lap(tr);
    if (!use_cb) {
      chain_read(o, r, l_query, iv1 - iv0, iv_x2 + iv0, iv_start + iv0,
                 iv_end + iv0, rbegs, rb_off + iv0, chains_local);
      chain_flt(o, chains_local);
      flt_chained_seeds(o, r, l_query, codes, chains_local);
    }
    lap.to(bt_trace::CHAIN);
    std::vector<Chain> &chains = use_cb ? chains_all[i] : chains_local;
    std::vector<Reg> regs;
    for (const Chain &c : chains)
      chain2aln(o, r, l_query, codes, c, regs,
                use_cb ? lres_v.data() : nullptr,
                use_cb ? rres_v.data() : nullptr,
                use_cb ? &job_ctr : nullptr);
    sort_dedup_patch(o, r, codes, regs);
    lap.to(bt_trace::EXTEND);
    for (Reg &p : regs)
      if (p.rid >= 0 && r.bns.is_alt[p.rid]) p.is_alt = 1;
    // ids: per-read hash_64 seed (bwamem.c:1250's n_processed + i) when
    // the caller feeds reads in a permuted order (trip-sorted seeding
    // buckets) — the tie-break hash must use the ORIGINAL read index
    mark_primary_se(o, regs, ids ? ids[i] : id0 + i);
    if (o.flag & MEM_F_PRIMARY5) reorder_primary5(o.T, regs);
    lap.to(bt_trace::PAIR);
    std::string sam;
    const char *qual = qual_off[i] >= 0 ? quals + qual_off[i] : nullptr;
    const char *comment =
        comment_off[i] >= 0 ? comments + comment_off[i] : nullptr;
    reg2sam_se(o, r, names + name_off[i], codes, l_query, qual, comment,
               regs, 0, nullptr, rg_id, sam);
    all += sam;
    out_off[i + 1] = (int64_t)all.size();
    lap.to(bt_trace::SAM);
  }
  regions.end();
  if ((int64_t)all.size() > out_cap) return -(int64_t)all.size();
  memcpy(out, all.data(), all.size());
  return (int64_t)all.size();
}


// Finalize a batch of PE reads (even count, pairs interleaved).  Same flat
// layout as the SE entry; pes0 (4x[failed,low,high,avg,std] doubles) is
// used when has_pes0, otherwise the insert-size distribution is inferred
// from this batch (mem_pestat).  id0 is n_processed (read granularity).
int64_t mem_finalize_pe_batch(
    const void *opt_blob,
    const uint8_t *pac, int64_t l_pac, const int64_t *ctg_offset,
    const int32_t *ctg_len, const uint8_t *ctg_is_alt, const char *ctg_names,
    const int32_t *ctg_name_off, int32_t n_ctg,
    int32_t n_reads, const uint8_t *codes_flat, const int64_t *l_off,
    const char *names, const int64_t *name_off, const char *quals,
    const int64_t *qual_off, const char *comments, const int64_t *comment_off,
    int64_t id0, const char *rg_id,
    const int32_t *iv_off, const int64_t *iv_x2, const int32_t *iv_start,
    const int32_t *iv_end, const int64_t *rbegs, const int32_t *rb_off,
    const double *pes0, int32_t has_pes0,
    char *out, int64_t out_cap, int64_t *out_off) {
  const MemOpt &o = *(const MemOpt *)opt_blob;
  RefView r{pac, l_pac,
            {ctg_offset, ctg_len, ctg_is_alt, ctg_names, ctg_name_off, n_ctg}};
  const bool tr = bt_trace::on();
  // phase 1: per-read alignment regions (worker1)
  const bool use_cb = g_ext_cb != nullptr;
  std::vector<std::vector<Chain>> chains_all;
  std::vector<int32_t> lres_v, rres_v;
  int64_t job_ctr = 0;
  std::vector<std::vector<Reg>> regs(n_reads);
  bt_trace::Span regions(bt_trace::FIN_REGIONS);
  if (use_cb)
    build_chains_and_jobs(o, r, n_reads, codes_flat, l_off, iv_off, iv_x2,
                          iv_start, iv_end, rbegs, rb_off, chains_all,
                          lres_v, rres_v);
  for (int32_t i = 0; i < n_reads; ++i) {
    const uint8_t *codes = codes_flat + l_off[i];
    int l_query = (int)(l_off[i + 1] - l_off[i]);
    std::vector<Chain> chains_local;
    int iv0 = iv_off[i], iv1 = iv_off[i + 1];
    bt_trace::Lap lap(tr);
    if (!use_cb) {
      chain_read(o, r, l_query, iv1 - iv0, iv_x2 + iv0, iv_start + iv0,
                 iv_end + iv0, rbegs, rb_off + iv0, chains_local);
      chain_flt(o, chains_local);
      flt_chained_seeds(o, r, l_query, codes, chains_local);
    }
    lap.to(bt_trace::CHAIN);
    std::vector<Chain> &chains = use_cb ? chains_all[i] : chains_local;
    for (const Chain &c : chains)
      chain2aln(o, r, l_query, codes, c, regs[i],
                use_cb ? lres_v.data() : nullptr,
                use_cb ? rres_v.data() : nullptr,
                use_cb ? &job_ctr : nullptr);
    sort_dedup_patch(o, r, codes, regs[i]);
    for (Reg &p : regs[i])
      if (p.rid >= 0 && r.bns.is_alt[p.rid]) p.is_alt = 1;
    lap.to(bt_trace::EXTEND);
  }
  regions.end();
  // phase 2: insert-size statistics (the one batch-global sync)
  bt_trace::Span pestat(bt_trace::FIN_PESTAT);
  PeStat pes[4];
  if (has_pes0) {
    for (int d = 0; d < 4; ++d) {
      pes[d].failed = (int)pes0[d * 5 + 0];
      pes[d].low = (int)pes0[d * 5 + 1];
      pes[d].high = (int)pes0[d * 5 + 2];
      pes[d].avg = pes0[d * 5 + 3];
      pes[d].std = pes0[d * 5 + 4];
    }
  } else {
    pe_stat(o, l_pac, regs, pes);
  }
  pestat.end();
  // phase 3: per-pair rescue/pairing/SAM (worker2)
  bt_trace::Span pairs(bt_trace::FIN_PAIRS);
  std::string all;
  out_off[0] = 0;
  for (int32_t i = 0; i < n_reads >> 1; ++i) {
    bt_trace::Lap lap(tr);
    std::vector<Reg> a[2] = {std::move(regs[i * 2]),
                             std::move(regs[i * 2 + 1])};
    const uint8_t *codes[2] = {codes_flat + l_off[i * 2],
                               codes_flat + l_off[i * 2 + 1]};
    int l_seq[2] = {(int)(l_off[i * 2 + 1] - l_off[i * 2]),
                    (int)(l_off[i * 2 + 2] - l_off[i * 2 + 1])};
    const char *qual[2] = {
        qual_off[i * 2] >= 0 ? quals + qual_off[i * 2] : nullptr,
        qual_off[i * 2 + 1] >= 0 ? quals + qual_off[i * 2 + 1] : nullptr};
    const char *comment[2] = {
        comment_off[i * 2] >= 0 ? comments + comment_off[i * 2] : nullptr,
        comment_off[i * 2 + 1] >= 0 ? comments + comment_off[i * 2 + 1]
                                    : nullptr};
    std::string sams[2];
    sam_pe(o, r, pes, (id0 >> 1) + i, names + name_off[i * 2], codes, l_seq,
           qual, comment, a, rg_id, sams, lap);
    all += sams[0];
    out_off[i * 2 + 1] = (int64_t)all.size();
    all += sams[1];
    out_off[i * 2 + 2] = (int64_t)all.size();
    lap.to(bt_trace::SAM);
  }
  pairs.end();
  if ((int64_t)all.size() > out_cap) return -(int64_t)all.size();
  memcpy(out, all.data(), all.size());
  return (int64_t)all.size();
}

}  // extern "C"
