// Backtrack gapped search (bwa aln) — native batch engine.
//
// C++ implementation of the framework's validated executable spec
// (bwa_tpu/aln/search.py): bwt_cal_width lower bounds (bwtaln.c:57-81)
// and the best-first bounded-difference search bwt_match_gap
// (bwtgap.c:109-264) with its score-bucketed LIFO stack, gap-shadow
// width adjustment and seed-region limits.  Operates directly on the
// framework's split (ckpt, words) FM-index arrays like native/bsw2.cpp.

#include <cstdint>
#include <cstring>
#include <vector>

#include "occ64.h"

namespace {

// interleaved occ blocks: per 128 bases, 4 int64 counts + 8 uint32
// text words = exactly one 64-byte cache line (the reference's
// bwt.h:73-80 layout rationale; the split ckpt/words arrays cost two
// misses per occ and made the search memory-bound).  Decode lives in
// occ64.h, shared with btsam/bsw2.
using FM = occ64::View;
using occ64::occ1;
using occ64::occ1_pair;
using occ64::occ4;
using occ64::occ4_pair;


struct Opt {
  int s_mm, s_gapo, s_gape;
  int max_gape, max_seed_diff, max_entries, max_del_occ;
  int indel_end_skip, max_top2, mode;
  bool pf;  // prefetch pushed entries' occ lines (big-genome only)
};

enum { MODE_GAPE = 0x01, MODE_LOGGAP = 0x04, MODE_NONSTOP = 0x10 };
enum { ST_M = 0, ST_I = 1, ST_D = 2 };

struct Width {
  int64_t w;
  int bid;
};

// 32 bytes (was 56): the best-first loop is bound by entry churn, and
// the .sai record format itself caps n_mm/n_gapo/n_gape at 8 bits and
// n_ins/n_del at 10 (bwtaln.h bitfields), so narrow fields lose nothing
struct Entry {
  int64_t k, l;
  int32_t i, ldp;
  int16_t n_ins, n_del;
  uint8_t n_mm, n_gapo, n_gape, state;
};

// brace-init order helper so call sites keep the old readable order
static inline Entry mkent(int i, int64_t k, int64_t l, int n_mm,
                          int n_gapo, int n_gape, int n_ins, int n_del,
                          int state, int ldp) {
  Entry e;
  e.k = k; e.l = l; e.i = i; e.ldp = ldp;
  e.n_ins = (int16_t)n_ins; e.n_del = (int16_t)n_del;
  e.n_mm = (uint8_t)n_mm; e.n_gapo = (uint8_t)n_gapo;
  e.n_gape = (uint8_t)n_gape; e.state = (uint8_t)state;
  return e;
}

struct AlnRec {
  int64_t n_mm, n_gapo, n_gape, score, n_ins, n_del, k, l;
};

static inline int aln_score(int m, int o, int e, const Opt &opt) {
  return m * opt.s_mm + o * opt.s_gapo + e * opt.s_gape;
}

// Touch the occ cache lines a pushed entry will read when popped
// (occ4_pair over k-1 and l).  The LIFO stack pops same-score pushes
// next, so the lines arrive ahead of the dependent load; the search is
// memory-bound on these 64-byte blocks — but ONLY on indexes too big
// for the LLC (call sites gate on opt.pf; see bt_aln_batch).
static inline void pf_occ(const FM &g, int64_t k, int64_t l) {
  int64_t a = k - 1;
  if (a >= 0 && a < g.seq_len) {
    if (a >= g.primary) --a;
    __builtin_prefetch(g.inter + (a >> 7) * 64);
  }
  if (l >= 0 && l < g.seq_len) {
    if (l >= g.primary) --l;
    __builtin_prefetch(g.inter + (l >> 7) * 64);
  }
}

// bwt_cal_width (bwtaln.c:57-81) over up to several reads in lockstep.
// One read's occ chain is strictly latency-bound (each occ1_pair feeds
// the next k/l), but chains are independent ACROSS reads — interleaving
// lanes lets the out-of-order core overlap their loads/popcounts.  The
// reference computes widths one read at a time (bwtaln.c:120-123);
// per-lane semantics here are exactly its loop.
struct WLane {
  const uint8_t *seq;
  int len;
  int64_t k, l;
  int bid;
  Width *out;
};

static void cal_width_multi(const FM &g, WLane *ln, int nl) {
  int maxlen = 0;
  for (int t = 0; t < nl; ++t) {
    ln[t].k = 0;
    ln[t].l = g.seq_len;
    ln[t].bid = 0;
    if (ln[t].len > maxlen) maxlen = ln[t].len;
  }
  for (int p = 0; p < maxlen; ++p) {
    for (int t = 0; t < nl; ++t) {
      WLane &s = ln[t];
      if (p >= s.len) continue;
      int c = s.seq[p];
      if (c < 4) {
        int64_t ok, ol;
        occ1_pair(g, s.k - 1, s.l, c, &ok, &ol);
        s.k = g.L2[c] + ok + 1;
        s.l = g.L2[c] + ol;
      }
      if (s.k > s.l || c > 3) {
        s.k = 0;
        s.l = g.seq_len;
        ++s.bid;
      }
      s.out[p] = {s.l - s.k + 1, s.bid};
    }
  }
  for (int t = 0; t < nl; ++t) ln[t].out[ln[t].len] = {0, ln[t].bid + 1};
}

static inline int int_log2(uint32_t v) {
  int c = 0;
  if (v & 0xffff0000u) v >>= 16, c |= 16;
  if (v & 0xff00u) v >>= 8, c |= 8;
  if (v & 0xf0u) v >>= 4, c |= 4;
  if (v & 0xcu) v >>= 2, c |= 2;
  if (v & 0x2u) c |= 1;
  return c;
}

struct GapStack {  // score-bucketed LIFO (bwtgap.c:17-84)
  std::vector<std::vector<Entry>> stacks;
  int best;
  int64_t n = 0;
  explicit GapStack(int n_stacks) : stacks(n_stacks), best(n_stacks) {}
  // persistent across reads (the reference allocates once per thread and
  // gap_reset_stack's per read, bwtaln.c:94): keep substack capacity,
  // just grow the bucket count when a read's score ceiling is higher
  void reset(int n_stacks) {
    if ((int)stacks.size() < n_stacks) stacks.resize(n_stacks);
    if (n) {
      for (auto &s : stacks) s.clear();
      n = 0;
    }
    best = (int)stacks.size();
  }
  void push(const Entry &e, int score) {
    stacks[score].push_back(e);
    ++n;
    if (best > score) best = score;
  }
  Entry pop() {
    std::vector<Entry> &q = stacks[best];
    Entry e = q.back();
    q.pop_back();
    --n;
    if (q.empty() && n) {
      int i = best + 1;
      while (i < (int)stacks.size() && stacks[i].empty()) ++i;
      best = i;
    } else if (n == 0) {
      best = (int)stacks.size();
    }
    return e;
  }
};

// bwt_match_exact_alt over seq[0:i]
static int match_exact_alt(const FM &g, const uint8_t *seq, int i,
                           int64_t *k_, int64_t *l_) {
  int64_t k = *k_, l = *l_;
  for (int j = i - 1; j >= 0; --j) {
    int c = seq[j];
    if (c > 3) return 0;
    int64_t ok, ol;
    occ1_pair(g, k - 1, l, c, &ok, &ol);
    k = g.L2[c] + ok + 1;
    l = g.L2[c] + ol;
    if (k > l) return 0;
  }
  *k_ = k;
  *l_ = l;
  return 1;
}

// bwt_match_gap; seq is the reverse complement of the read
static void match_gap(const FM &g, const uint8_t *seq, int length,
                      std::vector<Width> &width,
                      std::vector<Width> *seed_width, int max_diff_in,
                      int max_gapo, const Opt &opt, GapStack &stack,
                      std::vector<AlnRec> *alns) {
  int best_score = aln_score(max_diff_in + 1, max_gapo + 1,
                             opt.max_gape + 1, opt);
  int best_diff = max_diff_in + 1;
  int max_diff = max_diff_in;
  int64_t best_cnt = 0;
  alns->clear();

  int n_amb = 0;
  for (int p = 0; p < length; ++p) n_amb += seq[p] > 3;
  if (n_amb > max_diff) return;

  stack.reset(aln_score(max_diff_in + 1, max_gapo + 1,
                        opt.max_gape + 1, opt));
  stack.push(mkent(length, 0, g.seq_len, 0, 0, 0, 0, 0, ST_M, 0), 0);

  while (stack.n) {
    if (stack.n > opt.max_entries) break;
    // the bucket index IS aln_score(n_mm, n_gapo, n_gape) — entries are
    // pushed into stacks[score], so the pop's score needs no recompute
    int score = stack.best;
    Entry e = stack.pop();
    int i = e.i;
    int64_t k = e.k, l = e.l;
    if (!(opt.mode & MODE_NONSTOP) && score > best_score + opt.s_mm) break;

    int m = max_diff - (e.n_mm + e.n_gapo);
    if (opt.mode & MODE_GAPE) m -= e.n_gape;
    if (m < 0) continue;
    int m_seed = 0;
    if (seed_width) {
      m_seed = opt.max_seed_diff - (e.n_mm + e.n_gapo);
      if (opt.mode & MODE_GAPE) m_seed -= e.n_gape;
    }
    if (i > 0 && m < width[i - 1].bid) continue;

    bool hit_found = false;
    if (i == 0) {
      hit_found = true;
    } else if (m == 0 && (e.state == ST_M || (opt.mode & MODE_GAPE)
                          || e.n_gape == opt.max_gape)) {
      if (match_exact_alt(g, seq, i, &k, &l)) hit_found = true;
      else continue;
    }

    if (hit_found) {
      bool do_add = true;
      if (alns->empty()) {
        best_score = score;
        best_diff = e.n_mm + e.n_gapo;
        if (opt.mode & MODE_GAPE) best_diff += e.n_gape;
        if (!(opt.mode & MODE_NONSTOP))
          max_diff = best_diff + 1 > max_diff_in ? max_diff_in
                                                 : best_diff + 1;
      }
      if (score == best_score) best_cnt += l - k + 1;
      else if (best_cnt > opt.max_top2) break;
      if (e.n_gapo) {  // tandem-repeat duplicate check
        for (const AlnRec &a : *alns)
          if (a.k == k && a.l == l) { do_add = false; break; }
      }
      if (do_add) {
        // gap_shadow (bwtgap.c:86-96)
        int64_t x = l - k + 1;
        int64_t jj = 0;
        for (int t = 0; t < e.ldp; ++t) {
          if (width[t].w > x) {
            width[t].w -= x;
          } else if (width[t].w == x) {
            ++jj;
            width[t] = {g.seq_len - jj, 1};
          }
        }
        alns->push_back({e.n_mm, e.n_gapo, e.n_gape, score, e.n_ins,
                         e.n_del, k, l});
      }
      continue;
    }

    --i;
    int64_t cnt_k[4], cnt_l[4];
    occ4_pair(g, k - 1, l, cnt_k, cnt_l);
    int64_t occ = l - k + 1;
    bool allow_diff = true, allow_M = true;
    if (i > 0) {
      if (width[i - 1].bid > m - 1) allow_diff = false;
      else if (width[i - 1].bid == m - 1 && width[i].bid == m - 1
               && width[i - 1].w == width[i].w)
        allow_M = false;
      if (seed_width) {
        int ii = i - (length - (int)(seed_width->size() - 1));
        if (ii > 0) {
          if ((*seed_width)[ii - 1].bid > m_seed - 1) allow_diff = false;
          else if ((*seed_width)[ii - 1].bid == m_seed - 1
                   && (*seed_width)[ii].bid == m_seed - 1
                   && (*seed_width)[ii - 1].w == (*seed_width)[ii].w)
            allow_M = false;
        }
      }
    }

    int tmp = (opt.mode & MODE_LOGGAP)
                  ? int_log2((uint32_t)(e.n_gape + e.n_gapo)) / 2 + 1
                  : e.n_gapo + e.n_gape;
    if (allow_diff && i >= opt.indel_end_skip + tmp
        && length - i >= opt.indel_end_skip + tmp) {
      if (e.state == ST_M) {
        if (e.n_gapo < max_gapo) {
          // insertion
          stack.push(mkent(i, k, l, e.n_mm, e.n_gapo + 1, e.n_gape,
                           e.n_ins + 1, e.n_del, ST_I, i),
                     score + opt.s_gapo);
          // deletions
          for (int j = 0; j < 4; ++j) {
            int64_t kk = g.L2[j] + cnt_k[j] + 1;
            int64_t ll = g.L2[j] + cnt_l[j];
            if (kk <= ll) {
              stack.push(mkent(i + 1, kk, ll, e.n_mm, e.n_gapo + 1,
                               e.n_gape, e.n_ins, e.n_del + 1, ST_D, i + 1),
                         score + opt.s_gapo);
              if (opt.pf) pf_occ(g, kk, ll);
            }
          }
        }
      } else if (e.state == ST_I) {
        if (e.n_gape < opt.max_gape)
          stack.push(mkent(i, k, l, e.n_mm, e.n_gapo, e.n_gape + 1,
                           e.n_ins + 1, e.n_del, ST_I, i),
                     score + opt.s_gape);
      } else if (e.state == ST_D) {
        if (e.n_gape < opt.max_gape) {
          if (e.n_gape + e.n_gapo < max_diff || occ < opt.max_del_occ) {
            for (int j = 0; j < 4; ++j) {
              int64_t kk = g.L2[j] + cnt_k[j] + 1;
              int64_t ll = g.L2[j] + cnt_l[j];
              if (kk <= ll) {
                stack.push(mkent(i + 1, kk, ll, e.n_mm, e.n_gapo,
                                 e.n_gape + 1, e.n_ins, e.n_del + 1, ST_D,
                                 i + 1),
                           score + opt.s_gape);
                if (opt.pf) pf_occ(g, kk, ll);
              }
            }
          }
        }
      }
    }
    if (allow_diff && allow_M) {
      for (int j = 1; j <= 4; ++j) {
        int c = (seq[i] + j) & 3;
        int is_mm = (j != 4 || seq[i] > 3) ? 1 : 0;
        int64_t kk = g.L2[c] + cnt_k[c] + 1;
        int64_t ll = g.L2[c] + cnt_l[c];
        if (kk <= ll) {
          stack.push(mkent(i, kk, ll, e.n_mm + is_mm, e.n_gapo, e.n_gape,
                           e.n_ins, e.n_del, ST_M, is_mm ? i : 0),
                     score + (is_mm ? opt.s_mm : 0));
          if (opt.pf) pf_occ(g, kk, ll);
        }
      }
    } else if (seq[i] < 4) {
      int c = seq[i] & 3;
      int64_t kk = g.L2[c] + cnt_k[c] + 1;
      int64_t ll = g.L2[c] + cnt_l[c];
      if (kk <= ll) {
        stack.push(mkent(i, kk, ll, e.n_mm, e.n_gapo, e.n_gape, e.n_ins,
                         e.n_del, ST_M, 0),
                   score);
        if (opt.pf) pf_occ(g, kk, ll);
      }
    }
  }
}

}  // namespace

extern "C" {

// Batch `aln` search.  seqs_flat holds the STORED (reversed) reads per
// bwaseqio; width/seed-width/complement are derived here.  Per read:
// max_diff/max_gapo/seed_len precomputed by the caller (fnr logic).
// Records are 8 int64 each; returns total records or -needed if rec_cap
// is too small.
int64_t bt_aln_batch(const uint8_t *g_inter,
                     int64_t g_seq_len, int64_t g_primary,
                     const int64_t *g_L2, const uint8_t *seqs_flat,
                     const int64_t *seq_off, int32_t n_reads,
                     const int32_t *max_diff, const int32_t *max_gapo,
                     const int32_t *seed_len, int32_t s_mm, int32_t s_gapo,
                     int32_t s_gape, int32_t max_gape,
                     int32_t max_seed_diff, int32_t max_entries,
                     int32_t max_del_occ, int32_t indel_end_skip,
                     int32_t max_top2, int32_t mode, int32_t *out_n,
                     int64_t *out_rec, int64_t rec_cap) {
  FM g{g_inter, g_seq_len, g_primary, g_L2};
  // prefetch pays only when the occ lines actually miss: the interleaved
  // index is seq_len/2 bytes, so small genomes are LLC-resident and the
  // prefetch instructions were a measured 11% CPU tax (gprof, 262k reads
  // on a 2 Mbp index).  256 Mbp of BWT ~= 128 MB, ~half this box's LLC.
  Opt opt{s_mm, s_gapo, s_gape, max_gape, max_seed_diff, max_entries,
          max_del_occ, indel_end_skip, max_top2, mode,
          g_seq_len > (int64_t)256e6};
  // widths for G reads at a time: the main and seed chains of the whole
  // group run interleaved through cal_width_multi (up to 2G lanes)
  constexpr int G = 4;
  std::vector<Width> width[G], seed_w[G];
  std::vector<AlnRec> alns;
  std::vector<uint8_t> q;
  GapStack stack(0);
  int64_t tot = 0;
  for (int r0 = 0; r0 < n_reads; r0 += G) {
    int ng = n_reads - r0 < G ? n_reads - r0 : G;
    WLane lanes[2 * G];
    int nl = 0;
    bool has_sw[G];
    for (int j = 0; j < ng; ++j) {
      int r = r0 + j;
      const uint8_t *seq = seqs_flat + seq_off[r];
      int len = (int)(seq_off[r + 1] - seq_off[r]);
      width[j].resize(len + 1);
      lanes[nl++] = {seq, len, 0, 0, 0, width[j].data()};
      has_sw[j] = len > seed_len[r];
      if (has_sw[j]) {
        seed_w[j].resize(seed_len[r] + 1);
        lanes[nl++] = {seq + (len - seed_len[r]), seed_len[r], 0, 0, 0,
                       seed_w[j].data()};
      }
    }
    cal_width_multi(g, lanes, nl);
    for (int j = 0; j < ng; ++j) {
      int r = r0 + j;
      const uint8_t *seq = seqs_flat + seq_off[r];
      int len = (int)(seq_off[r + 1] - seq_off[r]);
      q.resize(len);
      for (int p = 0; p < len; ++p) q[p] = seq[p] > 3 ? 4 : 3 - seq[p];
      match_gap(g, q.data(), len, width[j], has_sw[j] ? &seed_w[j] : nullptr,
                max_diff[r], max_gapo[r], opt, stack, &alns);
      out_n[r] = (int32_t)alns.size();
      if (tot + (int64_t)alns.size() * 8 <= rec_cap) {
        std::memcpy(out_rec + tot, alns.data(),
                    alns.size() * sizeof(AlnRec));
      }
      tot += (int64_t)alns.size() * 8;
    }
  }
  return tot;
}

}  // extern "C"
