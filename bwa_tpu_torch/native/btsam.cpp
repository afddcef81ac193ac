// Native samse finalize: .sai records + reads -> SAM lines, one batch per
// call.  Ports the executable spec in aln/samse.py exactly (which is the
// byte-exact mirror of bwase.c:22-499): drand48 hit sampling, SA->coord,
// ksw_global gapped refinement, MD/NM, trimming correction and the SAM
// text of bwa_print_sam1.  The Python per-read loops were the samse
// bottleneck (aln+samse at 0.2x the oracle end of round 1).
//
// Everything lives in one .so: the ksw kernel is ksw.cpp's extern "C"
// bt_ksw_global2; the FM occ/invPsi walkers mirror bsw2.cpp's.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include "occ64.h"

extern "C" int bt_ksw_global2(int qlen, const uint8_t *query, int tlen,
                              const uint8_t *target, int m, const int8_t *mat,
                              int o_del, int e_del, int o_ins, int e_ins,
                              int w, int *n_cigar_out, uint32_t *cigar_out,
                              int cigar_cap);
extern "C" void bt_ksw_align2(int qlen, uint8_t *query, int tlen,
                              uint8_t *target, int m, const int8_t *mat,
                              int o_del, int e_del, int o_ins, int e_ins,
                              int use_byte, int use_start, int use_subo,
                              int use_stop, int thres, int *out);

namespace btsam {

// ---- drand48 (utils/rand48.py; POSIX LCG) ----
struct Rand48 {
  uint64_t x;
  static const uint64_t A = 0x5DEECE66DULL, C = 0xBULL,
                        MASK = (1ULL << 48) - 1;
  double drand48() {
    x = (A * x + C) & MASK;
    return (double)x / (double)(1ULL << 48);
  }
};

// ---- FM view (occ64.h View + the sampled SA) ----
struct FM : occ64::View {
  const int64_t *ssa;
  int32_t sa_intv;
  // optional dense rank->position sidecar (.sad.npy, index/build.py
  // write_sad_sidecar): sad[k] is byte-for-byte what the inverse-Psi
  // walk below returns (incl. sad[0] = -1), so lookups are
  // interchangeable -- and ~16x fewer cache misses per SA resolve.
  const void *sad = nullptr;
  bool sad64 = false;
};

using occ64::inv_psi;
using occ64::occ4;

static int64_t sa_value(const FM &g, int64_t k) {  // bwt_sa (bwt.c:86-96)
  if (g.sad)
    return g.sad64 ? ((const int64_t *)g.sad)[k]
                   : (int64_t)((const int32_t *)g.sad)[k];
  int64_t mask = g.sa_intv - 1, s = 0;
  while (k & mask) { ++s; k = inv_psi(g, k); }
  return s + g.ssa[k / g.sa_intv];
}

// ---- reference / contig view ----
struct Ref {
  const uint8_t *pac;
  int64_t l_pac;
  const int64_t *ctg_off;
  const int32_t *ctg_len;
  const int32_t *name_off;
  const char *names;
  int32_t n_ctg;
  const int64_t *amb_off;
  const int32_t *amb_len;
  int32_t n_amb;
};

static inline int pac_at(const Ref &r, int64_t k) {
  return r.pac[k >> 2] >> ((~k & 3) << 1) & 3;
}

static int pos2rid(const Ref &r, int64_t pos_f) {
  if (pos_f >= r.l_pac) return -1;
  int left = 0, mid = 0, right = r.n_ctg;
  while (left < right) {
    mid = (left + right) >> 1;
    if (pos_f >= r.ctg_off[mid]) {
      if (mid == r.n_ctg - 1) break;
      if (pos_f < r.ctg_off[mid + 1]) break;
      left = mid + 1;
    } else right = mid;
  }
  return mid;
}

// bns_cnt_ambi (bntseq.c:380-401): stops at first overlapping hole
static int cnt_ambi(const Ref &r, int64_t pos_f, int64_t len) {
  int left = 0, right = r.n_amb, nn = 0;
  while (left < right) {
    int mid = (left + right) >> 1;
    int64_t ho = r.amb_off[mid];
    int64_t hl = r.amb_len[mid];
    if (pos_f >= ho + hl) left = mid + 1;
    else if (pos_f + len <= ho) right = mid;
    else {
      if (pos_f >= ho)
        nn += (int)((ho + hl < pos_f + len) ? (ho + hl - pos_f) : len);
      else
        nn += (int)((ho + hl < pos_f + len) ? hl : (len - (ho - pos_f)));
      break;
    }
  }
  return nn;
}

// ---- per-read state ----
struct Aln1 {
  int n_mm, n_gapo, n_gape, score, n_ins, n_del;
  int64_t k, l;
};

struct Cig { std::vector<uint32_t> v; };  // packed op|len<<4? no: len<<4|op

struct Multi {
  int64_t pos;
  int gap, mm, strand, ref_shift;
  std::vector<uint32_t> cigar;  // len<<4|op (MIDS = 0..3); empty = none
  bool has_cigar = false;
};

enum { T_NO_MATCH = 0, T_UNIQUE = 1, T_REPEAT = 2, T_MATESW = 3 };

struct Seq {
  // inputs
  const uint8_t *codes;  // full_codes, original orientation
  const char *name;
  const uint8_t *qual;   // may be null
  int qual_len;
  std::string bc;
  int len, full_len, clip_len;
  // state
  int strand = 0, type = 0, n_mm = 0, n_gapo = 0, n_gape = 0;
  int mapQ = 0, seQ = 0, score = 0, c1 = 0, c2 = 0, ref_shift = 0, nm = 0;
  int extra_flag = 0;
  int64_t sa = 0, pos = -1;
  std::vector<Aln1> alns;
  std::vector<Multi> multi;
  std::vector<uint32_t> cigar;
  bool has_cigar = false;
  std::string md;
};

static int g_log_n_tab[256];
static void init_log_n() {
  static bool done = false;
  if (done) return;
  for (int i = 1; i < 256; ++i)
    g_log_n_tab[i] = (int)(4.343 * std::log((double)i) + 0.5);
  done = true;
}

// bwa_cal_maxdiff (bwtaln.c:42-54).  The reference's factorial lives in
// a C int and wraps (observable from k=13; exactly 0 at k=34 where the
// division yields inf) — keep the int32 wraparound so mapQ matches for
// long reads with fractional -n.
static int cal_maxdiff(int l, double err, double thres) {
  double elambda = std::exp(-l * err);
  double y = 1.0, total = elambda;
  uint32_t x = 1;
  for (int k = 1; k < 1000; ++k) {
    y *= l * err;
    x *= (uint32_t)k;
    total += elambda * y / (double)(int32_t)x;
    if (1.0 - total < thres) return k;
  }
  return 2;
}

// bwa_aln2seq_core (bwase.c:22-94 / aln/samse.py)
static void aln2seq_core(Seq &s, Rand48 &rng, int n_multi_req,
                         bool set_main = true) {
  const std::vector<Aln1> &alns = s.alns;
  if (alns.empty()) { s.type = T_NO_MATCH; s.c1 = s.c2 = 0; return; }
  if (set_main) {
  int best = alns[0].score;
  int64_t cnt = 0;
  size_t i;
  for (i = 0; i < alns.size(); ++i) {
    const Aln1 &p = alns[i];
    if (p.score > best) break;
    if (rng.drand48() * (double)(p.l - p.k + 1 + cnt) > (double)cnt) {
      s.n_mm = p.n_mm; s.n_gapo = p.n_gapo; s.n_gape = p.n_gape;
      s.ref_shift = p.n_del - p.n_ins;
      s.score = p.score;
      s.sa = p.k + (int64_t)((double)(p.l - p.k + 1) * rng.drand48());
    }
    cnt += p.l - p.k + 1;
  }
  s.c1 = (int)cnt;
  for (; i < alns.size(); ++i) cnt += alns[i].l - alns[i].k + 1;
  s.c2 = (int)cnt - s.c1;
  s.type = s.c1 > 1 ? T_REPEAT : T_UNIQUE;
  }

  if (n_multi_req) {
    int64_t n_occ = 0;
    for (const Aln1 &q : alns) n_occ += q.l - q.k + 1;
    s.multi.clear();
    if (n_occ > n_multi_req + 1) return;
    int64_t rest = n_occ < n_multi_req + 1 ? n_occ : n_multi_req + 1;
    for (const Aln1 &q : alns) {
      if (q.l - q.k + 1 <= rest) {
        for (int64_t l = q.k; l <= q.l; ++l) {
          Multi m; m.pos = l; m.gap = q.n_gapo + q.n_gape; m.mm = q.n_mm;
          m.strand = 0; m.ref_shift = q.n_del - q.n_ins;
          s.multi.push_back(m);
        }
        rest -= q.l - q.k + 1;
      } else {  // "we never come here" sampling branch (bwase.c:76-87)
        int64_t ii = q.l - q.k + 1;
        for (int64_t j = rest; j > 0; --j) {
          double p = 1.0, x = rng.drand48();
          while (x < p) { p -= p * j / ii; --ii; }
          Multi m; m.pos = q.l - ii; m.gap = q.n_gapo + q.n_gape;
          m.mm = q.n_mm; m.strand = 0; m.ref_shift = q.n_del - q.n_ins;
          s.multi.push_back(m);
        }
        rest = 0;
        break;
      }
    }
  }
}

static int approx_mapQ(const Seq &p, int mm) {
  if (p.c1 == 0) return 23;
  if (p.c1 > 1) return 0;
  if (p.n_mm == mm) return 25;
  if (p.c2 == 0) return 37;
  int n = p.c2 >= 255 ? 255 : p.c2;
  return 23 < g_log_n_tab[n] ? 0 : 23 - g_log_n_tab[n];
}

// pos2coord (bwa_sa2pos coordinate step, bwase.c:112-123)
static int64_t pos2coord(const Ref &r, int64_t pos_f, int64_t ref_len,
                         int *strand) {
  if (pos_f < r.l_pac && r.l_pac < pos_f + ref_len) { *strand = 0; return -1; }
  int is_rev = pos_f >= r.l_pac;
  if (is_rev) pos_f = (r.l_pac << 1) - 1 - pos_f;
  *strand = !is_rev;
  if (is_rev) pos_f = (pos_f + 1 < ref_len) ? 0 : pos_f - ref_len + 1;
  return pos_f;
}

static const int8_t REFINE_MAT[25] = {  // fill_scmat(1, 3)
    1, -3, -3, -3, -1,
    -3, 1, -3, -3, -1,
    -3, -3, 1, -3, -1,
    -3, -3, -3, 1, -1,
    -1, -1, -1, -1, -1};

// bwa_refine_gapped_core (bwase.c:169-199); returns false on failure
static bool refine_core(const Ref &r, int length, const uint8_t *seq,
                        int ref_shift, int64_t &rb,
                        std::vector<uint32_t> &cigar) {
  int64_t re = rb + length + ref_shift;
  if (re > r.l_pac) return false;  // spec asserts; never fires in samse
  int64_t rlen = re - rb;
  std::vector<uint8_t> rseq((size_t)rlen);
  for (int64_t k = rb; k < re; ++k) rseq[k - rb] = (uint8_t)pac_at(r, k);
  int w = (int)(std::llabs(rlen - length) * 1.5);
  int bw = w > 50 ? w : 50;
  int n_cig = 0;
  std::vector<uint32_t> cig((size_t)(length + rlen) + 8);
  bt_ksw_global2(length, seq, (int)rlen, rseq.data(), 5, REFINE_MAT, 5, 1, 5,
                 1, bw, &n_cig, cig.data(), (int)cig.size());
  cig.resize(n_cig);
  if (cig.empty()) return false;
  if ((cig.back() & 0xf) == 1) cig.back() = (cig.back() & ~0xfu) | 3;
  if ((cig.front() & 0xf) == 1) cig.front() = (cig.front() & ~0xfu) | 3;
  if (!cig.empty() && (cig.back() & 0xf) == 2) cig.pop_back();
  if (!cig.empty() && (cig.front() & 0xf) == 2) {
    rb += cig.front() >> 4;
    cig.erase(cig.begin());
  }
  cigar = std::move(cig);
  return true;
}

// bwa_cal_md1 (bwase.c:201-249)
static void cal_md1(const Ref &r, const std::vector<uint32_t> &cigar_in,
                    bool has_cigar, int length, int64_t pos,
                    const uint8_t *seq, std::string &md, int &nm) {
  static const char *B = "ACGTN";
  md.clear();
  nm = 0;
  int64_t x = pos;
  int y = 0, u = 0;
  char buf[32];
  std::vector<uint32_t> def;
  const std::vector<uint32_t> *cig = &cigar_in;
  if (!has_cigar || cigar_in.empty()) {
    def.push_back(((uint32_t)length << 4) | 0);
    cig = &def;
  }
  for (uint32_t cw : *cig) {
    int op = cw & 0xf;
    int ln = (int)(cw >> 4);
    if (op == 0) {  // M
      for (int z = 0; z < ln && x + z < r.l_pac; ++z) {
        int c = pac_at(r, x + z);
        if (c != seq[y + z] || seq[y + z] > 3) {
          snprintf(buf, sizeof buf, "%d", u);
          md += buf;
          md += B[c];
          ++nm;
          u = 0;
        } else ++u;
      }
      x += ln; y += ln;
    } else if (op == 1 || op == 3) {  // I or S
      y += ln;
      if (op == 1) nm += ln;
    } else if (op == 2) {  // D
      snprintf(buf, sizeof buf, "%d", u);
      md += buf;
      md += '^';
      for (int z = 0; z < ln && x + z < r.l_pac; ++z)
        md += B[pac_at(r, x + z)];
      u = 0;
      x += ln;
      nm += ln;
    }
  }
  snprintf(buf, sizeof buf, "%d", u);
  md += buf;
}

// bwa_correct_trimmed (bwase.c:251-285)
static void correct_trimmed(Seq &s) {
  if (s.len == s.full_len) return;
  uint32_t clip = (uint32_t)(s.full_len - s.len);
  if (!s.has_cigar) {
    s.cigar.clear();
    s.cigar.push_back(((uint32_t)s.len << 4) | 0);
    s.has_cigar = true;
  }
  if (s.strand == 0) {
    if (!s.cigar.empty() && (s.cigar.back() & 0xf) == 3)
      s.cigar.back() += clip << 4;
    else s.cigar.push_back((clip << 4) | 3);
  } else {
    if (!s.cigar.empty() && (s.cigar.front() & 0xf) == 3)
      s.cigar.front() += clip << 4;
    else s.cigar.insert(s.cigar.begin(), (clip << 4) | 3);
  }
  s.len = s.full_len;
}

static int64_t pos_end(const Seq &p) {
  if (p.has_cigar) {
    int64_t e = p.pos;
    for (uint32_t cw : p.cigar)
      if ((cw & 0xf) == 0 || (cw & 0xf) == 2) e += cw >> 4;
    return e;
  }
  return p.pos + p.len;
}

static int64_t pos_end_multi(const Multi &q, int length) {
  if (q.has_cigar) {
    int64_t e = q.pos;
    for (uint32_t cw : q.cigar)
      if ((cw & 0xf) == 0 || (cw & 0xf) == 2) e += cw >> 4;
    return e;
  }
  return q.pos + length;
}

static void put_int(std::string &o, int64_t v) {
  char buf[24];
  snprintf(buf, sizeof buf, "%lld", (long long)v);
  o += buf;
}

static void put_cigar(std::string &o, const std::vector<uint32_t> &cig) {
  static const char *OPS = "MIDS";
  for (uint32_t cw : cig) {
    put_int(o, cw >> 4);
    o += OPS[cw & 0xf];
  }
}

// bwa_print_seq (bwase.c:366-384)
static void put_seq(std::string &o, const Seq &p) {
  // bulk-write into the string (per-char += was 37% of samse CPU)
  static const char *F = "ACGTN", *R = "TGCAN";
  size_t at = o.size();
  o.resize(at + (size_t)p.full_len);
  char *d = &o[at];
  if (p.strand == 0) {
    for (int i = 0; i < p.full_len; ++i) {
      uint8_t c = p.codes[i];
      d[i] = F[c > 4 ? 4 : c];
    }
  } else {
    for (int i = 0; i < p.full_len; ++i) {
      uint8_t c = p.codes[p.full_len - 1 - i];
      d[i] = R[c > 4 ? 4 : c];
    }
  }
}

enum { F_PD = 1, F_PP = 2, F_SU = 4, F_MU = 8, F_SR = 16, F_MR = 32,
       F_R1 = 64, F_R2 = 128 };

static void put_qual(std::string &o, const Seq &p) {
  if (p.qual) {
    if (p.strand) {
      size_t at = o.size();
      o.resize(at + (size_t)p.qual_len);
      char *d = &o[at];
      for (int i = 0; i < p.len; ++i) d[i] = (char)p.qual[p.len - 1 - i];
      for (int i = p.len; i < p.qual_len; ++i) d[i] = (char)p.qual[i];
    } else {
      o.append((const char *)p.qual, p.qual_len);
    }
  } else o += '*';
}

// the 5'-end coordinate (bwase.c __pos_5 macro)
static int64_t pos_5(const Seq &p) { return p.strand ? pos_end(p) : p.pos; }

// bwa_print_sam1 (bwase.c:386-499); mate == nullptr for samse
static void print_sam1(const Ref &r, Seq &p, Seq *mate, int mode,
                       int max_top2, const char *rg_id, std::string &o) {
  if (p.type != T_NO_MATCH || (mate && mate->type != T_NO_MATCH)) {
    int flag = p.extra_flag;
    int64_t j;
    if (p.type == T_NO_MATCH) {
      p.pos = mate->pos;
      p.strand = mate->strand;
      flag |= F_SU;
      j = 1;
    } else {
      j = pos_end(p) - p.pos;
    }
    int nn = cnt_ambi(r, p.pos, j);
    int seqid = pos2rid(r, p.pos);
    if (p.type != T_NO_MATCH &&
        p.pos + j - r.ctg_off[seqid] > r.ctg_len[seqid])
      flag |= F_SU;
    if (p.strand) flag |= F_SR;
    if (mate) {
      if (mate->type != T_NO_MATCH) {
        if (mate->strand) flag |= F_MR;
      } else flag |= F_MU;
    }
    o += p.name; o += '\t'; put_int(o, flag); o += '\t';
    o += r.names + r.name_off[seqid]; o += '\t';
    put_int(o, p.pos - r.ctg_off[seqid] + 1); o += '\t';
    put_int(o, p.mapQ); o += '\t';
    if (p.has_cigar) put_cigar(o, p.cigar);
    else if (p.type == T_NO_MATCH) o += '*';
    else { put_int(o, p.len); o += 'M'; }
    int am = 0;
    if (mate && mate->type != T_NO_MATCH) {
      am = mate->seQ < p.seQ ? mate->seQ : p.seQ;
      int m_seqid = pos2rid(r, mate->pos);
      if (seqid == m_seqid) o += "\t=\t";
      else { o += '\t'; o += r.names + r.name_off[m_seqid]; o += '\t'; }
      int64_t isize = seqid == m_seqid ? pos_5(*mate) - pos_5(p) : 0;
      if (p.type == T_NO_MATCH) isize = 0;
      put_int(o, mate->pos - r.ctg_off[m_seqid] + 1); o += '\t';
      put_int(o, isize); o += '\t';
    } else if (mate) {
      o += "\t=\t";
      put_int(o, p.pos - r.ctg_off[seqid] + 1);
      o += "\t0\t";
    } else {
      o += "\t*\t0\t0\t";
    }
    put_seq(o, p);
    o += '\t';
    put_qual(o, p);
    if (rg_id && rg_id[0]) { o += "\tRG:Z:"; o += rg_id; }
    if (!p.bc.empty()) { o += "\tBC:Z:"; o += p.bc; }
    if (p.clip_len < p.full_len) { o += "\tXC:i:"; put_int(o, p.clip_len); }
    if (p.type != T_NO_MATCH) {
      char XT = "NURM"[p.type];
      if (nn > 10) XT = 'N';
      o += "\tXT:A:"; o += XT;
      o += (mode & 0x02) ? "\tNM:i:" : "\tCM:i:";  // BWA_MODE_COMPREAD
      put_int(o, p.nm);
      if (nn) { o += "\tXN:i:"; put_int(o, nn); }
      if (mate) {
        o += "\tSM:i:"; put_int(o, p.seQ);
        o += "\tAM:i:"; put_int(o, am);
      }
      if (p.type != T_MATESW) {
        o += "\tX0:i:"; put_int(o, p.c1);
        if (p.c1 <= max_top2) { o += "\tX1:i:"; put_int(o, p.c2); }
      }
      o += "\tXM:i:"; put_int(o, p.n_mm);
      o += "\tXO:i:"; put_int(o, p.n_gapo);
      o += "\tXG:i:"; put_int(o, p.n_gapo + p.n_gape);
      if (!p.md.empty()) { o += "\tMD:Z:"; o += p.md; }
      if (!p.multi.empty()) {
        o += "\tXA:Z:";
        for (const Multi &q : p.multi) {
          int sq = pos2rid(r, q.pos);
          o += r.names + r.name_off[sq];
          o += ',';
          o += q.strand ? '-' : '+';
          put_int(o, q.pos - r.ctg_off[sq] + 1);
          o += ',';
          if (q.has_cigar) put_cigar(o, q.cigar);
          else { put_int(o, p.len); o += 'M'; }
          o += ',';
          put_int(o, q.gap + q.mm);
          o += ';';
        }
      }
    }
    o += '\n';
  } else {
    int flag = p.extra_flag | F_SU;
    if (mate && mate->type == T_NO_MATCH) flag |= F_MU;
    o += p.name; o += '\t'; put_int(o, flag);
    o += "\t*\t0\t0\t*\t*\t0\t0\t";
    put_seq(o, p);
    o += '\t';
    put_qual(o, p);
    if (rg_id && rg_id[0]) { o += "\tRG:Z:"; o += rg_id; }
    if (!p.bc.empty()) { o += "\tBC:Z:"; o += p.bc; }
    if (p.clip_len < p.full_len) { o += "\tXC:i:"; put_int(o, p.clip_len); }
    o += '\n';
  }
}

// bwa_refine_gapped (bwase.c:287-331) + cal_md1 + correct_trimmed for a
// whole batch; is_comp = mode & BWA_MODE_COMPREAD (rseq complementing)
static void refine_batch(const Ref &r, std::vector<Seq> &seqs,
                         bool is_comp) {
  std::vector<uint8_t> fwd, rsq;
  for (Seq &s : seqs) {
    fwd.assign(s.codes, s.codes + s.len);
    rsq.resize(s.len);
    for (int k = 0; k < s.len; ++k) {
      uint8_t c = fwd[s.len - 1 - k];
      rsq[k] = (is_comp && c < 4) ? 3 - c : c;
    }
    std::vector<Multi> kept;
    for (Multi &q : s.multi) {
      if (q.gap) {
        int64_t rb = q.pos;
        std::vector<uint32_t> cig;
        if (refine_core(r, s.len, q.strand ? rsq.data() : fwd.data(),
                        q.ref_shift, rb, cig)) {
          q.cigar = std::move(cig);
          q.has_cigar = true;
          q.pos = rb;
          kept.push_back(q);
        }
      } else kept.push_back(q);
    }
    s.multi = std::move(kept);
    if (!(s.type == T_NO_MATCH || s.type == T_MATESW) && s.n_gapo) {
      int64_t rb = s.pos;
      std::vector<uint32_t> cig;
      if (refine_core(r, s.len, s.strand ? rsq.data() : fwd.data(),
                      s.ref_shift, rb, cig)) {
        s.cigar = std::move(cig);
        s.has_cigar = true;
        s.pos = rb;
      } else s.type = T_NO_MATCH;
    }
    if (s.type != T_NO_MATCH)
      cal_md1(r, s.cigar, s.has_cigar, s.len, s.pos,
              s.strand ? rsq.data() : fwd.data(), s.md, s.nm);
    correct_trimmed(s);
  }
}

// ---------------------------------------------------------------------
// sampe (bwape.c) — insert-size inference, pairing, SW mate rescue.
// aln/sampe.py is the executable spec; every numeric quirk below mirrors
// it (std accumulator starting at -1.0, +.499 inside a log, int
// truncations of double expressions).
// ---------------------------------------------------------------------

static const double M_SQRT1_2_ = 0.70710678118654752440;
static const double M_SQRT2_ = 1.41421356237309504880;
static const double OUTLIER_BOUND = 2.0;

// hash_64 (utils.h:98-109), the pair tie-break mix
static inline uint64_t hash64(uint64_t key) {
  key += ~(key << 32); key ^= key >> 22; key += ~(key << 13);
  key ^= key >> 8; key += key << 3; key ^= key >> 15;
  key += ~(key << 27); key ^= key >> 31;
  return key;
}

struct IsizeInfo {
  int64_t low = 0, high = 0, high_bayesian = 0;
  double avg = -1.0, std = -1.0, ap_prior = 0.0;
};

// infer_isize (bwape.c:81-154)
static IsizeInfo infer_isize(std::vector<Seq> &s0, std::vector<Seq> &s1,
                             double ap_prior, int64_t L, bool quiet) {
  IsizeInfo ii;
  std::vector<uint64_t> isizes;
  int max_len = 1;
  for (size_t i = 0; i < s0.size(); ++i) {
    Seq &p0 = s0[i], &p1 = s1[i];
    if (p0.mapQ >= 20 && p1.mapQ >= 20) {
      uint64_t x = p0.pos < p1.pos ? (uint64_t)(p1.pos + p1.len - p0.pos)
                                   : (uint64_t)(p0.pos + p0.len - p1.pos);
      if (x < 100000) isizes.push_back(x);
    }
    if (p0.len > max_len) max_len = p0.len;
    if (p1.len > max_len) max_len = p1.len;
  }
  int64_t tot = (int64_t)isizes.size();
  if (tot < 20) {
    if (!quiet)
      fprintf(stderr, "[infer_isize] fail to infer insert size: too few "
                      "good pairs\n");
    return ii;
  }
  std::sort(isizes.begin(), isizes.end());
  int64_t p25 = (int64_t)isizes[(size_t)((double)tot * 0.25 + 0.5)];
  int64_t p50 = (int64_t)isizes[(size_t)((double)tot * 0.50 + 0.5)];
  int64_t p75 = (int64_t)isizes[(size_t)((double)tot * 0.75 + 0.5)];
  (void)p50;
  int64_t tmp = (int64_t)(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499);
  ii.low = tmp > max_len ? tmp : max_len;
  ii.high = (int64_t)(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499);
  if (ii.low > ii.high) {
    if (!quiet)
      fprintf(stderr, "[infer_isize] fail to infer insert size: upper "
                      "bound is smaller than read length\n");
    ii.low = ii.high = 0;
    return ii;
  }
  int64_t n = 0;
  double sum = 0.0;
  for (uint64_t v : isizes)
    if ((int64_t)v >= ii.low && (int64_t)v <= ii.high) { sum += (double)v; ++n; }
  ii.avg = sum / (double)n;
  double std_acc = -1.0;  // bwape.c:87,124 — on purpose
  for (uint64_t v : isizes)
    if ((int64_t)v >= ii.low && (int64_t)v <= ii.high)
      std_acc += ((double)v - ii.avg) * ((double)v - ii.avg);
  ii.std = std::sqrt(std_acc / (double)n);
  double y = 1.0;
  while (y < 10.0) {
    if (0.5 * std::erfc(y / M_SQRT2_) <
        ap_prior / (double)L * (y * ii.std + ii.avg))
      break;
    y += 0.01;
  }
  ii.high_bayesian = (int64_t)(y * ii.std + ii.avg + 0.499);
  int64_t n_ap = 0;
  for (uint64_t v : isizes)
    if ((int64_t)v > ii.high_bayesian) ++n_ap;
  ii.ap_prior = 0.01 * ((double)n_ap + 0.01) / (double)tot;
  if (ii.ap_prior < ap_prior) ii.ap_prior = ap_prior;
  if (std::isnan(ii.std) || p75 > 100000) {
    ii.low = ii.high = ii.high_bayesian = 0;
    ii.avg = ii.std = -1.0;
    if (!quiet)
      fprintf(stderr, "[infer_isize] fail to infer insert size: weird "
                      "pairing\n");
    return ii;
  }
  y = 1.0;
  while (y < 10.0) {
    if (0.5 * std::erfc(y / M_SQRT2_) <
        ap_prior / (double)L * (y * ii.std + ii.avg))
      break;
    y += 0.01;
  }
  ii.high_bayesian = (int64_t)(y * ii.std + ii.avg + 0.499);
  if (!quiet)
    fprintf(stderr, "[infer_isize] inferred external isize from %lld "
            "pairs: %.3f +/- %.3f\n", (long long)n, ii.avg, ii.std);
  return ii;
}

struct PeOpt {
  int32_t max_isize, force_isize, max_occ, n_multi, N_multi, is_sw;
  double ap_prior;
};

// pairing (bwape.c:156-254): arr = (pos, info) with info =
// kidx<<2 | strand<<1 | end; returns cnt_chg (unused by the spec caller)
static int pairing(Seq *p[2], std::vector<std::pair<uint64_t, uint64_t>> &arr,
                   const PeOpt &popt, int s_mm, const IsizeInfo &ii,
                   const std::vector<Aln1> *alns[2]) {
  const uint64_t U64MAX = ~0ULL;
  int cnt_chg = 0;
  int max_len = p[0]->full_len > p[1]->full_len ? p[0]->full_len
                                                : p[1]->full_len;
  uint64_t o_score = U64MAX, subo_score = U64MAX;
  int o_n = 0, subo_n = 0;
  std::pair<uint64_t, uint64_t> o_pos[2];
  bool o_set = false;
  std::sort(arr.begin(), arr.end());
  // last_pos[end][slot]; .first == U64MAX means empty
  std::pair<uint64_t, uint64_t> last_pos[2][2] = {
      {{U64MAX, 0}, {U64MAX, 0}}, {{U64MAX, 0}, {U64MAX, 0}}};

  auto aux = [&](const std::pair<uint64_t, uint64_t> &u,
                 const std::pair<uint64_t, uint64_t> &v) {
    if (u.first == U64MAX) return;
    uint64_t l = v.first + (uint64_t)p[v.second & 1]->len - u.first;
    if (!(v.first > u.first && (int64_t)l >= max_len)) return;
    if (!((ii.high && (int64_t)l <= ii.high_bayesian) ||
          (ii.high == 0 && (int64_t)l <= popt.max_isize)))
      return;
    const Aln1 &r_v = (*alns[v.second & 1])[(size_t)(v.second >> 2)];
    const Aln1 &r_u = (*alns[u.second & 1])[(size_t)(u.second >> 2)];
    uint64_t s = (uint64_t)((r_v.score + r_u.score) * 10);
    if (ii.high)
      s += (uint64_t)(int64_t)(-4.343 * std::log(0.5 * std::erfc(
              M_SQRT1_2_ * std::fabs((double)l - ii.avg) / ii.std)) + 0.499);
    s = (s << 32) | (hash64((u.first << 32) | v.first) & 0xFFFFFFFFULL);
    if ((s >> 32) == (o_score >> 32)) ++o_n;
    else if ((s >> 32) < (o_score >> 32)) { subo_n += o_n; o_n = 1; }
    else ++subo_n;
    if (s < o_score) {
      subo_score = o_score;
      o_score = s;
      o_pos[u.second & 1] = u;
      o_pos[v.second & 1] = v;
      o_set = true;
    } else if (s < subo_score) {
      subo_score = s;
    }
  };

  for (const auto &x : arr) {
    int strand = (int)((x.second >> 1) & 1);
    if (strand == 1) {
      int y = 1 - (int)(x.second & 1);
      aux(last_pos[y][1], x);
      aux(last_pos[y][0], x);
    } else {
      last_pos[x.second & 1][0] = last_pos[x.second & 1][1];
      last_pos[x.second & 1][1] = x;
    }
  }

  if (o_score == U64MAX || !o_set) return 0;
  int mapQ_p = 0;
  if (o_n == 1) {
    if (subo_score == U64MAX) mapQ_p = 29;
    else if ((subo_score >> 32) - (o_score >> 32) > (uint64_t)(s_mm * 10))
      mapQ_p = 23;
    else {
      int n = subo_n < 255 ? subo_n : 255;
      mapQ_p = (int)(((subo_score >> 32) - (o_score >> 32)) / 2) -
               g_log_n_tab[n];
      if (mapQ_p < 0) mapQ_p = 0;
    }
  }
  bool same0 = (uint64_t)p[0]->pos == o_pos[0].first &&
               p[0]->strand == (int)((o_pos[0].second >> 1) & 1);
  bool same1 = (uint64_t)p[1]->pos == o_pos[1].first &&
               p[1]->strand == (int)((o_pos[1].second >> 1) & 1);
  if (same0 && same1) {
    if (p[0]->mapQ > 0 && p[1]->mapQ > 0) {
      int mq = p[0]->mapQ + p[1]->mapQ;
      if (mq > 60) mq = 60;
      p[0]->mapQ = p[1]->mapQ = mq;
    } else {
      if (p[0]->mapQ == 0)
        p[0]->mapQ = (mapQ_p + 7 < p[1]->mapQ) ? mapQ_p + 7 : p[1]->mapQ;
      if (p[1]->mapQ == 0)
        p[1]->mapQ = (mapQ_p + 7 < p[0]->mapQ) ? mapQ_p + 7 : p[0]->mapQ;
    }
  } else if (same0) {
    p[1]->seQ = 0;
    p[1]->mapQ = p[0]->mapQ < mapQ_p ? p[0]->mapQ : mapQ_p;
  } else if (same1) {
    p[0]->seQ = 0;
    p[0]->mapQ = p[1]->mapQ < mapQ_p ? p[1]->mapQ : mapQ_p;
  } else {
    p[0]->seQ = p[1]->seQ = 0;
    mapQ_p -= 20;
    if (mapQ_p < 0) mapQ_p = 0;
    p[0]->mapQ = p[1]->mapQ = mapQ_p;
  }

  for (int j = 0; j < 2; ++j) {
    const auto &w = o_pos[j];
    Seq *q = p[j];
    const Aln1 &rr = (*alns[w.second & 1])[(size_t)(w.second >> 2)];
    q->extra_flag |= F_PP;
    if ((uint64_t)q->pos != w.first ||
        q->strand != (int)((w.second >> 1) & 1)) {
      q->n_mm = rr.n_mm;
      q->n_gapo = rr.n_gapo;
      q->n_gape = rr.n_gape;
      q->strand = (int)((w.second >> 1) & 1);
      q->score = rr.score;
      q->pos = (int64_t)w.first;
      if (q->mapQ > 0) ++cnt_chg;
    }
  }
  return cnt_chg;
}

static const int SW_MIN_MATCH_LEN = 20;
static const int SW_MIN_MAPQ = 17;

// bwa_sw_core (bwape.c:409-494); returns true + fills (cigar, beg, cnt)
static bool sw_core(const Ref &r, int length, const uint8_t *seq,
                    int64_t &beg, int64_t reglen,
                    std::vector<uint32_t> &cigar, int &cnt) {
  if (reglen < SW_MIN_MATCH_LEN || r.l_pac - beg < length) return false;
  int n_amb = 0;
  for (int i = 0; i < length; ++i) n_amb += seq[i] >= 4;
  if ((double)n_amb / length >= 0.25 || length - n_amb < SW_MIN_MATCH_LEN)
    return false;
  int64_t end = beg + reglen < r.l_pac ? beg + reglen : r.l_pac;
  int64_t l = end - beg;
  std::vector<uint8_t> ref((size_t)l);
  for (int64_t k = beg; k < end; ++k) ref[k - beg] = (uint8_t)pac_at(r, k);
  int out[7];
  bt_ksw_align2(length, const_cast<uint8_t *>(seq), (int)l, ref.data(), 5,
                REFINE_MAT, 5, 1, 5, 1, length < 250 ? 1 : 0, 1, 1, 0, 0,
                out);
  int score = out[0], te = out[1], qe = out[2], score2 = out[3],
      tb = out[5], qb = out[6];
  int n_cig = 0;
  std::vector<uint32_t> cig((size_t)(qe + 1 - qb + te + 1 - tb) + 8);
  int gscore = bt_ksw_global2(qe + 1 - qb, seq + qb, te + 1 - tb,
                              ref.data() + tb, 5, REFINE_MAT, 5, 1, 5, 1, 50,
                              &n_cig, cig.data(), (int)cig.size());
  cig.resize((size_t)n_cig);
  if (score < SW_MIN_MATCH_LEN || score2 == score || gscore != score)
    return false;
  int64_t x = 0, y = 0;
  for (uint32_t cw : cig) {
    int op = cw & 0xf, ln = (int)(cw >> 4);
    if (op == 0 || op == 2) x += ln;
    if (op == 0 || op == 1) y += ln;
  }
  if (x < SW_MIN_MATCH_LEN || y < SW_MIN_MATCH_LEN) return false;
  int start = qb, endq = qe + 1;
  beg += tb;
  std::vector<uint32_t> full;
  if (start) full.push_back(((uint32_t)start << 4) | 3);
  full.insert(full.end(), cig.begin(), cig.end());
  if (endq < length)
    full.push_back(((uint32_t)(length - endq) << 4) | 3);
  // recount from the final cigar (bwape.c:473-490)
  int n_mm = 0, n_gapo = 0, n_gape = 0;
  int64_t xx = tb;
  int yy = qb;
  for (uint32_t cw : full) {
    int op = cw & 0xf, ln = (int)(cw >> 4);
    if (op == 0) {
      for (int t = 0; t < ln; ++t)
        if (ref[xx + t] < 4 && seq[yy + t] < 4 && ref[xx + t] != seq[yy + t])
          ++n_mm;
      xx += ln;
      yy += ln;
    } else if (op == 2) {
      xx += ln;
      ++n_gapo;
      n_gape += ln - 1;
    } else if (op == 1) {
      yy += ln;
      ++n_gapo;
      n_gape += ln - 1;
    }
  }
  cnt = (n_mm << 16) | (n_gapo << 8) | n_gape;
  cigar = std::move(full);
  return true;
}

// bwa_paired_sw (bwape.c:496-622)
static void paired_sw(const Ref &r, std::vector<Seq> &s0,
                      std::vector<Seq> &s1, const PeOpt &popt,
                      const IsizeInfo &ii, bool is_comp0, bool is_comp1) {
  if (!popt.is_sw || ii.avg < 0.0) return;
  for (size_t i = 0; i < s0.size(); ++i) {
    Seq *p[2] = {&s0[i], &s1[i]};
    bool comp[2] = {is_comp0, is_comp1};
    if (!((p[0]->mapQ >= SW_MIN_MAPQ || p[1]->mapQ >= SW_MIN_MAPQ) &&
          (p[0]->extra_flag & F_PP) == 0))
      continue;
    int64_t beg[2] = {0, 0}, end[2] = {0, 0};
    std::vector<uint32_t> cigar[2];
    bool has_cig[2] = {false, false};
    int cnt[2] = {0, 0};
    int mq_adjust[2] = {255, 255};
    std::vector<uint8_t> sbuf;
    for (int k = 0; k < 2; ++k) {
      const Seq *ref_r = p[1 - k];
      if (ref_r->type == T_NO_MATCH) continue;
      sbuf.resize((size_t)p[k]->len);
      if (ref_r->strand == 0) {
        int64_t a = (int64_t)(ref_r->pos + ii.avg - 3.0 * ii.std -
                              (double)p[k]->len * 1.5);
        int64_t b = (int64_t)((double)a + 6.0 * ii.std +
                              2.0 * (double)p[k]->len);
        if (a < ref_r->pos + ref_r->len) a = ref_r->pos + ref_r->len;
        if (b > r.l_pac) b = r.l_pac;
        // rseq: reverse(complement per is_comp) of the trimmed read
        for (int t = 0; t < p[k]->len; ++t) {
          uint8_t c = p[k]->codes[p[k]->len - 1 - t];
          sbuf[t] = (comp[k] && c < 4) ? 3 - c : c;
        }
        beg[k] = a;
        end[k] = b;
      } else {
        int64_t a = (int64_t)(ref_r->pos + ref_r->len - ii.avg -
                              3.0 * ii.std - (double)p[k]->len * 0.5);
        int64_t b = (int64_t)((double)a + 6.0 * ii.std +
                              2.0 * (double)p[k]->len);
        if (a < 0) a = 0;
        if (b > ref_r->pos) b = ref_r->pos;
        // seq_reverse(p->seq, False) == the original-orientation codes
        for (int t = 0; t < p[k]->len; ++t) sbuf[t] = p[k]->codes[t];
        beg[k] = a;
        end[k] = b;
      }
      std::vector<uint32_t> cg;
      int c = 0;
      if (sw_core(r, p[k]->len, sbuf.data(), beg[k], end[k] - beg[k], cg,
                  c)) {
        cigar[k] = std::move(cg);
        has_cig[k] = true;
        cnt[k] = c;
      }
      if (has_cig[k] && p[k]->type != T_NO_MATCH) {
        int clip = 0;
        if ((cigar[k].front() & 0xf) == 3) clip += cigar[k].front() >> 4;
        if ((cigar[k].back() & 0xf) == 3) clip += cigar[k].back() >> 4;
        int s_old = (int)((p[k]->n_mm * 9 + p[k]->n_gapo * 13 +
                           p[k]->n_gape * 2) / 3.0 * 8.0 + 0.499);
        int cc = cnt[k];
        int s_new = (int)(((cc >> 16) * 9 + ((cc >> 8) & 0xFF) * 13 +
                           (cc & 0xFF) * 2 + clip * 3) / 3.0 * 8.0 + 0.499);
        s_old = (int)((double)s_old +
                      (-4.343 * std::log(ii.ap_prior / (double)r.l_pac)));
        // the reference computes log(.5*erfc(1.5/sqrt2) + .499)
        s_new = s_new + (int)(-4.343 * std::log(
                    0.5 * std::erfc(M_SQRT1_2_ * 1.5) + 0.499));
        if (s_old < s_new) {
          mq_adjust[k] = s_new - s_old;
          has_cig[k] = false;
          cigar[k].clear();
        } else {
          mq_adjust[k] = s_old - s_new;
        }
      }
    }
    int k = -1, mapQ = 0;
    if (has_cig[0] && has_cig[1]) {
      k = p[0]->mapQ < p[1]->mapQ ? 0 : 1;
      mapQ = p[1]->mapQ - p[0]->mapQ;
      if (mapQ < 0) mapQ = -mapQ;
    } else if (has_cig[0]) {
      k = 0;
      mapQ = p[1]->mapQ;
    } else if (has_cig[1]) {
      k = 1;
      mapQ = p[0]->mapQ;
    }
    if (k >= 0 && p[k]->pos != beg[k]) {
      int tmp = p[1 - k]->mapQ - p[k]->mapQ / 2 - 8;
      if (tmp <= 0) tmp = 1;
      if (mapQ > tmp) mapQ = tmp;
      p[k]->mapQ = p[1 - k]->mapQ = mapQ;
      p[k]->seQ = p[1 - k]->seQ =
          p[1 - k]->seQ < mapQ ? p[1 - k]->seQ : mapQ;
      if (p[k]->mapQ > mq_adjust[k]) p[k]->mapQ = mq_adjust[k];
      if (p[k]->seQ > mq_adjust[k]) p[k]->seQ = mq_adjust[k];
      p[k]->cigar = std::move(cigar[k]);
      p[k]->has_cigar = true;
      // __set_fixed (bwape.c:539-547)
      p[k]->type = T_MATESW;
      p[k]->pos = beg[k];
      p[k]->seQ = p[1 - k]->seQ;
      p[k]->strand = 1 - p[1 - k]->strand;
      int cc = cnt[k];
      p[k]->n_mm = cc >> 16;
      p[k]->n_gapo = (cc >> 8) & 0xFF;
      p[k]->n_gape = cc & 0xFF;
      p[k]->extra_flag |= F_PP;
      p[1 - k]->extra_flag |= F_PP;
    }
  }
}

// .sai-record parse + read-array attach for one batch of one end;
// returns consumed byte count or -1 on truncation.  Does NOT run
// aln2seq (samse and sampe consume the rng in different orders).
static int64_t attach_reads(std::vector<Seq> &seqs, int n_reads,
                            const uint8_t *codes_flat,
                            const int64_t *codes_off,
                            const int32_t *len_arr,
                            const int32_t *full_len_arr,
                            const int32_t *clip_len_arr,
                            const uint8_t *qual_flat, const int64_t *qual_off,
                            const char *rnames, const int64_t *rname_off,
                            const char *bc_blob, const int32_t *bc_off,
                            const uint8_t *sai_bytes, int64_t sai_len) {
  const uint8_t *sp = sai_bytes;
  const uint8_t *sp_end = sai_bytes + sai_len;
  seqs.resize((size_t)n_reads);
  for (int i = 0; i < n_reads; ++i) {
    Seq &s = seqs[i];
    s.codes = codes_flat + codes_off[i];
    s.name = rnames + rname_off[i];
    s.qual = qual_off ? qual_flat + qual_off[i] : nullptr;
    s.qual_len = qual_off ? (int)(qual_off[i + 1] - qual_off[i]) : 0;
    if (bc_blob) s.bc = bc_blob + bc_off[i];
    s.len = len_arr[i];
    s.full_len = full_len_arr[i];
    s.clip_len = clip_len_arr[i];
    if (sp + 4 > sp_end) return -1;
    int32_t n_aln;
    std::memcpy(&n_aln, sp, 4);
    sp += 4;
    if (sp + (int64_t)n_aln * 24 > sp_end) return -1;
    s.alns.resize(n_aln);
    for (int a = 0; a < n_aln; ++a) {
      uint64_t w0, k, l;
      std::memcpy(&w0, sp, 8);
      std::memcpy(&k, sp + 8, 8);
      std::memcpy(&l, sp + 16, 8);
      sp += 24;
      Aln1 &A = s.alns[a];
      A.n_mm = (int)(w0 & 0xFF);
      A.n_gapo = (int)((w0 >> 8) & 0xFF);
      A.n_gape = (int)((w0 >> 16) & 0xFF);
      A.score = (int)((w0 >> 24) & 0xFFFFF);
      A.n_ins = (int)((w0 >> 44) & 0x3FF);
      A.n_del = (int)((w0 >> 54) & 0x3FF);
      A.k = (int64_t)k;
      A.l = (int64_t)l;
    }
  }
  return sp - sai_bytes;
}

}  // namespace btsam

extern "C" {

// Returns bytes written to out_buf, or -needed when out_cap is too small
// (caller must restore *rng_state from its snapshot and retry).
// sai_bytes points at this batch's first record; *sai_used gets the
// consumed byte count.
int64_t bt_samse_batch(
    const uint8_t *occ_inter, int64_t seq_len,
    int64_t primary, const int64_t *L2, const int64_t *ssa, int32_t sa_intv,
    const uint8_t *pac, int64_t l_pac, const int64_t *ctg_off,
    const int32_t *ctg_len, const int32_t *name_off, const char *names,
    int32_t n_ctg, const int64_t *amb_off, const int32_t *amb_len,
    int32_t n_amb, int32_t n_reads, const uint8_t *codes_flat,
    const int64_t *codes_off, const int32_t *len_arr,
    const int32_t *full_len_arr, const int32_t *clip_len_arr,
    const uint8_t *qual_flat, const int64_t *qual_off,
    const char *rnames, const int64_t *rname_off, const char *bc_blob,
    const int32_t *bc_off, const uint8_t *sai_bytes, int64_t sai_len,
    int32_t mode, int32_t max_top2, int32_t n_multi, int32_t max_diff_opt,
    double fnr, const char *rg_id, uint64_t *rng_state, char *out_buf,
    int64_t out_cap, int64_t *sai_used, const void *sad,
    int32_t sad_is64) {
  using namespace btsam;
  init_log_n();
  FM g{{occ_inter, seq_len, primary, L2}, ssa, sa_intv, sad,
       sad_is64 != 0};
  Ref r{pac, l_pac, ctg_off, ctg_len, name_off, names,
        n_ctg, amb_off, amb_len, n_amb};
  Rand48 rng{*rng_state};
  bool is_comp = (mode & 0x02) != 0;  // BWA_MODE_COMPREAD

  std::vector<Seq> seqs;
  int64_t used = attach_reads(seqs, n_reads, codes_flat, codes_off, len_arr,
                              full_len_arr, clip_len_arr, qual_flat, qual_off,
                              rnames, rname_off, bc_blob, bc_off, sai_bytes,
                              sai_len);
  if (used < 0) return -1;
  for (int i = 0; i < n_reads; ++i) aln2seq_core(seqs[i], rng, n_multi);
  *sai_used = used;

  // cal_pac_pos (bwase.c:131-165 / samse.py cal_pac_pos)
  for (int i = 0; i < n_reads; ++i) {
    Seq &p = seqs[i];
    if (p.type == T_UNIQUE || p.type == T_REPEAT) {
      int max_diff = fnr > 0.0 ? cal_maxdiff(p.len, 0.02, fnr) : max_diff_opt;
      p.seQ = p.mapQ = approx_mapQ(p, max_diff);
      int strand;
      p.pos = pos2coord(r, sa_value(g, p.sa), p.len + p.ref_shift, &strand);
      p.strand = strand;
      p.seQ = p.mapQ = approx_mapQ(p, max_diff);
      if (p.pos == -1) p.type = T_NO_MATCH;
    }
    std::vector<Multi> kept;
    for (Multi &q : p.multi) {
      int strand;
      q.pos = pos2coord(r, sa_value(g, q.pos), p.len + q.ref_shift, &strand);
      q.strand = strand;
      if (q.pos != p.pos && q.pos != -1) kept.push_back(q);
    }
    p.multi = std::move(kept);
  }

  // refine_gapped (bwase.c:287-331)
  refine_batch(r, seqs, is_comp);

  // SAM text
  std::string out;
  out.reserve((size_t)n_reads * 256);
  for (int i = 0; i < n_reads; ++i)
    print_sam1(r, seqs[i], nullptr, mode, max_top2, rg_id, out);
  if ((int64_t)out.size() > out_cap) return -(int64_t)out.size();
  std::memcpy(out_buf, out.data(), out.size());
  *rng_state = rng.x;
  return (int64_t)out.size();
}

// Finalize one sampe batch (bwa_sai2sam_pe_core, bwape.c:624-731): SE
// phase per end, insert-size inference, pairing, multi re-generation, SW
// mate rescue, gapped refinement and paired SAM text.  aln/sampe.py is
// the byte-exact executable spec.  ii_state[6] carries last_ii across
// batches (low, high, high_bayesian, avg, std, ap_prior) and receives
// this batch's inferred values; returns bytes written or -needed.
int64_t bt_sampe_batch(
    const uint8_t *occ_inter, int64_t seq_len,
    int64_t primary, const int64_t *L2, const int64_t *ssa, int32_t sa_intv,
    const uint8_t *pac, int64_t l_pac, const int64_t *ctg_off,
    const int32_t *ctg_len, const int32_t *name_off, const char *names,
    int32_t n_ctg, const int64_t *amb_off, const int32_t *amb_len,
    int32_t n_amb, int32_t n_pairs,
    const uint8_t *codes_flat0, const int64_t *codes_off0,
    const int32_t *len0, const int32_t *full_len0, const int32_t *clip_len0,
    const uint8_t *qual_flat0, const int64_t *qual_off0,
    const char *rnames0, const int64_t *rname_off0, const char *bc_blob0,
    const int32_t *bc_off0,
    const uint8_t *codes_flat1, const int64_t *codes_off1,
    const int32_t *len1, const int32_t *full_len1, const int32_t *clip_len1,
    const uint8_t *qual_flat1, const int64_t *qual_off1,
    const char *rnames1, const int64_t *rname_off1, const char *bc_blob1,
    const int32_t *bc_off1,
    const uint8_t *sai0, int64_t sai0_len,
    const uint8_t *sai1, int64_t sai1_len,
    int32_t mode0, int32_t mode1, int32_t max_top2, int32_t s_mm,
    int32_t max_diff_opt, double fnr,
    int32_t max_isize, int32_t force_isize, int32_t max_occ,
    int32_t n_multi, int32_t N_multi, int32_t is_sw, double ap_prior,
    int32_t quiet, double *ii_state, const char *rg_id, uint64_t *rng_state,
    char *out_buf, int64_t out_cap, int64_t *sai_used, const void *sad,
    int32_t sad_is64) {
  using namespace btsam;
  init_log_n();
  FM g{{occ_inter, seq_len, primary, L2}, ssa, sa_intv, sad,
       sad_is64 != 0};
  Ref r{pac, l_pac, ctg_off, ctg_len, name_off, names,
        n_ctg, amb_off, amb_len, n_amb};
  Rand48 rng{*rng_state};
  PeOpt popt{max_isize, force_isize, max_occ, n_multi, N_multi, is_sw,
             ap_prior};

  std::vector<Seq> s0, s1;
  int64_t u0 = attach_reads(s0, n_pairs, codes_flat0, codes_off0, len0,
                            full_len0, clip_len0, qual_flat0, qual_off0,
                            rnames0, rname_off0, bc_blob0, bc_off0, sai0,
                            sai0_len);
  if (u0 < 0) return -1;
  int64_t u1 = attach_reads(s1, n_pairs, codes_flat1, codes_off1, len1,
                            full_len1, clip_len1, qual_flat1, qual_off1,
                            rnames1, rname_off1, bc_blob1, bc_off1, sai1,
                            sai1_len);
  if (u1 < 0) return -1;
  sai_used[0] = u0;
  sai_used[1] = u1;

  // SE phase (bwape.c:279-303): PAIR-interleaved — the shared drand48
  // stream advances end0 then end1 per pair
  for (int i = 0; i < n_pairs; ++i) {
    for (int j = 0; j < 2; ++j) {
      Seq &p = j == 0 ? s0[i] : s1[i];
      p.extra_flag |= F_PD | (j == 0 ? F_R1 : F_R2);
      aln2seq_core(p, rng, 0);
      if (p.type == T_UNIQUE || p.type == T_REPEAT) {
        int max_diff =
            fnr > 0.0 ? cal_maxdiff(p.len, 0.02, fnr) : max_diff_opt;
        p.seQ = p.mapQ = approx_mapQ(p, max_diff);
        int strand;
        p.pos = pos2coord(r, sa_value(g, p.sa), p.len + p.ref_shift,
                          &strand);
        p.strand = strand;
        if (p.pos == -1) p.type = T_NO_MATCH;
      }
    }
  }

  IsizeInfo last_ii;
  last_ii.low = (int64_t)ii_state[0];
  last_ii.high = (int64_t)ii_state[1];
  last_ii.high_bayesian = (int64_t)ii_state[2];
  last_ii.avg = ii_state[3];
  last_ii.std = ii_state[4];
  last_ii.ap_prior = ii_state[5];
  IsizeInfo ii = infer_isize(s0, s1, ap_prior, seq_len / 2, quiet != 0);
  if (ii.avg < 0.0 && last_ii.avg > 0.0) ii = last_ii;
  if (force_isize) {
    if (!quiet)
      fprintf(stderr, "[sampe_core] discard insert size estimate as "
                      "user's request.\n");
    ii.low = ii.high = 0;
    ii.avg = ii.std = -1.0;
  }

  // PE phase (bwape.c:314-389)
  for (int i = 0; i < n_pairs; ++i) {
    Seq *p[2] = {&s0[i], &s1[i]};
    const std::vector<Aln1> *alns[2] = {&s0[i].alns, &s1[i].alns};
    if ((p[0]->type == T_UNIQUE || p[0]->type == T_REPEAT) &&
        (p[1]->type == T_UNIQUE || p[1]->type == T_REPEAT)) {
      int64_t n_occ[2] = {0, 0};
      for (int j = 0; j < 2; ++j)
        for (const Aln1 &q : *alns[j]) n_occ[j] += q.l - q.k + 1;
      if (!(n_occ[0] > max_occ || n_occ[1] > max_occ)) {
        std::vector<std::pair<uint64_t, uint64_t>> arr;
        arr.reserve((size_t)(n_occ[0] + n_occ[1]));
        for (int j = 0; j < 2; ++j) {
          for (size_t kidx = 0; kidx < alns[j]->size(); ++kidx) {
            const Aln1 &q = (*alns[j])[kidx];
            for (int64_t l = q.k; l <= q.l; ++l) {
              int strand;
              int64_t pos = pos2coord(r, sa_value(g, l),
                                      p[j]->len + p[j]->ref_shift, &strand);
              uint64_t key = pos == -1 ? ~0ULL : (uint64_t)pos;
              arr.emplace_back(key, ((uint64_t)kidx << 2) |
                                        ((uint64_t)strand << 1) |
                                        (uint64_t)j);
            }
          }
        }
        pairing(p, arr, popt, s_mm, ii, alns);
      }
    }

    if (N_multi || n_multi) {
      for (int j = 0; j < 2; ++j) {
        if (p[j]->type != T_NO_MATCH) {
          if (!(p[j]->extra_flag & F_PP) && p[1 - j]->type != T_NO_MATCH) {
            int nm = (p[j]->c1 + p[j]->c2 - 1 > N_multi) ? n_multi : N_multi;
            aln2seq_core(*p[j], rng, nm, false);
          } else {
            aln2seq_core(*p[j], rng, n_multi, false);
          }
          std::vector<Multi> kept;
          for (Multi &q : p[j]->multi) {
            int strand;
            q.pos = pos2coord(r, sa_value(g, q.pos),
                              p[j]->len + q.ref_shift, &strand);
            q.strand = strand;
            if (q.pos != p[j]->pos && q.pos != -1) kept.push_back(q);
          }
          p[j]->multi = std::move(kept);
        }
      }
    }
  }

  paired_sw(r, s0, s1, popt, ii, (mode0 & 0x02) != 0, (mode1 & 0x02) != 0);
  refine_batch(r, s0, (mode0 & 0x02) != 0);
  refine_batch(r, s1, (mode1 & 0x02) != 0);

  std::string out;
  out.reserve((size_t)n_pairs * 512);
  for (int i = 0; i < n_pairs; ++i) {
    Seq &p0 = s0[i], &p1 = s1[i];
    if (!p0.bc.empty() || !p1.bc.empty()) {
      p0.bc += p1.bc;
      p1.bc = p0.bc;
    }
    print_sam1(r, p0, &p1, mode1, max_top2, rg_id, out);
    print_sam1(r, p1, &p0, mode1, max_top2, rg_id, out);
    if (std::strcmp(p0.name, p1.name) != 0) return -2;
  }
  if ((int64_t)out.size() > out_cap) return -(int64_t)out.size();
  ii_state[0] = (double)ii.low;
  ii_state[1] = (double)ii.high;
  ii_state[2] = (double)ii.high_bayesian;
  ii_state[3] = ii.avg;
  ii_state[4] = ii.std;
  ii_state[5] = ii.ap_prior;
  std::memcpy(out_buf, out.data(), out.size());
  *rng_state = rng.x;
  return (int64_t)out.size();
}

}  // extern "C"
