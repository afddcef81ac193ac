// Kernels K7 and K7w: the bwa aln backtrack search, a thread per lane.
//
// K7 (bwa_gap_machine) replaces the JAX package's XLA while_loop
// bwa_tpu/ops/gap_machine.py::gap_machine: each lane runs one read's
// best-first bounded-difference search (bwt_match_gap, bwtgap.c:109-264) to
// its own end.  K7w (bwa_cal_width) replaces its lax.scan cal_width_device:
// the per-position (w, bid) lower bounds of bwt_cal_width (bwtaln.c:57-81).
// Their plain versions are bwa_tpu_torch/ops/gap_machine.py::
// gap_machine_plain and cal_width_plain; per lane, aln_m, aln_kl, n_aln,
// n_stk, ovf, done_step, n_occ and the longest lane's steps (K7) and the
// width table (K7w) are equal bit for bit.
//
// What bounds it on an H100: neither bytes nor operations but the longest
// lane's chain of dependent steps.  Every step pops the stack's least key,
// and the expansion it makes needs two occ4 lookups in the fused occtab at
// positions that the popped entry holds; the occtab of a 4.6 Mbp genome is
// 1.5 MB and stays in the 50 MB L2.  So a launch costs the longest lane's
// steps times (the pop's few dependent scratch loads + one L2 round trip
// for the occ4 pair + the arithmetic).  The
// XLA loop paid every step for all lanes at the slowest lane's pace; here
// each lane runs to its own end and the launch ends with its longest lane.
// The design:
//  1. A thread per lane, 128 lanes a block, at most 128 registers so that
//     four blocks fit an SM (65,536 lanes in one wave); the lane's scalar
//     state lives in registers and the machine's phase is a branch.
//  2. The stack is the reference's own gap_stack_t (bwtgap.c:17-84): one
//     LIFO list a score, the pop taking the head of the lowest non-empty
//     list.  The plain version's key (score << 18 | (2^18 - 1 - seqno),
//     seqno strictly increasing) is unique within a running lane, and its
//     least key is exactly that entry, so the pop order is the plain
//     version's at O(1) a pop, where a scan for the least key would cost
//     a step as many loads as the stack holds entries (hundreds to
//     thousands on 100 bp reads).  Entries live in a pool of `cap` slots (a
//     free list of popped slots, then a high-water mark) linked into the
//     score lists; n_stk and every overflow test (n_push > cap - n_stk)
//     equal the plain version's counts over a key array of `cap` slots.
//     A score is at most (md+1)*s_mm + mg*s_gapo + max_gape*s_gape (a
//     child adds one mismatch only to a parent with m >= 0, one gap open
//     only below mg, one extension only below max_gape), so the wrapper
//     sizes nb lists from the options; a score past them would flag ovf
//     (it cannot happen: the card tests hold ovf to the plain version).
//     All of it is global scratch the wrapper allocates, a lane's lists
//     and slots contiguous.  A slot is one record of 16-byte vectors
//     (fields, k, l and the list link: 48 bytes, 64 with int64
//     coordinates), read and written whole: the launch is bound by the
//     memory operations of its lanes (25 million lane steps at 65,536
//     lanes), and a push is three or four vector stores where a plane a
//     field would make it twelve scattered ones.
//  3. occ4 is per thread: the row's four counts, then popcounts over the
//     text words up to the one that holds k (R = 1: 8 words a row, R = 4:
//     32), four words a 16-byte load, as bwt_occ4 (bwt.c:169-186) on the
//     fused table.
//  4. The width table (rewritten by gap_shadow after each added hit) is the
//     lane's own copy in global memory; hits go straight to the outputs.
//  5. Templated on the coordinate type (int32 when 2*l_pac+2 < 2^31, else
//     int64) and on the search flags (GAPE, NONSTOP, LOGGAP) and use_seed.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (bwa_tpu_torch/ops/cuda_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P_RUN = 0, P_WALK = 1, P_DONE = 2;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2;
constexpr int32_t SENT = 0x7FFFFFFF;
constexpr int SEQ_BITS = 18;
constexpr int32_t SEQ_CAP = 1 << SEQ_BITS;
constexpr int32_t SCORE_CAP = (SENT >> SEQ_BITS) - 1;
constexpr uint32_t M55 = 0x55555555u;
constexpr int NF = 8;
enum { F_I, F_MM, F_GO, F_GE, F_INS, F_DEL, F_ST, F_LDP };
constexpr int THREADS = 128;  // lanes a block

template <typename C>
struct Fm {
  const uint32_t *occtab;  // [n_rows, 4 + nw] counts || text words
  int nw, rb;              // words a row (8R), log2(R)
  const int64_t *L2;       // [5]
  C primary, seq_len;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// v[c] for a c known only at run time, by selects (no local memory)
template <typename C>
__device__ __forceinline__ C pick(const C v[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

// bwt_occ4 (bwt.c:169-186): counts of each base in B[0..k]; k == -1 gives
// zeros, k == seq_len the L2 differences.
template <typename C>
__device__ __forceinline__ void occ4(const Fm<C> &f, const C L2[5], C k,
                                     C o[4]) {
  if (k == -1) {
    o[0] = o[1] = o[2] = o[3] = 0;
    return;
  }
  if (k == f.seq_len) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = L2[c + 1] - L2[c];
    return;
  }
  C kk = k - (k >= f.primary ? 1 : 0);
  kk = kk < 0 ? 0 : (kk > f.seq_len - 1 ? f.seq_len - 1 : kk);
  // rows of 4 + 8R words, 16-byte aligned: the counts, then the words up
  // to the one that holds kk, four a load
  const uint4 *row = reinterpret_cast<const uint4 *>(
      f.occtab + (size_t)(kk >> (7 + f.rb)) * (4 + f.nw));
  const int kw = (int)(kk >> 4) & (f.nw - 1), kb = (int)(kk & 15);
  int n1 = 0, n2 = 0, n3 = 0;
  for (int u = 0; u <= kw >> 2; ++u) {
    const uint4 w4 = __ldg(row + 1 + u);
    const uint32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nkeep = (kw - (4 * u + j)) * 16 + kb + 1;
      const uint32_t keep = nkeep <= 0    ? 0u
                            : nkeep >= 16 ? 0xffffffffu
                                          : 0xffffffffu << ((16 - nkeep) << 1);
      const uint32_t w = ws[j] & keep;
      const uint32_t hi = (w >> 1) & M55, lo = w & M55;
      const int c3 = __popc(hi & lo);
      n1 += __popc(lo) - c3;
      n2 += __popc(hi) - c3;
      n3 += c3;
    }
  }
  const uint4 cnt = __ldg(row);
  o[0] = (C)cnt.x + (C)(kw * 16 + kb + 1 - n1 - n2 - n3);
  o[1] = (C)cnt.y + (C)n1;
  o[2] = (C)cnt.z + (C)n2;
  o[3] = (C)cnt.w + (C)n3;
}

template <typename C>
__device__ __forceinline__ void load_L2(const Fm<C> &f, C L2[5]) {
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = (C)f.L2[c];
}

// ---------------------------------------------------------------- K7w

template <typename C>
__global__ void __launch_bounds__(THREADS)
    cal_width_kernel(Fm<C> f, const uint8_t *q, int B, int L, C *out) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  C L2[5];
  load_L2(f, L2);
  q += (size_t)b * L;
  out += (size_t)b * L * 2;
  C k = 0, l = f.seq_len, bid = 0;
  for (int t = 0; t < L; ++t) {
    const int c = q[t];
    C k2 = k, l2 = l;
    const bool good = c < 4;
    if (good) {
      C ok[4], ol[4];
      occ4(f, L2, k - 1, ok);
      occ4(f, L2, l, ol);
      const C l2c = pick(L2, c);
      k2 = l2c + pick(ok, c) + 1;
      l2 = l2c + pick(ol, c);
    }
    const bool reset = k2 > l2 || !good;
    bid += reset ? 1 : 0;
    k = reset ? 0 : k2;
    l = reset ? f.seq_len : l2;
    out[2 * t] = l - k + 1;
    out[2 * t + 1] = bid;
  }
}

// ---------------------------------------------------------------- K7

// A stack entry: one record of 16-byte vectors (48 bytes with int32
// coordinates, 64 with int64), read and written whole.
template <typename C>
struct __align__(16) Entry {
  int32_t f[NF];  // i, mm, go, ge, ins, del, st, ldp
  C k, l;
  int32_t nxt;    // the next slot of its score list, or of the free list
};
static_assert(sizeof(Entry<int32_t>) == 48 && sizeof(Entry<int64_t>) == 64,
              "ops/gap_machine.py allocates 12 or 16 words a slot");

template <typename C>
union EntryVecs {
  Entry<C> e;
  uint4 v[sizeof(Entry<C>) / 16];
};

template <typename C>
__device__ __forceinline__ Entry<C> load_entry(const Entry<C> *p) {
  EntryVecs<C> u;
  const uint4 *src = reinterpret_cast<const uint4 *>(p);
#pragma unroll
  for (int j = 0; j < (int)(sizeof(Entry<C>) / 16); ++j) u.v[j] = src[j];
  return u.e;
}

template <typename C>
__device__ __forceinline__ void store_entry(Entry<C> *p, const Entry<C> &e) {
  EntryVecs<C> u;
  u.e = e;
  uint4 *dst = reinterpret_cast<uint4 *>(p);
#pragma unroll
  for (int j = 0; j < (int)(sizeof(Entry<C>) / 16); ++j) dst[j] = u.v[j];
}

template <typename C>
struct GapArgs {
  Fm<C> f;
  const uint8_t *q;  // [B, L] complemented read codes
  int B, L;
  const int32_t *qlen, *md, *mg;
  const uint8_t *seed_en, *active;
  const C *sb;  // [B, SL, 2] seed-region widths
  int SL;
  C *wb;  // [B, L, 2] widths, rewritten by gap_shadow
  int s_mm, s_gapo, s_gape, max_gape, max_seed_diff, max_entries,
      max_del_occ, ies, max_top2, seed_len, max_steps;
  int cap, cap_a, nb;
  int32_t *heads;  // [B, nb] scratch: the newest slot of each score list
  Entry<C> *pool;  // [B, cap] scratch: the stack's slots
  int32_t *aln_m;  // [B, cap_a, 6] mm, go, ge, score, ins, del
  C *aln_kl;       // [B, cap_a, 2]
  int32_t *n_aln, *n_stk, *done_step, *n_occ, *steps;
  uint8_t *ovf;
};

// aln_score's int_log2 (bwtgap.c:99-107)
__device__ __forceinline__ int ilog2(uint32_t v) {
  int c = 0;
  if (v & 0xffff0000u) { v >>= 16; c |= 16; }
  if (v & 0xff00u) { v >>= 8; c |= 8; }
  if (v & 0xf0u) { v >>= 4; c |= 4; }
  if (v & 0xcu) { v >>= 2; c |= 2; }
  if (v & 0x2u) c |= 1;
  return c;
}

template <typename C, bool GAPE, bool NONSTOP, bool LOGGAP, bool SEED>
__global__ void __launch_bounds__(THREADS, 4)
    gap_machine_kernel(GapArgs<C> a) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const Fm<C> &f = a.f;
  C L2[5];
  load_L2(f, L2);
  const int L = a.L, cap = a.cap, cap_a = a.cap_a;
  const uint8_t *q = a.q + (size_t)b * L;
  C *wb = a.wb + (size_t)b * L * 2;
  const C *sb = a.sb + (size_t)b * a.SL * 2;
  int32_t *am = a.aln_m + (size_t)b * cap_a * 6;
  C *akl = a.aln_kl + (size_t)b * cap_a * 2;
  const int nb = a.nb;
  int32_t *heads = a.heads + (size_t)b * nb;
  Entry<C> *pool = a.pool + (size_t)b * cap;

  const int qlen = a.qlen[b], md = a.md[b], mg = a.mg[b];
  const bool seed_en = a.seed_en[b] != 0;
  const int s_mm = a.s_mm, s_gapo = a.s_gapo, s_gape = a.s_gape;
  const int max_gape = a.max_gape;
  int phase = P_DONE, n_stk = 0, seqc = 1;
  int lo = nb;                 // no list below lo holds an entry
  int free_head = -1, hw = 0;  // popped slots; slots never used from hw on
  for (int s = 0; s < nb; ++s) heads[s] = -1;
  if (a.active[b]) {  // one (i=len, k=0, l=seq_len, STATE_M) entry, score 0
    Entry<C> e0 = {};
    e0.f[F_I] = qlen;
    e0.l = f.seq_len;
    e0.nxt = -1;
    store_entry(pool, e0);
    heads[0] = 0;
    hw = 1;
    lo = 0;
    n_stk = 1;
    phase = P_RUN;
  }
  int best_score =
      (md + 1) * s_mm + (mg + 1) * s_gapo + (max_gape + 1) * s_gape;
  int mdc = md;
  C wk = 0, wl = 0;
  int wi = 0;
  int wm[7] = {0, 0, 0, 0, 0, 0, 0};  // score, mm, go, ge, ins, del, ldp
  C best_cnt = 0;
  int n_aln = 0, steps = 0, done_step = 0;
  int n_occ = 0;  // steps that read an occ4 pair: walks and expansions
  bool ovf = false;

  // hit bookkeeping (bwtgap.c:150-176); returns true when the lane stops
  auto hit = [&](int hsc, int hmm, int hgo, int hge, int hins, int hdel,
                 int hldp, C hk, C hl) -> bool {
    if (n_aln == 0) {
      best_score = hsc;
      if (!NONSTOP) {
        const int bd = hmm + hgo + (GAPE ? hge : 0) + 1;
        mdc = md < bd ? md : bd;
      }
    }
    const bool same_best = hsc == best_score;
    const bool brk2 = !same_best && best_cnt > (C)a.max_top2;
    if (same_best)  // wraps like the plain version's coordinate dtype
      best_cnt = (C)((unsigned long long)best_cnt +
                     (unsigned long long)(hl - hk + 1));
    bool dup = false;  // tandem-repeat duplicate (bwtgap.c:166-169)
    if (hgo > 0) {
      const int na = n_aln < cap_a ? n_aln : cap_a;
      for (int s = 0; s < na; ++s)
        dup |= akl[2 * s] == hk && akl[2 * s + 1] == hl;
    }
    if (!brk2 && !dup) {
      // gap_shadow (bwtgap.c:86-96) over width[0:ldp]
      const C x = hl - hk + 1;
      C jj = 0;
      const int tn = hldp < L ? hldp : L;
      for (int t = 0; t < tn; ++t) {
        const C w = wb[2 * t];
        if (w == x) {
          ++jj;
          wb[2 * t] = f.seq_len - jj;
          wb[2 * t + 1] = 1;
        } else if (w > x) {
          wb[2 * t] = w - x;
        }
      }
      // the last slot is overwritten once full; n_aln keeps counting
      const int slot = n_aln < cap_a - 1 ? n_aln : cap_a - 1;
      int32_t *r = am + 6 * slot;
      r[0] = hmm; r[1] = hgo; r[2] = hge; r[3] = hsc; r[4] = hins;
      r[5] = hdel;
      akl[2 * slot] = hk;
      akl[2 * slot + 1] = hl;
      if (n_aln >= cap_a) ovf = true;
      ++n_aln;
    }
    return brk2 || ovf;
  };

  while (phase != P_DONE && steps < a.max_steps) {
    bool done = false;
    int next = phase;
    if (phase == P_WALK) {
      // one character of bwt_match_exact_alt (bwt.c:241-256)
      ++n_occ;
      C ok[4], ol[4];
      occ4(f, L2, wk - 1, ok);
      occ4(f, L2, wl, ol);
      const int j = wi - 1;
      const int qc = q[clampi(j, 0, L - 1)];
      next = P_RUN;
      if (qc <= 3) {
        const C wkn = pick(L2, qc) + pick(ok, qc) + 1;
        const C wln = pick(L2, qc) + pick(ol, qc);
        if (wkn <= wln) {
          wk = wkn;
          wl = wln;
          wi = j;
          if (j == 0)
            done = hit(wm[0], wm[1], wm[2], wm[3], wm[4], wm[5], wm[6], wk,
                       wl);
          else
            next = P_WALK;
        }
      }
    } else if (n_stk > a.max_entries || n_stk == 0) {
      done = true;  // the stack-size stop (bwtgap.c:143) or an empty stack
    } else {
      // pop: lowest score, most recently pushed (n_stk > 0, so a list at
      // or above lo holds an entry)
      while (heads[lo] < 0) ++lo;
      const int sel = heads[lo];
      const Entry<C> e = load_entry(pool + sel);
      heads[lo] = e.nxt;
      pool[sel].nxt = free_head;  // the slot is free once its entry is read
      free_head = sel;
      const int e_i = e.f[F_I], e_mm = e.f[F_MM], e_go = e.f[F_GO];
      const int e_ge = e.f[F_GE], e_ins = e.f[F_INS], e_del = e.f[F_DEL];
      const int e_st = e.f[F_ST], e_ldp = e.f[F_LDP];
      const C e_k = e.k, e_l = e.l;
      --n_stk;
      const int score = e_mm * s_mm + e_go * s_gapo + e_ge * s_gape;
      const int used = e_mm + e_go + (GAPE ? e_ge : 0);
      const int m = mdc - used;
      const int p1 = clampi(e_i - 1, 0, L - 1), p0 = clampi(e_i - 2, 0, L - 1);
      const C ww0 = wb[2 * p0], ww1 = wb[2 * p1];
      const int wbid0 = (int)wb[2 * p0 + 1], wbid1 = (int)wb[2 * p1 + 1];
      if (!NONSTOP && score > best_score + s_mm) {
        done = true;  // the best-first stop (bwtgap.c:146)
      } else if (m < 0 || (e_i > 0 && m < wbid1)) {
        // too many differences for what is left of the read
      } else if (e_i == 0) {
        done = hit(score, e_mm, e_go, e_ge, e_ins, e_del, e_ldp, e_k, e_l);
      } else if (m == 0 && (GAPE || e_st == ST_M || e_ge == max_gape)) {
        wk = e_k;  // the exact-match walk starts next step
        wl = e_l;
        wi = e_i;
        wm[0] = score; wm[1] = e_mm; wm[2] = e_go; wm[3] = e_ge;
        wm[4] = e_ins; wm[5] = e_del; wm[6] = e_ldp;
        next = P_WALK;
      } else {
        // expansion (bwtgap.c:178-253)
        const int i2 = e_i - 1;
        ++n_occ;
        C ok[4], ol[4], kk4[4], ll4[4];
        occ4(f, L2, e_k - 1, ok);
        occ4(f, L2, e_l, ol);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kk4[c] = L2[c] + ok[c] + 1;
          ll4[c] = L2[c] + ol[c];
        }
        const int qc = q[clampi(i2, 0, L - 1)];
        const C occv = e_l - e_k + 1;
        const int ii = i2 - (qlen - a.seed_len);
        const bool in_band = i2 > 0;
        const bool w_block = in_band && wbid0 > m - 1;
        bool allow_diff = !w_block;
        bool allow_M = !(in_band && !w_block && wbid0 == m - 1 &&
                         wbid1 == m - 1 && ww0 == ww1);
        if (SEED) {
          const int m_seed = a.max_seed_diff - used;
          const int s0 = clampi(ii - 1, 0, a.SL - 1);
          const int s1 = clampi(ii, 0, a.SL - 1);
          const C sw0 = sb[2 * s0], sw1 = sb[2 * s1];
          const int sbid0 = (int)sb[2 * s0 + 1], sbid1 = (int)sb[2 * s1 + 1];
          const bool sgate = seed_en && in_band && ii > 0;
          const bool s_block = sgate && sbid0 > m_seed - 1;
          allow_diff = allow_diff && !s_block;
          allow_M = allow_M && !(sgate && !s_block && sbid0 == m_seed - 1 &&
                                 sbid1 == m_seed - 1 && sw0 == sw1);
        }
        const int tmp = LOGGAP ? ilog2((uint32_t)(e_ge + e_go)) / 2 + 1
                               : e_go + e_ge;
        const bool ggate = allow_diff && i2 >= a.ies + tmp &&
                           qlen - i2 >= a.ies + tmp;
        // the candidates in the reference's push order, each onto its
        // score's list while the stack has room
        const int base = n_stk, nfree = cap - n_stk;
        int n_push = 0, max_sc = 0;
        bool off_lists = false;
        auto push = [&](int i_, C k_, C l_, int mm_, int go_, int ge_,
                        int ins_, int del_, int st_, int ldp_) {
          const int sc = mm_ * s_mm + go_ * s_gapo + ge_ * s_gape;
          max_sc = sc > max_sc ? sc : max_sc;
          // past the lists only with ovf set (SCORE_CAP), or never
          off_lists |= sc < 0 || (sc >= nb && sc < SCORE_CAP);
          if (n_push < nfree) {
            int s = free_head;
            if (s >= 0)
              free_head = pool[s].nxt;
            else
              s = hw++;
            const int bk = sc < 0 ? 0 : (sc < nb ? sc : nb - 1);
            Entry<C> c;
            c.f[F_I] = i_; c.f[F_MM] = mm_; c.f[F_GO] = go_;
            c.f[F_GE] = ge_; c.f[F_INS] = ins_; c.f[F_DEL] = del_;
            c.f[F_ST] = st_; c.f[F_LDP] = ldp_;
            c.k = k_;
            c.l = l_;
            c.nxt = heads[bk];
            store_entry(pool + s, c);
            heads[bk] = s;
            lo = bk < lo ? bk : lo;
          }
          ++n_push;
        };
        const bool stM = e_st == ST_M, stI = e_st == ST_I, stD = e_st == ST_D;
        // slot 0: M-state gap open (insertion) OR I-state gap extension
        if (ggate && ((stM && e_go < mg) || (stI && e_ge < max_gape)))
          push(i2, e_k, e_l, e_mm, e_go + stM, e_ge + stI, e_ins + 1, e_del,
               ST_I, i2);
        // slots 1-4: deletions (M-state open / D-state extension)
        const bool dM = stM && e_go < mg;
        const bool dD = stD && e_ge < max_gape &&
                        (e_ge + e_go < mdc || occv < (C)a.max_del_occ);
        if (ggate && (dM || dD)) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (kk4[c] <= ll4[c])
              push(e_i, kk4[c], ll4[c], e_mm, e_go + dM, e_ge + dD, e_ins,
                   e_del + 1, ST_D, e_i);
        }
        // slots 5-8: substitutions j = 1..4 (bwtgap.c:232-246); when
        // allow_M is off but the exact char exists, only the j = 4 match
        // push happens (the elif at bwtgap.c:247-253)
        const bool both = allow_diff && allow_M;
#pragma unroll
        for (int jv = 1; jv <= 4; ++jv) {
          const int cj = (qc + jv) & 3;
          const bool is_mm = jv == 4 ? qc > 3 : true;
          const C kj = pick(kk4, cj), lj = pick(ll4, cj);
          if (kj <= lj && (both || (jv == 4 && qc < 4)))
            push(i2, kj, lj, e_mm + is_mm, e_go, e_ge, e_ins, e_del, ST_M,
                 is_mm ? i2 : 0);
        }
        if (max_sc >= SCORE_CAP || seqc + n_push >= SEQ_CAP ||
            n_push > nfree || off_lists)
          ovf = true;
        seqc += n_push;
        n_stk = base + (n_push < nfree ? n_push : nfree);
        done = ovf;
      }
    }
    ++steps;
    if (done) {
      phase = P_DONE;
      done_step = steps;
    } else {
      phase = next;
    }
  }
  // lanes stopped by max_steps: results incomplete -> host fallback
  a.ovf[b] = (ovf || phase != P_DONE) ? 1 : 0;
  a.n_aln[b] = n_aln;
  a.n_stk[b] = n_stk;
  a.done_step[b] = done_step;
  a.n_occ[b] = n_occ;
  atomicMax(a.steps, steps);
}

template <typename C, bool GAPE, bool NONSTOP, bool LOGGAP>
int launch_seed(const GapArgs<C> &a, bool use_seed, cudaStream_t stream) {
  const int grid = (a.B + THREADS - 1) / THREADS;
  if (use_seed)
    gap_machine_kernel<C, GAPE, NONSTOP, LOGGAP, true>
        <<<grid, THREADS, 0, stream>>>(a);
  else
    gap_machine_kernel<C, GAPE, NONSTOP, LOGGAP, false>
        <<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename C>
int launch_gap(const GapArgs<C> &a, int flags, cudaStream_t stream) {
  if (a.B == 0) return 0;
  if (a.cap < 1 || a.cap_a < 1 || a.nb < 1 || a.L < 1 || a.SL < 1)
    return (int)cudaErrorInvalidValue;
  const bool seed = flags & 8;
  switch (flags & 7) {
    case 0: return launch_seed<C, false, false, false>(a, seed, stream);
    case 1: return launch_seed<C, true, false, false>(a, seed, stream);
    case 2: return launch_seed<C, false, true, false>(a, seed, stream);
    case 3: return launch_seed<C, true, true, false>(a, seed, stream);
    case 4: return launch_seed<C, false, false, true>(a, seed, stream);
    case 5: return launch_seed<C, true, false, true>(a, seed, stream);
    case 6: return launch_seed<C, false, true, true>(a, seed, stream);
    default: return launch_seed<C, true, true, true>(a, seed, stream);
  }
}

template <typename C>
Fm<C> make_fm(const uint32_t *occtab, int nw, const int64_t *L2,
              int64_t primary, int64_t seq_len) {
  return Fm<C>{occtab, nw, nw == 8 ? 0 : 2, L2, (C)primary, (C)seq_len};
}

}  // namespace

// K7w: widths [B, L, 2] of the codes q [B, L]
extern "C" int bwa_cal_width(int coord64, const uint32_t *occtab, int nw,
                             const int64_t *L2, int64_t primary,
                             int64_t seq_len, const uint8_t *q, int B, int L,
                             void *out, void *stream) {
  if (nw != 8 && nw != 32) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return 0;
  const int grid = (B + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (coord64)
    cal_width_kernel<int64_t><<<grid, THREADS, 0, s>>>(
        make_fm<int64_t>(occtab, nw, L2, primary, seq_len), q, B, L,
        (int64_t *)out);
  else
    cal_width_kernel<int32_t><<<grid, THREADS, 0, s>>>(
        make_fm<int32_t>(occtab, nw, L2, primary, seq_len), q, B, L,
        (int32_t *)out);
  return (int)cudaGetLastError();
}

// K7: flags = GAPE | NONSTOP << 1 | LOGGAP << 2 | use_seed << 3;
// scal = s_mm, s_gapo, s_gape, max_gape, max_seed_diff, max_entries,
// max_del_occ, indel_end_skip, max_top2, seed_len (host array); nb score
// lists: heads [B, nb]; pool [B, cap] records of 48 or 64 bytes; n_occ
// [B]: each lane's steps that read an occ4 pair (a bound counts them)
extern "C" int bwa_gap_machine(
    int coord64, const uint32_t *occtab, int nw, const int64_t *L2,
    int64_t primary, int64_t seq_len, const uint8_t *q, int B, int L,
    const int32_t *qlen, const int32_t *md, const int32_t *mg,
    const uint8_t *seed_en, const void *sb, int SL, void *wb,
    const uint8_t *active, const int32_t *scal, int max_steps, int cap,
    int cap_a, int nb, int flags, int32_t *heads, void *pool,
    int32_t *aln_m, void *aln_kl, int32_t *n_aln, int32_t *n_stk,
    int32_t *done_step, int32_t *n_occ, uint8_t *ovf, int32_t *steps,
    void *stream) {
  if (nw != 8 && nw != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (coord64) {
    GapArgs<int64_t> a{make_fm<int64_t>(occtab, nw, L2, primary, seq_len),
                       q, B, L, qlen, md, mg, seed_en, active,
                       (const int64_t *)sb, SL, (int64_t *)wb,
                       scal[0], scal[1], scal[2], scal[3], scal[4], scal[5],
                       scal[6], scal[7], scal[8], scal[9], max_steps, cap,
                       cap_a, nb, heads, (Entry<int64_t> *)pool, aln_m,
                       (int64_t *)aln_kl, n_aln, n_stk, done_step, n_occ,
                       steps, ovf};
    return launch_gap(a, flags, s);
  }
  GapArgs<int32_t> a{make_fm<int32_t>(occtab, nw, L2, primary, seq_len),
                     q, B, L, qlen, md, mg, seed_en, active,
                     (const int32_t *)sb, SL, (int32_t *)wb,
                     scal[0], scal[1], scal[2], scal[3], scal[4], scal[5],
                     scal[6], scal[7], scal[8], scal[9], max_steps, cap,
                     cap_a, nb, heads, (Entry<int32_t> *)pool, aln_m,
                     (int32_t *)aln_kl, n_aln, n_stk, done_step, n_occ,
                     steps, ovf};
  return launch_gap(a, flags, s);
}
