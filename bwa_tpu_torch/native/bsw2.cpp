// BWA-SW native core: the read-BWT x genome-BWT DAG/trie dynamic program.
//
// From-scratch C++ implementation of the observable behaviour of the
// reference's bsw2_core (bwtsw2_core.c:449-619) together with the
// per-read "lite" FM-index it traverses (bwt_lite.c) and a batched
// genome bwt_sa walker (bwt.c:86-96).  Traversal order, Z-best pruning,
// duplicate removal and the two-best-per-position hit table are all
// visible in the emitted SAM, so every tie rule is replicated exactly;
// the *data layout* is ours: the genome FM-index is consumed directly in
// the framework's split ckpt/words arrays (see index/fmindex.py) instead
// of the reference's interleaved stream.
//
// Everything here is host-side orchestration-scale work (one read at a
// time, irregular pointer-chasing) - the wrong shape for the TPU; the
// batched device kernels live in bwa_tpu/ops.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>
#include <cstdlib>
#include <memory>
#include "occ64.h"

extern "C" int sais_u8_i32(const uint8_t *text, int32_t n, int32_t *sa_out);

namespace {

constexpr int32_t kMinusInf = -0x3fffffff;

// ---------------------------------------------------------------------
// Genome FM-index rank/occ over the split (ckpt, words) layout.
// Semantics identical to bwt_occ4 (bwt.c:169-186) / ops/fm_host.py.
// ---------------------------------------------------------------------

// interleaved occ blocks: per 128 bases, 4 int64 counts + 8 uint32
// text words = one 64-byte cache line (bwt.h:73-80 rationale); the
// 64-bit decode lives in occ64.h, shared with btgap/btsam.
using GenomeFM = occ64::View;

static inline void g_occ4(const GenomeFM &g, int64_t k, int64_t cnt[4]) {
  occ64::occ4(g, k, cnt);
}

// bwt_2occ4 idea (bwt.c:189-219): one pass serves both counts when k
// and l share a block (occ64::occ4_pair)
static inline void g_2occ4(const GenomeFM &g, int64_t k, int64_t l,
                           int64_t cntk[4], int64_t cntl[4]) {
  occ64::occ4_pair(g, k, l, cntk, cntl);
}

// BWT character at $-removed position x (bwt_B0, bwt.h:71).
static inline int g_B0(const GenomeFM &g, int64_t x) {
  return occ64::B0(g, x);
}

// One inverse-Psi step (bwt_invPsi, bwt.c:53-59).
static inline int64_t g_inv_psi(const GenomeFM &g, int64_t k) {
  return occ64::inv_psi(g, k);
}

// ---------------------------------------------------------------------
// Per-read lite FM-index (bwt_lite.c): plain occ table every 16 bases.
// ---------------------------------------------------------------------

struct ReadBwt {
  uint32_t seq_len = 0, primary = 0;
  uint32_t L2[5] = {0, 0, 0, 0, 0};
  std::vector<uint32_t> bwt;  // packed 2-bit, 16 bases/word
  std::vector<uint32_t> occ;  // [ (len+15)/16 ][4] counts at block starts
  std::vector<uint32_t> sa;   // len+1 entries; sa[0] = len
};

static int build_read_bwt(const uint8_t *seq, int len, ReadBwt *b) {
  b->seq_len = (uint32_t)len;
  b->sa.assign((size_t)len + 1, 0);
  b->sa[0] = (uint32_t)len;
  if (len > 0) {
    std::vector<int32_t> sa32(len);
    if (sais_u8_i32(seq, len, sa32.data()) != 0) return -1;
    for (int i = 0; i < len; ++i) b->sa[i + 1] = (uint32_t)sa32[i];
  }
  // BWT string with the sentinel row removed (bwt_lite.c:20-34)
  std::vector<uint8_t> s((size_t)len + 1, 0);
  for (int i = 0; i <= len; ++i) {
    if (b->sa[i] == 0)
      b->primary = (uint32_t)i;
    else
      s[i] = seq[b->sa[i] - 1];
  }
  for (int i = (int)b->primary; i < len; ++i) s[i] = s[i + 1];
  b->bwt.assign(((size_t)len + 15) / 16, 0u);
  for (int i = 0; i < len; ++i)
    b->bwt[i >> 4] |= (uint32_t)s[i] << ((15 - (i & 15)) << 1);
  // occ checkpoints every 16 bases + cumulative L2 (bwt_lite.c:36-48)
  b->occ.assign(((size_t)len + 15) / 16 * 4, 0u);
  uint32_t c[4] = {0, 0, 0, 0};
  for (int i = 0; i < len; ++i) {
    if (i % 16 == 0) std::memcpy(&b->occ[(size_t)(i / 16) * 4], c, 16);
    ++c[(b->bwt[i >> 4] >> ((~i & 15) << 1)) & 3];
  }
  b->L2[0] = 0;
  for (int i = 0; i < 4; ++i) b->L2[i + 1] = b->L2[i] + c[i];
  return 0;
}

// bwtl_occ4 (bwt_lite.c:72-86); k is uint32 with (uint32_t)-1 meaning "-1".
static void r_occ4(const ReadBwt &b, uint32_t k, uint32_t cnt[4]) {
  if (k == (uint32_t)-1) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  if (k >= b.primary) --k;  // $ is not stored in the BWT
  std::memcpy(cnt, &b.occ[(size_t)(k >> 4) * 4], 16);
  uint32_t mask2 = ~((1u << ((~k & 15) << 1)) - 1u);
  uint32_t word = b.bwt[k >> 4] & mask2;
  uint32_t vm = mask2 & 0x55555555u;
  uint32_t hi = (word >> 1) & 0x55555555u, lo = word & 0x55555555u;
  cnt[3] += (uint32_t)__builtin_popcount(hi & lo);
  cnt[2] += (uint32_t)__builtin_popcount(hi & ~lo);
  cnt[1] += (uint32_t)__builtin_popcount(lo & ~hi);
  cnt[0] += (uint32_t)__builtin_popcount(vm & ~hi & ~lo);
}

// ---------------------------------------------------------------------
// DAG traversal state (bwtsw2_core.c:15-68)
// ---------------------------------------------------------------------

struct Cell {  // 56 bytes: bitfields as in bsw2cell_t (bwtsw2.h:13-20) —
               // cell traffic dominates the DAG core, density matters
  int64_t qk, ql;          // genome-BWT interval
  int32_t I, D, G;
  uint32_t pj : 2;         // incoming read-trie branch label
  uint32_t qlen : 15, tlen : 15;
  int32_t ppos, upos;
  int32_t cpos[4];
};

static const Cell kDefaultCell = {0,  0,  kMinusInf, kMinusInf, kMinusInf,
                                  0,  0,  0,         -1,        -1,
                                  {-1, -1, -1, -1}};

// Raw growable Cell array with a speculative tail slot — the reference's
// push_array_p pattern (bwtsw2_core.c:205-212): the DP loop writes the
// candidate cell in place and commits with ++n only when it survives,
// instead of init-copy + push_back (two 56-byte copies per live cell,
// which dominated the core before this).
struct CellBuf {
  Cell *a = nullptr;
  int n = 0, cap = 0;
  ~CellBuf() { std::free(a); }
  CellBuf() = default;
  CellBuf(const CellBuf &) = delete;
  CellBuf &operator=(const CellBuf &) = delete;
  inline void grow(int need) {
    if (need > cap) {
      cap = cap ? cap : 16;
      while (cap < need) cap <<= 1;
      a = (Cell *)std::realloc(a, (size_t)cap * sizeof(Cell));
    }
  }
  inline Cell *slot() {  // pointer to the uncommitted tail cell
    grow(n + 1);
    return a + n;
  }
  inline void push_back(const Cell &c) {
    *slot() = c;
    ++n;
  }
  inline int size() const { return n; }
  inline bool empty() const { return n == 0; }
  inline void clear() { n = 0; }
  inline Cell &operator[](int i) { return a[i]; }
  inline const Cell &operator[](int i) const { return a[i]; }
  inline Cell *begin() { return a; }
  inline Cell *end() { return a + n; }
  inline const Cell *begin() const { return a; }
  inline const Cell *end() const { return a + n; }
  inline void append(const CellBuf &o) {
    grow(n + o.n);
    std::memcpy(a + n, o.a, (size_t)o.n * sizeof(Cell));
    n += o.n;
  }
};

struct Entry {
  uint32_t tk = 0, tl = 0;  // read-BWT interval
  CellBuf cells;
};

struct Hit {  // mirrors bsw2hit_t output fields (bwtsw2.h:22-27)
  int64_t k, l;
  int64_t flag, n_seeds, len, G, G2, beg, end, is_rev;
};

struct Opt {
  int32_t a, b, q, r, qr, t, z, is, bw;
};

// exact ks_heapadjust over ints, lt = "<" (ksort.h:121-131); max-heap root
static void heap_adjust(int i, int n, int32_t *l) {
  int k = i;
  int32_t tmp = l[i];
  while ((k = (k << 1) + 1) < n) {
    if (k != n - 1 && l[k] < l[k + 1]) ++k;
    if (l[k] < tmp) break;
    l[i] = l[k];
    i = k;
  }
  l[i] = tmp;
}


// Open-addressing hash maps (the khash trick, replacing
// std::unordered_map's node allocations — the connectivity hash is hit
// on every DAG edge and was a large share of the core's runtime).

struct FlatMap64 {  // uint64 key -> uint64 value; key ~0 reserved
  static constexpr uint64_t EMPTY = ~0ull;
  std::vector<uint64_t> keys, vals;
  size_t mask = 0, count = 0;
  void reset(size_t expect) {
    size_t cap = 16;
    while (cap < expect * 2) cap <<= 1;
    keys.assign(cap, EMPTY);
    vals.resize(cap);
    mask = cap - 1;
    count = 0;
  }
  static inline size_t hashf(uint64_t k) {
    return (size_t)((k * 0x9E3779B97F4A7C15ull) >> 13);
  }
  uint64_t *find(uint64_t k) {
    size_t i = hashf(k) & mask;
    while (keys[i] != EMPTY) {
      if (keys[i] == k) return &vals[i];
      i = (i + 1) & mask;
    }
    return nullptr;
  }
  void grow() {
    std::vector<uint64_t> ok(std::move(keys)), ov(std::move(vals));
    keys.assign((mask + 1) << 1, EMPTY);
    vals.resize((mask + 1) << 1);
    mask = keys.size() - 1;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (ok[i] == EMPTY) continue;
      size_t j = hashf(ok[i]) & mask;
      while (keys[j] != EMPTY) j = (j + 1) & mask;
      keys[j] = ok[i];
      vals[j] = ov[i];
    }
  }
  void insert_absent(uint64_t k, uint64_t v) {  // caller checked absence
    if ((count + 1) * 10 >= (mask + 1) * 7) grow();
    size_t i = hashf(k) & mask;
    while (keys[i] != EMPTY) i = (i + 1) & mask;
    keys[i] = k;
    vals[i] = v;
    ++count;
  }
};

struct FlatMapPair {  // (int64, int64) key -> (int32 idx, int32 G)
  std::vector<int64_t> k1, k2;  // k1 == -1 marks empty (qk >= 0 always)
  std::vector<uint64_t> vals;
  size_t mask = 0, count = 0;
  void clear_cap(size_t expect) {
    size_t cap = 16;
    while (cap < expect * 2) cap <<= 1;
    if (cap > k1.size()) {
      k1.assign(cap, -1);
      k2.resize(cap);
      vals.resize(cap);
      mask = cap - 1;
    } else {
      std::fill(k1.begin(), k1.end(), -1);
    }
    count = 0;
  }
  static inline size_t hashf(int64_t a, int64_t b) {
    // same mixing idea as the reference's qintv_hash (k>>7 ^ l<<17)
    return (size_t)(((uint64_t)a >> 7 ^ (uint64_t)b << 17)
                    * 0x9E3779B97F4A7C15ull >> 13);
  }
  // returns slot index; *found tells whether the key was present
  size_t find_slot(int64_t a, int64_t b, bool *found) {
    size_t i = hashf(a, b) & mask;
    while (k1[i] != -1) {
      if (k1[i] == a && k2[i] == b) { *found = true; return i; }
      i = (i + 1) & mask;
    }
    *found = false;
    return i;
  }
  void place(size_t slot, int64_t a, int64_t b, uint64_t v) {
    k1[slot] = a;
    k2[slot] = b;
    vals[slot] = v;
    ++count;  // capacity is pre-sized to 2x the cell count: no grow
  }
};

struct Pool {
  std::vector<Entry *> free_list;
  std::vector<Entry *> all;
  Entry *alloc() {
    if (free_list.empty()) {
      Entry *e = new Entry();
      all.push_back(e);
      return e;
    }
    Entry *e = free_list.back();
    free_list.pop_back();
    e->cells.clear();
    return e;
  }
  void release(Entry *e) { free_list.push_back(e); }
  ~Pool() {
    for (Entry *e : all) delete e;
  }
};

// Count the in-degree of every node of the read suffix DAG
// (bsw2_connectivity, bwtsw2_core.c:99-132).
static void connectivity(const ReadBwt &b, FlatMap64 *h) {
  std::vector<uint64_t> stack;
  h->reset((size_t)b.seq_len * 4);
  stack.push_back((uint64_t)b.seq_len);  // root: k=0, l=seq_len
  while (!stack.empty()) {
    uint64_t x = stack.back();
    stack.pop_back();
    uint32_t k = (uint32_t)(x >> 32), l = (uint32_t)x;
    uint32_t cntk[4], cntl[4];
    r_occ4(b, k - 1, cntk);
    r_occ4(b, l, cntl);
    for (int j = 0; j < 4; ++j) {
      uint32_t ck = b.L2[j] + cntk[j] + 1;
      uint32_t cl = b.L2[j] + cntl[j];
      if (ck > cl) continue;
      uint64_t key = (uint64_t)ck << 32 | cl;
      uint64_t *v = h->find(key);
      if (!v) {
        h->insert_absent(key, 1);
        stack.push_back(key);
      } else {
        ++*v;
      }
    }
  }
}

// Keep the top-T scored cells of an entry (cut_tail, bwtsw2_core.c:134-157).
static void cut_tail(Entry *u, int T, std::vector<int32_t> *scratch) {
  int n_cells = (int)u->cells.size();
  if (n_cells <= T) return;
  int32_t x;
  if (T == 1) {  // fast path for the default -z1: x = 2nd-largest G
    int32_t m1 = kMinusInf, m2 = kMinusInf;
    int cnt = 0;
    for (int i = 0; i < n_cells; ++i) {
      const Cell &c = u->cells[i];
      if (!c.ql || c.G <= 0) continue;
      ++cnt;
      if (c.G >= m1) {
        m2 = m1;
        m1 = c.G;
      } else if (c.G > m2) {
        m2 = c.G;
      }
    }
    if (cnt <= T) return;
    x = m2;
  } else {
    scratch->clear();
    for (int i = 0; i < n_cells; ++i)
      if (u->cells[i].ql && u->cells[i].G > 0)
        scratch->push_back(-u->cells[i].G);
    if ((int)scratch->size() <= T) return;
    // the reference takes ks_ksmall(.., T): the T-th order statistic
    std::nth_element(scratch->begin(), scratch->begin() + T, scratch->end());
    x = -(*scratch)[T];
  }
  int n = 0;
  for (int i = 0; i < n_cells; ++i) {
    Cell *p = &u->cells[i];
    if (p->G == x) ++n;
    if (p->G < x || (p->G == x && n >= T)) {
      p->qk = p->ql = 0;
      p->G = 0;
      if (p->ppos >= 0) u->cells[p->ppos].cpos[p->pj] = -1;
    }
  }
}

// Drop cells with a duplicated genome interval, keeping the higher score
// (remove_duplicate, bwtsw2_core.c:159-184).
static void remove_duplicate(Entry *u, FlatMapPair *h) {
  int n_cells = (int)u->cells.size();
  h->clear_cap((size_t)n_cells + 1);
  for (int i = 0; i < n_cells; ++i) {
    Cell *p = &u->cells[i];
    if (p->ql == 0) continue;
    bool found;
    size_t slot = h->find_slot(p->qk, p->ql, &found);
    int j = -1;
    if (found) {
      int32_t vi = (int32_t)(h->vals[slot] >> 32);
      int32_t vg = (int32_t)h->vals[slot];
      if (vg >= p->G) {
        j = i;
      } else {
        j = vi;
        h->vals[slot] = (uint64_t)(uint32_t)i << 32 | (uint32_t)p->G;
      }
    } else {
      h->place(slot, p->qk, p->ql,
               (uint64_t)(uint32_t)i << 32 | (uint32_t)p->G);
    }
    if (j >= 0) {
      Cell *d = &u->cells[j];
      d->qk = d->ql = 0;
      d->G = 0;
      if (d->ppos >= 0) u->cells[d->ppos].cpos[d->pj] = -3;
    }
  }
}

// Append v's cells to u, fixing intra-entry links (merge_entry,
// bwtsw2_core.c:186-203).
static void merge_entry(Entry *u, Entry *v) {
  int off = (int)u->cells.size();
  for (Cell &c : v->cells) {
    if (c.ppos >= 0) c.ppos += off;
    for (int j = 0; j < 4; ++j)
      if (c.cpos[j] >= 0) c.cpos[j] += off;
  }
  u->cells.append(v->cells);
}

// Record the two best hits per read position (save_hits,
// bwtsw2_core.c:223-245).  hits has 2*seq_len preallocated slots.
static void save_hits(const ReadBwt &b, int thres, Hit *hits, const Entry *u) {
  for (const Cell &p : u->cells) {
    if (p.G < thres) continue;
    for (uint32_t k = u->tk; k <= u->tl; ++k) {
      int64_t beg = b.sa[k], end = beg + p.tlen;
      Hit *q = nullptr;
      if (p.G > hits[beg * 2].G) {
        hits[beg * 2 + 1] = hits[beg * 2];
        q = &hits[beg * 2];
      } else if (p.G > hits[beg * 2 + 1].G) {
        q = &hits[beg * 2 + 1];
      }
      if (q) {
        q->k = p.qk;
        q->l = p.ql;
        q->len = p.qlen;
        q->G = p.G;
        q->beg = beg;
        q->end = end;
        q->G2 = (q->k == q->l) ? 0 : q->G;
        q->flag = q->n_seeds = 0;
        q->is_rev = 0;
      }
    }
  }
}

// Extract high-scoring cells with a narrow genome interval and delete them
// from the entry (save_narrow_hits, bwtsw2_core.c:248-270).
static void save_narrow_hits(const ReadBwt &b, Entry *u, std::vector<Hit> *b1,
                             int t, int IS) {
  int n_cells = (int)u->cells.size();
  for (int i = 0; i < n_cells; ++i) {
    Cell *p = &u->cells[i];
    if (p->G >= t && p->ql - p->qk + 1 <= IS) {
      Hit q;
      q.k = p->qk;
      q.l = p->ql;
      q.len = p->qlen;
      q.G = p->G;
      q.G2 = 0;
      q.beg = b.sa[u->tk];
      q.end = q.beg + p->tlen;
      q.flag = q.n_seeds = q.is_rev = 0;
      b1->push_back(q);
      p->qk = p->ql = 0;
      p->G = 0;
      if (p->ppos >= 0) u->cells[p->ppos].cpos[p->pj] = -3;
    }
  }
}

// Affine-gap cell update (fill_cell, bwtsw2_core.c:421-433).
static inline int fill_cell(const Opt &o, int match_score, Cell *x,
                            const Cell *cI, const Cell *cD, const Cell *cG) {
  int G = cG ? cG->G + match_score : kMinusInf;
  if (cI) {
    x->I = cI->I > cI->G - o.q ? cI->I - o.r : cI->G - o.qr;
    if (x->I > G) G = x->I;
  } else {
    x->I = kMinusInf;
  }
  if (cD) {
    x->D = cD->D > cD->G - o.q ? cD->D - o.r : cD->G - o.qr;
    if (x->D > G) G = x->D;
  } else {
    x->D = kMinusInf;
  }
  return x->G = G;
}

}  // namespace

extern "C" {

// Runs the full DAG traversal for one read.  out_b must hold 2*read_len
// Hit records (10 int64 each), zero-initialised by the caller; out_b1
// receives the narrow hits (capacity b1_cap records).  Returns the number
// of narrow hits, -1 on b1 overflow (caller re-runs with a larger buffer),
// -2 on internal error.
int64_t bsw2_core_run(const uint8_t *g_inter,
                      int64_t g_seq_len, int64_t g_primary,
                      const int64_t *g_L2, const uint8_t *read, int32_t l,
                      int32_t a, int32_t b_pen, int32_t q_pen, int32_t r_pen,
                      int32_t t_thres, int32_t z_best, int32_t is_intv,
                      int32_t bw, int64_t *out_b, int64_t *out_b1,
                      int64_t b1_cap) {
  GenomeFM g{g_inter, g_seq_len, g_primary, g_L2};
  Opt opt{a, b_pen, q_pen, r_pen, q_pen + r_pen, t_thres, z_best, is_intv, bw};
  ReadBwt target;
  FlatMap64 chash;
  if (build_read_bwt(read, l, &target) != 0) return -2;
  connectivity(target, &chash);

  int score_mat[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) score_mat[i << 2 | j] = (i == j) ? opt.a : -opt.b;

  FlatMapPair rhash;
  Pool pool;
  std::vector<Entry *> stack0;
  std::vector<Entry *> pending;
  int n_pending = 0;
  std::vector<int32_t> heap((size_t)opt.z, 0);
  std::vector<int32_t> scratch;

  Hit *hits = reinterpret_cast<Hit *>(out_b);     // 2*l records
  std::vector<Hit> b1;

  {  // init_bwtsw2 (bwtsw2_core.c:435-447)
    Entry *u = pool.alloc();
    u->tk = 0;
    u->tl = target.seq_len;
    Cell x = kDefaultCell;
    x.G = 0;
    x.qk = 0;
    x.ql = g.seq_len;
    u->cells.push_back(x);
    stack0.push_back(u);
  }

  while (!(stack0.empty() && n_pending == 0)) {
    if (stack0.empty()) return -2;  // reference asserts here too
    Entry *v = stack0.back();
    stack0.pop_back();
    int old_n = (int)v->cells.size();

    // band-width / depth test (bwtsw2_core.c:488-495)
    for (int i = 0; i < old_n; ++i) {
      Cell *p = &v->cells[i];
      if (p->ql == 0) continue;
      if (p->tlen - p->qlen > opt.bw || p->qlen - p->tlen > opt.bw) {
        p->qk = p->ql = 0;
        if (p->ppos >= 0) v->cells[p->ppos].cpos[p->pj] = -5;
      }
    }

    uint32_t tcntk[4], tcntl[4];
    r_occ4(target, v->tk - 1, tcntk);
    r_occ4(target, v->tl, tcntl);
    for (int tj = 0; tj < 4; ++tj) {  // descend in the read suffix DAG
      uint32_t tk = target.L2[tj] + tcntk[tj] + 1;
      uint32_t tl = target.L2[tj] + tcntl[tj];
      if (tk > tl) continue;
      uint64_t key = (uint64_t)tk << 32 | tl;
      uint64_t *cval = chash.find(key);
      if (!cval) return -2;
      --*cval;
      Entry *u = pool.alloc();
      u->tk = tk;
      u->tl = tl;
      if (opt.z == 1)
        heap[0] = 0;
      else
        std::fill(heap.begin(), heap.end(), 0);
      const int *curr_score_mat = score_mat + tj * 4;

      for (int i = 0; i < v->cells.n; ++i) {  // v grows in-loop
        Cell *p = v->cells.a + i;
        if (p->ql == 0) continue;
        Cell *x = u->cells.slot();  // speculative slot; ++n commits it
        int is_added = 0;
        x->G = kMinusInf;
        p->upos = x->upos = -1;
        if (p->ppos >= 0) {  // parent visited: full affine update
          int par_upos = v->cells.a[p->ppos].upos;
          const Cell *cI = par_upos >= 0 ? &u->cells.a[par_upos] : nullptr;
          if (fill_cell(opt, curr_score_mat[p->pj], x, cI, p,
                        &v->cells.a[p->ppos]) > 0) {
            x->ppos = par_upos;
            p->upos = u->cells.n++;
            if (x->ppos >= 0) u->cells.a[x->ppos].cpos[p->pj] = p->upos;
            is_added = 1;
          }
        } else {  // only the deletion path is open
          x->D = p->D > p->G - opt.q ? p->D - opt.r : p->G - opt.qr;
          if (x->D > 0) {
            x->G = x->D;
            x->I = kMinusInf;
            x->ppos = -1;
            p->upos = u->cells.n++;
            is_added = 1;
          }
        }
        if (is_added) {
          x->cpos[0] = x->cpos[1] = x->cpos[2] = x->cpos[3] = -1;
          x->pj = p->pj;
          x->qk = p->qk;
          x->ql = p->ql;
          x->qlen = p->qlen;
          x->tlen = p->tlen + 1;
          if (x->G > -heap[0]) {  // Z-best heap (bwtsw2_core.c:544-547)
            heap[0] = -x->G;
            heap_adjust(0, opt.z, heap.data());
          }
        }
        // good node in u, or an original node of v: expand the query trie
        if ((x->G > opt.qr && x->G >= -heap[0]) || i < old_n) {
          if (p->cpos[0] == -1 || p->cpos[1] == -1 || p->cpos[2] == -1 ||
              p->cpos[3] == -1) {
            int64_t qcntk[4], qcntl[4];
            g_2occ4(g, p->qk - 1, p->ql, qcntk, qcntl);
            for (int qj = 0; qj < 4; ++qj) {
              if (p->cpos[qj] != -1) continue;
              int64_t nk = g.L2[qj] + qcntk[qj] + 1;
              int64_t nl = g.L2[qj] + qcntl[qj];
              if (nk > nl) {
                p->cpos[qj] = -2;
                continue;
              }
              Cell *nc = v->cells.slot();
              p = v->cells.a + i;  // re-derive: slot() may realloc
              nc->G = nc->I = nc->D = kMinusInf;
              nc->upos = -1;
              nc->qk = nk;
              nc->ql = nl;
              nc->pj = qj;
              nc->qlen = p->qlen + 1;
              nc->ppos = i;
              nc->tlen = p->tlen;
              nc->cpos[0] = nc->cpos[1] = nc->cpos[2] = nc->cpos[3] = -1;
              p->cpos[qj] = v->cells.n++;
            }
          }
        }
      }  // ~for(i)

      if (!u->cells.empty()) save_hits(target, opt.t, hits, u);

      {  // push u to the stack or the pending array (bwtsw2_core.c:568-601)
        uint32_t cnt = (uint32_t)*cval;
        uint32_t pos = (uint32_t)(*cval >> 32);
        if (pos) {  // merge into the pending entry
          Entry *w = pending[pos - 1];
          if (!u->cells.empty()) {
            if (w->cells.size() < u->cells.size()) {
              std::swap(w, u);
              pending[pos - 1] = w;
            }
            merge_entry(w, u);
          }
          if (cnt == 0) {  // all in-edges seen: move to the stack
            remove_duplicate(w, &rhash);
            save_narrow_hits(target, w, &b1, opt.t, opt.is);
            cut_tail(w, opt.z, &scratch);
            stack0.push_back(w);
            pending[pos - 1] = nullptr;
            --n_pending;
          }
          pool.release(u);
        } else if (cnt) {  // first visit of a multi-in-edge node
          if (!u->cells.empty()) {
            ++n_pending;
            pending.push_back(u);
            *cval = (uint64_t)pending.size() << 32 | cnt;
          } else {
            pool.release(u);
          }
        } else {  // single in-edge: straight to the stack
          save_narrow_hits(target, u, &b1, opt.t, opt.is);
          cut_tail(u, opt.z, &scratch);
          stack0.push_back(u);
        }
      }
    }  // ~for(tj)
    pool.release(v);
  }  // ~while

  if ((int64_t)b1.size() > b1_cap) return -1;
  std::memcpy(out_b1, b1.data(), b1.size() * sizeof(Hit));
  return (int64_t)b1.size();
}

// Batched genome SA lookup: positions for SA ranks ks[0..n) (bwt_sa,
// bwt.c:86-96), walking inverse-Psi to the nearest sampled entry.
// Returns the walk's steps over all ranks.
int64_t fm_sa_batch(const uint8_t *g_inter,
                    int64_t g_seq_len, int64_t g_primary, const int64_t *g_L2,
                    const int64_t *ssa, int32_t sa_intv, const int64_t *ks,
                    int64_t n, int64_t *out) {
  GenomeFM g{g_inter, g_seq_len, g_primary, g_L2};
  int64_t mask = sa_intv - 1, steps = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = ks[i], s = 0;
    while (k & mask) {
      ++s;
      k = g_inv_psi(g, k);
    }
    out[i] = s + ssa[k / sa_intv];
    steps += s;
  }
  return steps;
}

}  // extern "C"

// ===========================================================================
// bsw2_resolve_duphits (bwtsw2_core.c:273-347), native.
//
// Mirrors sw2/core.py resolve_duphits exactly: SA expansion of narrow
// intervals, the ks_introsort permutation with __hitG_lt
// (bwtsw2_core.c:42), the float32 query-overlap ratios vs the float64
// target-overlap ratios (lines 325-328), and the G2 bubbling.  The
// introsort below replicates ksort.h:176-226 the same way
// mem/ksort.py does — tie order is observable in SAM output.
// ===========================================================================

namespace {

inline bool hitG_lt(const Hit &a, const Hit &b) {
  return a.G + (a.n_seeds << 2) > b.G + (b.n_seeds << 2);
}

void hit_insertsort(Hit *a, int s, int t) {  // [s, t)
  for (int i = s + 1; i < t; ++i)
    for (int j = i; j > s && hitG_lt(a[j], a[j - 1]); --j)
      std::swap(a[j], a[j - 1]);
}

void hit_combsort(Hit *a, int s, int n) {
  const double shrink = 1.2473309501039786540366528676643;
  int gap = n;
  for (;;) {
    if (gap > 2) {
      gap = (int)(gap / shrink);
      if (gap == 9 || gap == 10) gap = 11;
    }
    bool do_swap = false;
    for (int i = s; i < s + n - gap; ++i) {
      int j = i + gap;
      if (hitG_lt(a[j], a[i])) {
        std::swap(a[i], a[j]);
        do_swap = true;
      }
    }
    if (!(do_swap || gap > 2)) break;
  }
  if (gap != 1) hit_insertsort(a, s, s + n);
}

void hit_introsort(Hit *a, int n) {
  if (n < 1) return;
  if (n == 2) {
    if (hitG_lt(a[1], a[0])) std::swap(a[0], a[1]);
    return;
  }
  int d = 2;
  while ((1 << d) < n) ++d;
  struct Frame { int s, t, d; };
  std::vector<Frame> stk;
  int s = 0, t = n - 1;
  d <<= 1;
  for (;;) {
    if (s < t) {
      if (--d == 0) {
        hit_combsort(a, s, t - s + 1);
        t = s;
        continue;
      }
      int i = s, j = t;
      int k = i + ((j - i) >> 1) + 1;
      if (hitG_lt(a[k], a[i])) {
        if (hitG_lt(a[k], a[j])) k = j;
      } else {
        k = hitG_lt(a[j], a[i]) ? i : j;
      }
      Hit rp = a[k];
      if (k != t) std::swap(a[k], a[t]);
      for (;;) {
        ++i;
        while (hitG_lt(a[i], rp)) ++i;
        --j;
        while (i <= j && hitG_lt(rp, a[j])) --j;
        if (j <= i) break;
        std::swap(a[i], a[j]);
      }
      std::swap(a[i], a[t]);
      if (i - s > t - i) {
        if (i - s > 16) stk.push_back({s, i - 1, d});
        s = (t - i > 16) ? i + 1 : t;
      } else {
        if (t - i > 16) stk.push_back({i + 1, t, d});
        t = (i - s > 16) ? i - 1 : s;
      }
    } else {
      if (stk.empty()) {
        hit_insertsort(a, 0, n);
        return;
      }
      Frame f = stk.back();
      stk.pop_back();
      s = f.s;
      t = f.t;
      d = f.d;
    }
  }
}

inline int64_t sa_one(const GenomeFM &g, const int64_t *ssa, int32_t sa_intv,
                      int64_t k) {
  int64_t mask = sa_intv - 1, s = 0;
  while (k & mask) {
    ++s;
    k = g_inv_psi(g, k);
  }
  return s + ssa[k / sa_intv];
}

}  // namespace

extern "C" {

// rows_in/rows_out: 10x int64 Hit records (k,l,flag,n_seeds,len,G,G2,
// beg,end,is_rev).  Returns the resolved count, or -1 if rows_out
// (capacity cap_out records) is too small for the SA expansion.
int64_t bsw2_resolve_duphits_rows(
    const uint8_t *g_inter, int64_t g_seq_len,
    int64_t g_primary, const int64_t *g_L2, const int64_t *ssa,
    int32_t sa_intv, const int64_t *rows_in, int64_t n_in, int32_t IS,
    int64_t *rows_out, int64_t cap_out) {
  GenomeFM g{g_inter, g_seq_len, g_primary, g_L2};
  const int64_t l_pac = g_seq_len >> 1;
  std::vector<Hit> hits;
  hits.reserve((size_t)n_in);
  for (int64_t i = 0; i < n_in; ++i) {
    const Hit *p = reinterpret_cast<const Hit *>(rows_in + 10 * i);
    if (p->l - p->k + 1 <= IS) {  // not so repetitive: expand
      if (p->G == 0 && p->k == 0 && p->l == 0 && p->len == 0) continue;
      for (int64_t r = p->k; r <= p->l; ++r) {
        Hit h = *p;
        int64_t s = sa_one(g, ssa, sa_intv, r);
        int64_t is_rev = s >= l_pac;
        if (is_rev) s = (l_pac << 1) - 1 - s;
        h.k = s - (is_rev ? p->len - 1 : 0);
        h.l = 0;
        h.is_rev = is_rev;
        hits.push_back(h);
      }
    } else if (p->G > 0) {  // repetitive: one coordinate, flagged
      Hit h = *p;
      int64_t s = sa_one(g, ssa, sa_intv, p->k);
      int64_t is_rev = s >= l_pac;
      if (is_rev) s = (l_pac << 1) - 1 - s;
      h.k = s - (is_rev ? p->len - 1 : 0);
      h.l = 0;
      h.flag |= 1;
      h.is_rev = is_rev;
      hits.push_back(h);
    }
  }
  {  // squeeze empties (bwtsw2_core.c:312-316)
    size_t w = 0;
    for (size_t i = 0; i < hits.size(); ++i)
      if (hits[i].G) hits[w++] = hits[i];
    hits.resize(w);
  }
  hit_introsort(hits.data(), (int)hits.size());
  const int n = (int)hits.size();
  for (int i = 1; i < n; ++i) {
    Hit *p = &hits[i];
    for (int j = 0; j < i; ++j) {
      Hit *q = &hits[j];
      bool compatible = true;
      if (p->is_rev != q->is_rev) continue;
      if (p->l == 0 && q->l == 0) {
        int64_t qol = std::min(p->end, q->end) - std::max(p->beg, q->beg);
        if (qol < 0) qol = 0;
        // query-overlap ratios compare in float32 (bwtsw2_core.c:325)
        if ((float)qol / (float)(p->end - p->beg) > 0.90f ||
            (float)qol / (float)(q->end - q->beg) > 0.90f) {
          int64_t tol =
              std::min(p->k + p->len, q->k + q->len) - std::max(p->k, q->k);
          // ... but the target ratios in float64 (line 328)
          if ((double)tol / (double)p->len > (double)0.90f ||
              (double)tol / (double)q->len > (double)0.90f)
            compatible = false;
        }
      }
      if (!compatible) {
        p->G = 0;
        if (q->G2 < p->G2) q->G2 = p->G2;
        break;
      }
    }
  }
  int64_t w = 0;
  for (int i = 0; i < n; ++i) {
    if (!hits[i].G) continue;
    if (w >= cap_out) return -1;
    std::memcpy(rows_out + 10 * w, &hits[i], sizeof(Hit));
    ++w;
  }
  return w;
}

}  // extern "C"

// ===========================================================================
// Full per-read aln1 pipeline (bsw2_aln1_core, bwtsw2_aux.c:226-319) native:
// strand split, chain filter (bwtsw2_chain.c), left/right seed extension
// (bwtsw2_aux.c:100-170), duplicate resolution rounds and the final
// query-overlap resolution with its drand48 tie promotion.  The Python
// orchestration in sw2/aln.py aln1_core is the executable spec; this is the
// hot path (it removes the per-hit object churn and ksw marshaling that
// kept bwasw at ~0.66x the reference).
// ===========================================================================

extern "C" int bt_ksw_extend2(int qlen, const uint8_t *query, int tlen,
                              const uint8_t *target, int m, const int8_t *mat,
                              int o_del, int e_del, int o_ins, int e_ins,
                              int w, int end_bonus, int zdrop, int h0,
                              int *_qle, int *_tle, int *_gtle, int *_gscore,
                              int *_max_off);

extern "C" int64_t bsw2_core_run(const uint8_t *g_inter, int64_t g_seq_len,
                                 int64_t g_primary, const int64_t *g_L2,
                                 const uint8_t *read, int32_t l, int32_t a,
                                 int32_t b_pen, int32_t q_pen, int32_t r_pen,
                                 int32_t t, int32_t z, int32_t is_intv,
                                 int32_t bw, int64_t *out_b, int64_t *out_b1,
                                 int64_t b1_cap);

namespace {

struct Drand48 {
  uint64_t x;
  static const uint64_t A = 0x5DEECE66DULL, C = 0xBULL,
                        MASK = (1ULL << 48) - 1;
  double next() {
    x = (A * x + C) & MASK;
    return (double)x / (double)(1ULL << 48);
  }
};

// exact ksort.h introsort permutation, templated on the lt comparator
// (clone of hit_introsort above; tie order is observable in SAM output)
template <class T, class LT>
void ks_introsort_t(T *a, int n, LT lt) {
  if (n < 1) return;
  auto insertsort = [&](int s, int t) {
    for (int i = s + 1; i < t; ++i)
      for (int j = i; j > s && lt(a[j], a[j - 1]); --j)
        std::swap(a[j], a[j - 1]);
  };
  auto combsort = [&](int s, int n2) -> int {
    const double shrink = 1.2473309501039786540366528676643;
    int gap = n2;
    for (;;) {
      if (gap > 2) {
        gap = (int)(gap / shrink);
        if (gap == 9 || gap == 10) gap = 11;
      }
      bool do_swap = false;
      for (int i = s; i < s + n2 - gap; ++i) {
        int j = i + gap;
        if (lt(a[j], a[i])) {
          std::swap(a[i], a[j]);
          do_swap = true;
        }
      }
      if (!(do_swap || gap > 2)) break;
    }
    return gap;
  };
  if (n == 2) {
    if (lt(a[1], a[0])) std::swap(a[0], a[1]);
    return;
  }
  int d = 2;
  while ((1 << d) < n) ++d;
  struct Frame { int s, t, d; };
  std::vector<Frame> stk;
  int s = 0, t = n - 1;
  d <<= 1;
  for (;;) {
    if (s < t) {
      if (--d == 0) {
        if (combsort(s, t - s + 1) != 1) insertsort(s, t + 1);
        t = s;
        continue;
      }
      int i = s, j = t;
      int k = i + ((j - i) >> 1) + 1;
      T rp;
      if (lt(a[k], a[i])) {
        if (lt(a[k], a[j])) k = j;
      } else {
        k = lt(a[j], a[i]) ? i : j;
      }
      rp = a[k];
      if (k != t) std::swap(a[k], a[t]);
      for (;;) {
        ++i;
        while (lt(a[i], rp)) ++i;
        --j;
        while (i <= j && lt(rp, a[j])) --j;
        if (j <= i) break;
        std::swap(a[i], a[j]);
      }
      std::swap(a[i], a[t]);
      if (i - s > t - i) {
        if (i - s > 16) stk.push_back({s, i - 1, d});
        s = (t - i > 16) ? i + 1 : t;
      } else {
        if (t - i > 16) stk.push_back({i + 1, t, d});
        t = (i - s > 16) ? i - 1 : s;
      }
    } else {
      if (stk.empty()) {
        insertsort(0, n);
        return;
      }
      Frame f = stk.back();
      stk.pop_back();
      s = f.s;
      t = f.t;
      d = f.d;
    }
  }
}

// C integer division (truncation toward zero) — sw2/aln.py idiv
static inline int64_t idiv_c(int64_t a, int64_t b) { return a / b; }

static inline int pac_at2(const uint8_t *pac, int64_t k) {
  return pac[k >> 2] >> ((~k & 3) << 1) & 3;
}

// squeeze + introsort(hitG_lt) + pairwise dedup — the idx=None branch of
// resolve_duphits (sw2/core.py:213-246 / bwtsw2_core.c:312-347)
static void dedup_hits(std::vector<Hit> &hits) {
  constexpr float MASKF = 0.90f;  // MASK_LEVEL (bwtsw2_core.c:27)
  size_t w = 0;
  for (size_t i = 0; i < hits.size(); ++i)
    if (hits[i].G) hits[w++] = hits[i];
  hits.resize(w);
  hit_introsort(hits.data(), (int)hits.size());
  const int n = (int)hits.size();
  for (int i = 1; i < n; ++i) {
    Hit *p = &hits[i];
    for (int j = 0; j < i; ++j) {
      Hit *q = &hits[j];
      bool compatible = true;
      if (p->is_rev != q->is_rev) continue;
      if (p->l == 0 && q->l == 0) {
        int64_t qol = std::min(p->end, q->end) - std::max(p->beg, q->beg);
        if (qol < 0) qol = 0;
        if ((float)qol / (float)(p->end - p->beg) > MASKF
            || (float)qol / (float)(q->end - q->beg) > MASKF) {
          int64_t tol = std::min(p->k + p->len, q->k + q->len)
                        - std::max(p->k, q->k);
          if ((double)tol / p->len > (double)MASKF
              || (double)tol / q->len > (double)MASKF)
            compatible = false;
        }
      }
      if (!compatible) {
        p->G = 0;
        if (q->G2 < p->G2) q->G2 = p->G2;
        break;
      }
    }
  }
  w = 0;
  for (size_t i = 0; i < hits.size(); ++i)
    if (hits[i].G) hits[w++] = hits[i];
  hits.resize(w);
}

struct ChainEnt {
  int64_t tbeg, tend, qbeg, qend;
  int32_t flag, idx, chain;
};

// bwtsw2_chain.c:20-46
static void chaining(int max_chain_gap, int bw, int t_seeds, int shift,
                     std::vector<ChainEnt> &z, std::vector<ChainEnt> &chain) {
  ks_introsort_t(z.data(), (int)z.size(),
                 [](const ChainEnt &a, const ChainEnt &b) {
                   return a.qbeg < b.qbeg;
                 });
  for (ChainEnt &p : z) {
    int k = (int)chain.size() - 1;
    bool found = false;
    while (k >= 0) {
      ChainEnt &q = chain[k];
      int64_t x = p.qbeg - q.qbeg;
      int64_t y = p.tbeg - q.tbeg;
      if (y > 0 && x < max_chain_gap && y < max_chain_gap && x - y <= bw
          && y - x <= bw) {
        if (p.qend > q.qend) q.qend = p.qend;
        if (p.tend > q.tend) q.tend = p.tend;
        ++q.chain;
        p.chain = shift + k;
        found = true;
        break;
      } else if (q.chain > t_seeds * 2) {
        k = 0;  // strong chain: stop scanning earlier chains
      }
      --k;
    }
    if (!found) {
      ChainEnt c = p;
      c.chain = 1;
      c.idx = p.chain = shift + (int)chain.size();
      chain.push_back(c);
    }
  }
}

// bwtsw2_chain.c:48-112 over the two strands' narrow hit sets
static void chain_filter_c(int max_chain_gap, int bw, int t_seeds,
                           int length, std::vector<Hit> *b0,
                           std::vector<Hit> *b1) {
  int thres = t_seeds * 2;
  std::vector<ChainEnt> z[2];
  std::vector<Hit> *bb[2] = {b0, b1};
  for (int k = 0; k < 2; ++k) {
    for (int i = 0; i < (int)bb[k]->size(); ++i) {
      const Hit &p = (*bb[k])[i];
      ChainEnt q;
      q.flag = k;
      q.idx = i;
      q.tbeg = p.k;
      q.tend = p.k + p.len;
      q.chain = -1;
      q.qbeg = p.beg;
      q.qend = p.end;
      z[k].push_back(q);
    }
  }
  std::vector<ChainEnt> chain0, chain1;
  chaining(max_chain_gap, bw, t_seeds, 0, z[0], chain0);
  chaining(max_chain_gap, bw, t_seeds, (int)chain0.size(), z[1], chain1);
  for (ChainEnt &p : chain1) {  // reverse strand: flip orientation
    int64_t tmp = p.qbeg;
    p.qbeg = length - p.qend;
    p.qend = length - tmp;
  }
  std::vector<ChainEnt> chains = chain0;
  chains.insert(chains.end(), chain1.begin(), chain1.end());
  std::vector<uint8_t> flag(chains.size(), 0);
  ks_introsort_t(chains.data(), (int)chains.size(),
                 [](const ChainEnt &a, const ChainEnt &b) {
                   return a.qbeg < b.qbeg;
                 });
  for (int k = 1; k < (int)chains.size(); ++k) {
    const ChainEnt &p = chains[k];
    for (int j = 0; j < k; ++j) {
      const ChainEnt &q = chains[j];
      if (flag[q.idx]) continue;
      if (q.qend >= p.qend && q.chain > (int64_t)p.chain * thres
          && p.chain < thres) {
        flag[p.idx] = 1;
        break;
      }
    }
  }
  for (int k = 0; k < 2; ++k)
    for (const ChainEnt &zz : z[k])
      if (flag[zz.chain]) (*bb[k])[zz.idx].G = 0;
  for (int k = 0; k < 2; ++k) {
    size_t w = 0;
    for (size_t i = 0; i < bb[k]->size(); ++i)
      if ((*bb[k])[i].G) (*bb[k])[w++] = (*bb[k])[i];
    bb[k]->resize(w);
  }
}

}  // namespace

extern "C" {

// Full native aln1 for one read.  seq0/seq1: forward / revcomp codes.
// rows_out: 10-int64 Hit records; returns count, -1 if cap_out too small
// (caller restores *rng_state and retries), -2 on core error.
int64_t bsw2_aln1_run(const uint8_t *g_inter, int64_t g_seq_len,
                      int64_t g_primary, const int64_t *g_L2,
                      const int64_t *ssa, int32_t sa_intv,
                      const uint8_t *pac, const uint8_t *seq0,
                      const uint8_t *seq1, int32_t l, int32_t a,
                      int32_t b_pen, int32_t q_pen, int32_t r_pen,
                      int32_t t_thres, int32_t z_best, int32_t is_intv,
                      int32_t bw, int32_t t_seeds, int32_t max_chain_gap,
                      double mask_level, uint64_t *rng_state,
                      int64_t *rows_out, int64_t cap_out) {
  const int64_t l_pac = g_seq_len >> 1;
  // ---- raw DAG core + SA-expansion/dedup (reusing the verified entries)
  std::vector<int64_t> out_b((size_t)2 * l * 10, 0);
  int64_t cap1 = std::max(4 * l, 256);
  std::unique_ptr<int64_t[]> out_b1;  // write-only: one memcpy at core end
  int64_t n1;
  {
    bool first = true;
    for (;;) {
      out_b1.reset(new int64_t[(size_t)cap1 * 10]);  // uninitialized
      if (!first) std::fill(out_b.begin(), out_b.end(), 0);
      first = false;
      n1 = bsw2_core_run(g_inter, g_seq_len, g_primary, g_L2, seq0, l, a,
                         b_pen, q_pen, r_pen, t_thres, z_best, is_intv, bw,
                         out_b.data(), out_b1.get(), cap1);
      if (n1 == -1) { cap1 *= 4; continue; }
      if (n1 < 0) return -2;
      break;
    }
  }
  auto resolve_rows = [&](const int64_t *rows, int64_t n,
                          std::vector<Hit> &out) -> bool {
    int64_t cap = std::max<int64_t>(4 * n + 64, 256);
    std::unique_ptr<int64_t[]> buf;  // write-only output of the resolve
    for (;;) {
      buf.reset(new int64_t[(size_t)cap * 10]);
      int64_t m = bsw2_resolve_duphits_rows(g_inter, g_seq_len, g_primary,
                                            g_L2, ssa, sa_intv, rows, n,
                                            is_intv, buf.get(), cap);
      if (m == -1) { cap *= 4; continue; }
      if (m < 0) return false;
      out.resize((size_t)m);
      std::memcpy(out.data(), buf.get(), (size_t)m * sizeof(Hit));
      return true;
    }
  };
  std::vector<Hit> B, B1;
  if (!resolve_rows(out_b.data(), 2 * l, B)) return -2;
  if (!resolve_rows(out_b1.get(), n1, B1)) return -2;

  // ---- strand split (reverse hits get read-space coordinates)
  std::vector<Hit> bb[2][2];
  std::vector<Hit> *srcs[2] = {&B, &B1};
  for (int kk = 0; kk < 2; ++kk) {
    for (Hit &h : *srcs[kk]) {
      if (h.is_rev) {
        int64_t x = h.beg;
        h.beg = l - h.end;
        h.end = l - x;
      }
      bb[h.is_rev][kk].push_back(h);
    }
  }
  chain_filter_c(max_chain_gap, bw, t_seeds, l, &bb[0][1], &bb[1][1]);

  // score matrix fill_scmat(a, b)
  int8_t mat[25];
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j)
      mat[i * 5 + j] = (i == 4 || j == 4) ? -1 : (i == j ? a : -b_pen);

  const uint8_t *seqs[2] = {seq0, seq1};
  std::vector<uint8_t> rq(l), target;
  int qle, tle, gtle, gscore, moff;
  for (int kk = 0; kk < 2; ++kk) {
    const uint8_t *query = seqs[kk];
    for (int i = 0; i < l; ++i) rq[i] = query[l - 1 - i];
    // ---- extend_left (bwtsw2_aux.c:100-134)
    std::vector<Hit> &bl = bb[kk][1];
    ks_introsort_t(bl.data(), (int)bl.size(),
                   [](const Hit &x, const Hit &y) { return x.end > y.end; });
    for (int i = 0; i < (int)bl.size(); ++i) {
      Hit &p = bl[i];
      int64_t lt = idiv_c(idiv_c(p.beg + 1, 2) * a + r_pen, r_pen) + l;
      p.n_seeds = 1;
      if (p.l || p.k == 0) continue;
      int score = 0;
      for (int j = 0; j < i; ++j) {
        Hit &q = bl[j];
        if (q.beg <= p.beg && q.k <= p.k && q.k + q.len >= p.k + p.len) {
          if (q.n_seeds < (1 << 13) - 2) ++q.n_seeds;
          ++score;
        }
      }
      if (score) continue;
      if (lt > p.k) lt = p.k;
      int64_t lo = std::max<int64_t>(p.k - lt, 1);
      int64_t tl_len = p.k - lo;
      target.resize((size_t)tl_len);
      for (int64_t j = 0; j < tl_len; ++j)
        target[j] = (uint8_t)pac_at2(pac, p.k - 1 - j);
      int sc = bt_ksw_extend2((int)p.beg, rq.data() + (l - p.beg),
                              (int)tl_len, target.data(), 5, mat, q_pen,
                              r_pen, q_pen, r_pen, bw, 0, -1, (int)p.G,
                              &qle, &tle, &gtle, &gscore, &moff);
      if (sc > p.G) {
        p.G = sc;
        p.k -= tle;
        p.len += tle;
        p.beg -= qle;
      }
    }
    // merge narrow into wide (no flip), dedup
    std::vector<Hit> &bw0 = bb[kk][0];
    bw0.insert(bw0.end(), bl.begin(), bl.end());
    bl.clear();
    dedup_hits(bw0);
    // ---- extend_rght (bwtsw2_aux.c:136-170)
    for (Hit &p : bw0) {
      int64_t lt = idiv_c(idiv_c(l - p.beg + 1, 2) * a + r_pen, r_pen) + l;
      if (p.l) continue;
      int64_t hi = std::min(p.k + lt, l_pac);
      int64_t tl_len = hi - p.k;
      target.resize((size_t)tl_len);
      for (int64_t j = 0; j < tl_len; ++j)
        target[j] = (uint8_t)pac_at2(pac, p.k + j);
      int sc = bt_ksw_extend2((int)(l - p.beg), query + p.beg, (int)tl_len,
                              target.data(), 5, mat, q_pen, r_pen, q_pen,
                              r_pen, bw, 0, -1, 1, &qle, &tle, &gtle,
                              &gscore, &moff);
      sc -= 1;
      if (sc >= p.G) {
        p.G = sc;
        p.len = tle;
        p.end = p.beg + qle;
      }
    }
    dedup_hits(bw0);
  }
  // merge reverse-orientation hits (flip + flag 0x10)
  for (Hit &h : bb[1][0]) {
    int64_t x = h.beg;
    h.beg = l - h.end;
    h.end = l - x;
    h.flag |= 0x10;
    bb[0][0].push_back(h);
  }
  bb[1][0].clear();

  // ---- resolve_query_overlaps (bwtsw2_core.c:349-398)
  std::vector<Hit> &hits = bb[0][0];
  Drand48 rng{*rng_state};
  if (!hits.empty()) {
    hit_introsort(hits.data(), (int)hits.size());
    int64_t G0 = hits[0].G;
    int i = 1;
    while (i < (int)hits.size() && hits[i].G == G0) ++i;
    int j = (int)(i * rng.next());
    if (j) std::swap(hits[0], hits[j]);
    float mask_f = (float)mask_level;
    int n = (int)hits.size();
    int stop = n;
    for (int i2 = 1; i2 < n; ++i2) {
      Hit &p = hits[i2];
      if (p.G == 0) { stop = i2; break; }
      bool all_compatible = true;
      for (int j2 = 0; j2 < i2; ++j2) {
        Hit &q = hits[j2];
        if (q.G == 0) continue;
        int64_t tol = 0;
        int64_t qol = std::min(p.end, q.end) - std::max(p.beg, q.beg);
        if (qol < 0) qol = 0;
        if (p.l == 0 && q.l == 0) {
          tol = std::min(p.k + p.len, q.k + q.len) - std::max(p.k, q.k);
          if (tol < 0) tol = 0;
        }
        float fol = (float)qol
                    / (float)std::min(p.end - p.beg, q.end - q.beg);
        bool compatible = (fol < mask_f
                           || (tol > 0 && qol < p.end - p.beg
                               && qol < q.end - q.beg));
        if (!compatible) {
          if (q.G2 < p.G) q.G2 = p.G;
          all_compatible = false;
        }
      }
      if (!all_compatible) p.G = 0;
    }
    std::vector<Hit> keep;
    for (int i2 = 0; i2 < stop; ++i2)
      if (hits[i2].G) keep.push_back(hits[i2]);
    hits = std::move(keep);
  }
  if ((int64_t)hits.size() > cap_out) return -(int64_t)hits.size() - 10;
  std::memcpy(rows_out, hits.data(), hits.size() * sizeof(Hit));
  *rng_state = rng.x;
  return (int64_t)hits.size();
}

}  // extern "C"

// ---------------------------------------------------------------------
// Batch SAM finish: write_aux + update_mate_aux + print_hits for a whole
// batch in one call (bwtsw2_aux.c:399-543).  The per-hit banded-global
// CIGAR runs through bt_gen_cigar2 (memfin.cpp); everything else --
// contig-boundary cigar fixing, the float32 mapQ accumulator, PE mate
// bookkeeping and the SAM text itself -- is assembled here so the Python
// caller makes ONE native call per batch instead of per-hit string work
// (measured ~0.26 s of batch Python vs the oracle's ~0.1 s of ksprintf
// on the 512x2kb bench).  sw2/aln.py write_aux/print_hits stay as the
// executable spec (BWA_TPU_SW2_FINISH=python).
// ---------------------------------------------------------------------

extern "C" int bt_gen_cigar2(const uint8_t *pac, int64_t l_pac, int32_t a,
                             int32_t b, int32_t q_pen, int32_t r_pen,
                             int32_t w_, int32_t l_query,
                             const uint8_t *query, int64_t rb, int64_t re,
                             uint32_t *cigar_out, int32_t cigar_cap,
                             int32_t *n_cigar_out, int32_t *nm_out,
                             char *md_out, int32_t md_cap,
                             int32_t *score_out);

namespace sw2fin {

// hit flags (bwtsw2.h:9-12)
constexpr int FLAG_MATESW = 0x100;
constexpr int FLAG_TANDEM = 0x200;

// IUPAC complement for raw SAM SEQ bytes (nt_comp_table, bwtsw2_aux.c:32-49)
static const char *NT_COMP =
    "NNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNN"
    "NTVGHNNCDNNMNKNN"
    "NNYSANBWXRNNNNNN"
    "ntvghnncdnnmnknn"
    "nnysanbwxrnNNNNN";  // indices 128-255 are 'N' (handled in comp())

static inline char comp(uint8_t c) { return c < 128 ? NT_COMP[c] : 'N'; }

struct FHit {  // row layout of bsw2_aln1_run / _hit_from_row
  int64_t k, l, flag, n_seeds, len, G, G2, beg, end, is_rev;
};

struct CigOp { int op; int64_t ln; };

struct FAux {  // bsw2aux_t (bwtsw2.h:29-32), calloc semantics
  int flag = 0, nn = 0, chr = 0, qual = 0, mchr = 0, pqual = 0, nm = 0;
  int64_t pos = 0, mpos = 0, isize = 0;
  bool has_cigar = false;
  std::vector<CigOp> cig;
};

struct Bnt {
  const int64_t *ctg_off, *ctg_len;
  const char *names; const int64_t *name_off; int32_t n_ctg;
  const int64_t *hole_off, *hole_len; int32_t n_holes;

  int pos2rid(int64_t pos_f, int64_t l_pac) const {
    if (pos_f >= l_pac) return -1;
    // searchsorted(offsets, pos_f, 'right') - 1
    const int64_t *p = std::upper_bound(ctg_off, ctg_off + n_ctg, pos_f);
    return (int)(p - ctg_off) - 1;
  }

  int64_t cnt_ambi(int64_t pos_f, int64_t length) const {
    // bntseq.c:380-401 -- stops at the first overlapping hole
    int32_t left = 0, right = n_holes;
    int64_t nn = 0;
    while (left < right) {
      int32_t mid = (left + right) >> 1;
      int64_t ho = hole_off[mid], hl = hole_len[mid];
      if (pos_f >= ho + hl) left = mid + 1;
      else if (pos_f + length <= ho) right = mid;
      else {
        if (pos_f >= ho)
          nn += (ho + hl < pos_f + length) ? ho + hl - pos_f : length;
        else
          nn += (ho + hl < pos_f + length) ? hl : length - (ho - pos_f);
        break;
      }
    }
    return nn;
  }
};

// Split an alignment crossing a contig boundary (bwtsw2_aux.c:326-397).
static void fix_cigar(const Bnt &bnt, FHit &p, std::vector<CigOp> &cigar,
                      int64_t l_pac) {
  int seqid = bnt.pos2rid(p.k, l_pac);
  int64_t coor = p.k - bnt.ctg_off[seqid];
  int64_t refl = bnt.ctg_len[seqid];
  int64_t x = coor, y = 0;
  for (const CigOp &c : cigar) {
    if (c.op == 1 || c.op == 4 || c.op == 5) y += c.ln;
    else if (c.op == 2) x += c.ln;
    else { x += c.ln; y += c.ln; }
  }
  int64_t lq = y;
  if (x <= refl) return;
  // runs off the end of the contig: split
  size_t nc = 0;
  int64_t mq[2] = {0, 0}, nlen[2] = {0, 0}, kk = 0;
  std::vector<CigOp> cn;
  x = coor; y = 0;
  for (const CigOp &c : cigar) {
    if (c.op == 4 || c.op == 5 || c.op == 1) {
      y += c.ln;
      cn.push_back(c);
    } else if (c.op == 2) {
      if (x + c.ln >= refl && nc == 0) {
        cn.push_back({4, lq - y});
        nc = cn.size();
        cn.push_back({4, y});
        kk = p.k + (x + c.ln - refl);
        nlen[0] = x - coor;
        nlen[1] = p.len - nlen[0] - c.ln;
      } else {
        cn.push_back({2, c.ln});
      }
      x += c.ln;
    } else if (c.op == 0) {
      if (x + c.ln >= refl && nc == 0) {
        cn.push_back({0, refl - x});
        cn.push_back({4, lq - y - (refl - x)});
        nc = cn.size();
        mq[0] += refl - x;
        cn.push_back({4, y + (refl - x)});
        if (x + c.ln - refl) cn.push_back({0, x + c.ln - refl});
        mq[1] += x + c.ln - refl;
        kk = bnt.ctg_off[seqid] + refl;
        nlen[0] = refl - coor;
        nlen[1] = p.len - nlen[0];
      } else {
        cn.push_back({0, c.ln});
        mq[nc ? 1 : 0] += c.ln;
      }
      x += c.ln;
      y += c.ln;
    }
  }
  if (mq[0] > mq[1]) {  // take the first part
    p.len = nlen[0];
    cigar.assign(cn.begin(), cn.begin() + nc);
  } else {
    p.k = kk;
    p.len = nlen[1];
    cigar.assign(cn.begin() + nc, cn.end());
  }
}

static inline void app_i64(std::string &s, int64_t v) {
  char b[24];
  int n = snprintf(b, sizeof b, "%lld", (long long)v);
  s.append(b, n);
}

}  // namespace sw2fin

extern "C" {

// Returns total SAM bytes written to out, or -(needed) when out_cap is
// too small (caller retries with the exact size).  hit_rows: 10-int64
// records per hit in bsw2_aln1_run layout; hit_off[n_reads+1].
// qual/comment blobs use zero-length spans for "absent".
int64_t bsw2_finish_batch(
    const uint8_t *pac, int64_t l_pac,
    const int64_t *ctg_off, const int64_t *ctg_len, const char *ctg_names,
    const int64_t *ctg_name_off, int32_t n_ctg,
    const int64_t *hole_off, const int64_t *hole_len, int32_t n_holes,
    int32_t a, int32_t b_pen, int32_t q_pen, int32_t r_pen,
    int32_t hard_clip, int32_t multi_2nd, int32_t cpy_cmt, int32_t is_pe,
    const int32_t *t_arr, const int32_t *bw_arr,
    int32_t n_reads,
    const uint8_t *seq_blob, const int64_t *seq_off,
    const uint8_t *codes_blob,
    const uint8_t *qual_blob, const int64_t *qual_off,
    const char *name_blob, const int64_t *name_off,
    const char *cmt_blob, const int64_t *cmt_off,
    const int64_t *hit_rows, const int64_t *hit_off,
    char *out, int64_t out_cap) {
  using namespace sw2fin;
  Bnt bnt{ctg_off, ctg_len, ctg_names, ctg_name_off, n_ctg,
          hole_off, hole_len, n_holes};

  // mutable copies of the hits (fix_cigar updates k/len; the mate pass
  // reads them afterwards, exactly like the in-place Python spec)
  std::vector<std::vector<FHit>> hits(n_reads);
  std::vector<std::vector<FAux>> aux(n_reads);
  int64_t max_lq = 1;
  for (int32_t i = 0; i < n_reads; ++i) {
    int64_t h0 = hit_off[i], h1 = hit_off[i + 1];
    hits[i].resize((size_t)(h1 - h0));
    std::memcpy(hits[i].data(), hit_rows + 10 * h0,
                (size_t)(h1 - h0) * sizeof(FHit));
    aux[i].resize((size_t)(h1 - h0));
    max_lq = std::max(max_lq, seq_off[i + 1] - seq_off[i]);
  }

  // shared CIGAR/MD scratch (per-batch; exact retry for odd matrices)
  int32_t cig_cap = (int32_t)(3 * max_lq + 16);
  std::vector<uint32_t> cigbuf((size_t)cig_cap);
  std::vector<char> mdbuf((size_t)(6 * cig_cap + 16));
  std::vector<uint8_t> rcbuf((size_t)max_lq);

  // ---- write_aux for every read (bwtsw2_aux.c:399-436) ----
  for (int32_t i = 0; i < n_reads; ++i) {
    int64_t lq = seq_off[i + 1] - seq_off[i];
    const uint8_t *codes = codes_blob + seq_off[i];
    for (int64_t j = 0; j < lq; ++j) rcbuf[j] = (uint8_t)(3 - codes[lq - 1 - j]);
    int32_t t = t_arr[i], bw = bw_arr[i];
    for (size_t hx = 0; hx < hits[i].size(); ++hx) {
      FHit &p = hits[i][hx];
      FAux &q = aux[i][hx];
      if (p.l == 0) {  // gen_cigar (bwtsw2_aux.c:173-212)
        int64_t beg = (p.flag & 0x10) ? lq - p.end : p.beg;
        int64_t end = (p.flag & 0x10) ? lq - p.beg : p.end;
        const uint8_t *query = ((p.flag & 0x10) ? rcbuf.data() : codes) + beg;
        int32_t nc = 0, nm = 0, sc = 0;
        int rc = bt_gen_cigar2(pac, l_pac, a, b_pen, q_pen, r_pen, bw,
                               (int32_t)(end - beg), query, p.k, p.k + p.len,
                               cigbuf.data(), cig_cap, &nc, &nm,
                               mdbuf.data(), (int32_t)mdbuf.size(), &sc);
        const uint32_t *cu = cigbuf.data();
        std::vector<uint32_t> big;
        if (rc < 0) {  // shared buffer too small: exact retry
          int32_t cap2 = (int32_t)((end - beg) + p.len + 8);
          big.resize((size_t)cap2);
          std::vector<char> md2((size_t)(6 * cap2 + 16));
          rc = bt_gen_cigar2(pac, l_pac, a, b_pen, q_pen, r_pen, bw,
                             (int32_t)(end - beg), query, p.k, p.k + p.len,
                             big.data(), cap2, &nc, &nm, md2.data(),
                             (int32_t)md2.size(), &sc);
          if (rc < 0) return -1;  // cannot happen: exact capacity
          cu = big.data();
        }
        if (rc == 0) {
          q.has_cigar = false;
          q.nm = -1;
        } else {
          q.has_cigar = true;
          q.nm = nm;
          q.cig.clear();
          q.cig.reserve((size_t)nc + 2);
          for (int32_t c = 0; c < nc; ++c)
            q.cig.push_back({(int)(cu[c] & 0xF), (int64_t)(cu[c] >> 4)});
          if (!q.cig.empty() && (beg != 0 || end < lq)) {  // soft clips
            if (beg != 0) q.cig.insert(q.cig.begin(), {4, beg});
            if (end < lq) q.cig.push_back({4, lq - end});
          }
        }
      }
      q.flag = (int)(p.flag & 0xfe);
      q.isize = 0;
      if (p.l == 0) {  // unique hit
        if (q.has_cigar && !q.cig.empty()) fix_cigar(bnt, p, q.cig, l_pac);
        // mapQ (bwtsw2_aux.c:423-429); c accumulates in float32
        int64_t subo = p.G2 > t ? p.G2 : t;
        float c = 1.0f;
        if ((p.flag >> 16) == 1 || (p.flag >> 16) == 2)
          c = (float)((double)c * 0.5);
        if (p.n_seeds < 2) c = (float)((double)c * 0.2);
        int64_t qual = (int64_t)((double)c * (double)(p.G - subo)
                                 * (250.0 / (double)p.G + 0.03 / (double)a)
                                 + 0.499);
        if (qual > 250) qual = 250;
        if (qual < 0) qual = 0;
        if (p.flag & 1) qual = 0;  // randomly-picked repetitive hit
        q.qual = (int)qual;
        q.pqual = (int)qual;
        q.chr = bnt.pos2rid(p.k, l_pac);
        q.nn = (int)bnt.cnt_ambi(p.k, p.len);
        // chr == -1 cannot occur for a unique hit (k < l_pac), but the
        // Python spec's contigs[-1] would index the LAST contig -- keep
        // the same semantics rather than UB
        q.pos = p.k - ctg_off[q.chr >= 0 ? q.chr : n_ctg - 1];
      } else {
        q.qual = 0;
        q.nn = 0;
        q.chr = -1;
        q.pos = -1;
        q.has_cigar = false;
        q.cig.clear();
      }
    }
  }

  // ---- update_mate_aux (bwtsw2_aux.c:438-473) ----
  if (is_pe) {
    for (int32_t x = 0; x < n_reads; ++x) {
      std::vector<FHit> &bh = hits[x];
      std::vector<FAux> &ba = aux[x];
      std::vector<FHit> &mh = hits[x ^ 1];
      std::vector<FAux> &ma = aux[x ^ 1];
      for (size_t i = 0; i < bh.size(); ++i) {
        FAux &q = ba[i];
        q.flag |= 1;
        if (mh.empty()) q.flag |= 8;
        if (mh.size() == 1) {
          q.mchr = ma[0].chr;
          q.mpos = ma[0].pos;
          if (ma[0].flag & 0x10) q.flag |= 0x20;
          if (q.chr == q.mchr) {
            if (q.mpos + mh[0].len > q.pos)
              q.isize = q.mpos + mh[0].len - q.pos;
            else
              q.isize = q.mpos - q.pos - bh[0].len;
          } else {
            q.isize = 0;
          }
        } else if (mh.size() > 1) {
          q.mchr = -1;
          q.mpos = -1;
        }
      }
      if (bh.size() == 1 && mh.size() == 1) {
        FHit &p = bh[0];
        if (p.flag & FLAG_MATESW) {
          if (!(p.flag & FLAG_TANDEM) && ba[0].pqual < 20) ba[0].pqual = 20;
          if (ba[0].pqual >= ma[0].qual) ba[0].pqual = ma[0].qual;
        } else if ((p.flag & 2) && !((int64_t)mh[0].flag & FLAG_MATESW)) {
          if (!(p.flag & FLAG_TANDEM)) {
            ba[0].pqual += 20;
            if (ba[0].pqual > ma[0].qual) ba[0].pqual = ma[0].qual;
            if (ba[0].pqual < ba[0].qual) ba[0].pqual = ba[0].qual;
          }
        }
      }
    }
  }

  // ---- print_hits (bwtsw2_aux.c:477-543) ----
  std::string s;
  s.reserve((size_t)(n_reads * (max_lq * 2 + 192)));
  const char *tbl = hard_clip ? "MIDNHHP" : "MIDNSHP";
  for (int32_t x = 0; x < n_reads; ++x) {
    const char *name = name_blob + name_off[x];
    int64_t name_len = name_off[x + 1] - name_off[x];
    const uint8_t *seq = seq_blob + seq_off[x];
    int64_t lq = seq_off[x + 1] - seq_off[x];
    const uint8_t *qual = qual_blob + qual_off[x];
    int64_t lqual = qual_off[x + 1] - qual_off[x];
    if (hits[x].empty()) {
      s.append(name, (size_t)name_len);
      s.append("\t4\t*\t0\t0\t*\t*\t0\t0\t");
      s.append((const char *)seq, (size_t)lq);
      s.push_back('\t');
      if (lqual) s.append((const char *)qual, (size_t)lqual);
      else s.push_back('*');
      s.push_back('\n');
    }
    for (size_t i = 0; i < hits[x].size(); ++i) {
      FHit &p = hits[x][i];
      FAux &q = aux[x][i];
      int hit_type = 0;
      if (!q.has_cigar) q.flag |= 0x4;
      int flag = q.flag | ((multi_2nd && i) ? 0x100 : 0);
      s.append(name, (size_t)name_len);
      s.push_back('\t');
      app_i64(s, flag);
      s.push_back('\t');
      if (q.chr >= 0)
        s.append(ctg_names + ctg_name_off[q.chr],
                 (size_t)(ctg_name_off[q.chr + 1] - ctg_name_off[q.chr] - 1));
      else
        s.push_back('*');
      s.push_back('\t');
      app_i64(s, q.pos + 1);
      if (p.l == 0 && q.has_cigar) {
        s.push_back('\t');
        app_i64(s, q.pqual);
        s.push_back('\t');
        for (const CigOp &c : q.cig) {
          app_i64(s, c.ln);
          s.push_back(tbl[c.op]);
        }
      } else {
        s.append("\t0\t*");
      }
      if (!is_pe) {
        s.append("\t*\t0\t0\t");
      } else {
        s.push_back('\t');
        if (q.mchr == q.chr) s.push_back('=');
        else if (q.mchr < 0) s.push_back('*');
        else
          s.append(ctg_names + ctg_name_off[q.mchr],
                   (size_t)(ctg_name_off[q.mchr + 1]
                            - ctg_name_off[q.mchr] - 1));
        s.push_back('\t');
        app_i64(s, q.mpos + 1);
        s.push_back('\t');
        app_i64(s, q.isize);
        s.push_back('\t');
      }
      int64_t beg = 0, end = lq;
      if (hard_clip && q.has_cigar && !q.cig.empty()) {
        if (q.cig.front().op == 4) beg += q.cig.front().ln;
        if (q.cig.back().op == 4) end -= q.cig.back().ln;
      }
      if (p.flag & 0x10) {
        for (int64_t j = lq - beg - 1; j >= lq - end; --j)
          s.push_back(comp(seq[j]));
      } else {
        s.append((const char *)seq + beg, (size_t)(end - beg));
      }
      if (lqual) {
        s.push_back('\t');
        if (p.flag & 0x10)
          for (int64_t j = lq - beg - 1; j >= lq - end; --j)
            s.push_back((char)qual[j]);
        else
          s.append((const char *)qual + beg, (size_t)(end - beg));
      } else {
        s.append("\t*");
      }
      s.append("\tAS:i:");
      app_i64(s, p.G);
      s.append("\tXS:i:");
      app_i64(s, p.G2);
      s.append("\tXF:i:");
      app_i64(s, p.flag >> 16);
      s.append("\tXE:i:");
      app_i64(s, p.n_seeds);
      s.append("\tNM:i:");
      app_i64(s, q.nm);
      if (q.nn) {
        s.append("\tXN:i:");
        app_i64(s, q.nn);
      }
      if (p.l) {
        s.append("\tXI:i:");
        app_i64(s, p.l - p.k + 1);
      }
      if (p.flag & FLAG_MATESW) hit_type |= 1;
      if (p.flag & FLAG_TANDEM) hit_type |= 2;
      if (hit_type) {
        s.append("\tXT:i:");
        app_i64(s, hit_type);
      }
      int64_t cl = cmt_off[x + 1] - cmt_off[x];
      if (cpy_cmt && cl >= 6) {
        const char *cmt = cmt_blob + cmt_off[x];
        if (cmt[2] == ':' && cmt[4] == ':') {
          s.push_back('\t');
          s.append(cmt, (size_t)cl);
        }
      }
      s.push_back('\n');
    }
  }
  if ((int64_t)s.size() > out_cap) return -(int64_t)s.size();
  std::memcpy(out, s.data(), s.size());
  return (int64_t)s.size();
}

}  // extern "C"
