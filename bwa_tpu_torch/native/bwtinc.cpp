// Bounded-memory BWT construction for big genomes.
//
// The reference builds GRCh38 with an incremental blockwise BWT
// (bwt_bwtgen2 / BWTIncConstructFromPacked, bwt_gen.c:1292-1638: QSufSort
// block sorts + rank merge) precisely because a full suffix array does
// not fit: our in-place 64-bit SA-IS peaks at ~10 bytes/char (63 GB at
// the 6.2e9-char doubled text).  This file provides the same
// bounded-memory property with a different, simpler-to-verify algorithm:
//
//   dynamic-BWT right-to-left insertion, batched per block.
//
// State: the BWT "rows model" of the current suffix T[h:] — stored
// chars in the reference's interleaved occ layout (per 128 chars: 4
// int64 counts + 8 uint32 words = one 64-byte line) plus the primary
// (the charless full-suffix row).  Inserting the next suffix c·T[h:]:
//
//   rank(c·S) = 1 + C[c] + Occ_c(rows < primary)        (LF step)
//
// computed over (immutable old structure + this block's pending
// inserts).  Pending inserts live in a counted B+-tree ordered by
// combined row coordinate with per-char subtree counts, so each insert
// and each Occ decomposition is O(log b) over high-fanout nodes.  At
// block end one linear pass merges old chars + pending into a fresh
// interleaved buffer and rebuilds the checkpoints.  Peak memory =
// 2 interleaved buffers (~n/2 bytes each) + the packed input text
// (n/4) + O(block) tree nodes — ~9-10 GB at GRCh38 vs 63 GB for the
// full SA, with byte-identical output (tests/test_index.py fuzzes it
// against the SA-IS path).
//
// The companion bwt_sa_walk derives the sampled .sa (and the dense
// sidecar when requested) from the finished BWT by the inverse-Psi
// chain (bwt_cal_sa, bwt.c:70-84), since no suffix array ever exists.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "occ64.h"

namespace {

// 2-bit packed char access (.pac convention: base i at byte i>>2,
// bits (~i & 3) * 2 — bntseq.h:76 _get_pac)
static inline int pac_at(const uint8_t *p, int64_t i) {
  return (p[i >> 2] >> ((~i & 3) << 1)) & 3;
}

// ---- interleaved stored-char stream (the .bwt layout) ----
// count of base c among the FIRST s stored chars (prefix-exclusive; no
// primary/row logic — that belongs to the caller)
static inline int64_t occ_prefix(const uint8_t *inter, int64_t s, int c) {
  if (s <= 0) return 0;
  int64_t blk = s >> 7;
  int within = (int)(s & 127);
  const int64_t *cp = (const int64_t *)(inter + blk * 64);
  int64_t acc = cp[c];
  if (within) {
    const uint32_t *w = (const uint32_t *)(inter + blk * 64 + 32);
    int kw = (within - 1) >> 5, kb = (within - 1) & 31;
    uint64_t want_hi = (c & 2) ? ~0ull : 0ull;
    uint64_t want_lo = (c & 1) ? ~0ull : 0ull;
    for (int i = 0; i <= kw; ++i) {
      uint64_t mask2 = (i < kw) ? ~0ull : occ64::keep_top(kb + 1);
      uint64_t word = occ64::wpair(w, i) & mask2;
      uint64_t vm = mask2 & occ64::VM55;
      uint64_t hi = (word >> 1) & occ64::VM55, lo = word & occ64::VM55;
      acc += __builtin_popcountll((hi ^ ~want_hi) & (lo ^ ~want_lo) & vm);
    }
  }
  return acc;
}

struct Writer {  // streaming writer of the interleaved layout
  uint8_t *buf;
  int64_t cap_blocks = 0;  // buffer capacity in 64-byte blocks
  int64_t n = 0;          // chars emitted
  int64_t cnt[4] = {0, 0, 0, 0};
  uint32_t word = 0;
  void start_block() {
    int64_t blk = n >> 7;
    int64_t *cp = (int64_t *)(buf + blk * 64);
    for (int c = 0; c < 4; ++c) cp[c] = cnt[c];
  }
  inline void put(int c) {
    if ((n & 127) == 0) start_block();
    word = (word << 2) | (uint32_t)c;
    ++cnt[c];
    ++n;
    if ((n & 15) == 0) {
      int64_t blk = (n - 1) >> 7;
      uint32_t *w = (uint32_t *)(buf + blk * 64 + 32);
      w[((n - 1) >> 4) & 7] = word;
      word = 0;
    }
  }
  void finish() {  // flush the ragged tail word (left-aligned like
    if (n == 0) return;
    // when the stream ends exactly on a 128-char boundary, the NEXT
    // block's checkpoint must still be written: occ_prefix(cur, s, c)
    // with s == n reads it (s is a block multiple -> within == 0), and
    // the ping-pong buffer holds a stale round's bytes there otherwise
    if ((n & 127) == 0 && (n >> 7) < cap_blocks) start_block();
    int64_t blk = (n - 1) >> 7;
    uint32_t *w = (uint32_t *)(buf + blk * 64 + 32);
    if (n & 15)  // pack_bwt_words: base i at bits (15-(i&15))*2
      w[((n - 1) >> 4) & 7] = word << ((16 - (n & 15)) << 1);
    word = 0;
    // zero the unused word slots of the last block: the buffers
    // ping-pong across rounds, and the final output is byte-compared
    // with the SA-IS path's zero-padded interleave (interleave_bwt)
    for (int i = (int)((((n - 1) >> 4) & 7) + 1); i < 8; ++i) w[i] = 0;
  }
};

// ---- pending-insert counted B+-tree (combined row order) ----
//
// Replaces a treap: the per-char hot path is 3-4 tree descents over a
// pool far larger than cache, and a binary treap pays one DRAM miss per
// LEVEL (~23 at block=10M).  A high-fanout counted B+-tree is ~5 levels
// of sequentially-scanned nodes, and the three logical operations per
// inserted char collapse into ONE descent:
//   * insert_dollar(p) computes (n, per-char counts) before p on the
//     way down — exactly what the NEXT iteration's count_before needs
//     (nothing mutates the tree in between), so the query is cached;
//   * the element assign_char targets is always the $ placed by the
//     previous insert, so the insert records its leaf path and the
//     assign walks that path instead of re-descending.
//
// Elements store (gap, ch) where gap = absolute number of OLD rows
// before the element; combined coordinate of element j = gap_j + j.
// Coordinates are strictly increasing, hence gaps are nondecreasing.
// ch in 0..3 counts toward cnt[]; ch = 4 is the pending $ (uncounted,
// at most one alive at a time).

constexpr int LEAF_CAP = 48;  // elements per leaf
constexpr int INT_CAP = 16;   // children per internal node
constexpr int MAX_DEPTH = 16;

struct Leaf {
  int64_t gap[LEAF_CAP];
  int8_t ch[LEAF_CAP];
  int16_t n;
};

struct Inner {
  int64_t last_gap[INT_CAP];  // gap of each child's LAST element
  int32_t child[INT_CAP];
  int32_t n[INT_CAP];         // elements per child subtree
  int32_t cnt[INT_CAP][4];    // assigned chars per child subtree
  int16_t nc;                 // children
  int16_t leaf_kids;          // children are leaves?
};

struct BTree {
  std::vector<Leaf> leaves;
  std::vector<Inner> inners;
  int32_t root = 0;    // inner id, or leaf id when root_leaf
  bool root_leaf = true;
  int64_t n_elems = 0;
  // path of the last-inserted $ (assign_last_dollar walks it)
  int32_t path_node[MAX_DEPTH];
  int16_t path_slot[MAX_DEPTH];
  int path_len = 0;         // inner levels on the path
  int32_t dollar_leaf = -1;
  int16_t dollar_idx = 0;

  void reset() {
    leaves.clear();
    inners.clear();
    root = 0;
    root_leaf = true;
    n_elems = 0;
    path_len = 0;
    dollar_leaf = -1;
  }

  // Pre-size the node pools for `block` elements: split-born leaves run
  // ~half..3/4 full, so LEAF_CAP/2 is the safe per-leaf floor.  Without
  // this the vectors' doubling growth can overshoot the high-water mark
  // by up to 2x — real gigabytes at GRCh38 block sizes.
  void reserve_for(int64_t block) {
    leaves.reserve((size_t)(block / (LEAF_CAP / 2)) + 16);
    inners.reserve((size_t)(block / ((int64_t)(LEAF_CAP / 2) *
                                     (INT_CAP / 2))) + 16);
  }

  static int64_t leaf_last_gap(const Leaf &l) { return l.gap[l.n - 1]; }
  int64_t node_last_gap(int32_t id, bool is_leaf) const {
    if (is_leaf) return leaf_last_gap(leaves[id]);
    const Inner &x = inners[id];
    return x.last_gap[x.nc - 1];
  }

  int32_t new_leaf() {
    leaves.emplace_back();
    leaves.back().n = 0;
    return (int32_t)leaves.size() - 1;
  }
  int32_t new_inner() {
    inners.emplace_back();
    inners.back().nc = 0;
    return (int32_t)inners.size() - 1;
  }

  // split full child k of inner x (child arrays may reallocate!)
  void split_child(int32_t xi, int k) {
    Inner &x0 = inners[xi];
    bool leaf_kids = x0.leaf_kids;
    int32_t cid = x0.child[k];
    int32_t nid;
    int32_t mv_n = 0, mv_cnt[4] = {0, 0, 0, 0};
    int64_t left_last, right_last;
    if (leaf_kids) {
      nid = new_leaf();  // may realloc leaves
      Leaf &a = leaves[cid];
      Leaf &b = leaves[nid];
      int half = a.n / 2;
      b.n = (int16_t)(a.n - half);
      std::memcpy(b.gap, a.gap + half, sizeof(int64_t) * b.n);
      std::memcpy(b.ch, a.ch + half, sizeof(int8_t) * b.n);
      a.n = (int16_t)half;
      mv_n = b.n;
      for (int j = 0; j < b.n; ++j)
        if (b.ch[j] < 4) ++mv_cnt[b.ch[j]];
      left_last = leaf_last_gap(a);
      right_last = leaf_last_gap(b);
    } else {
      nid = new_inner();  // may realloc inners
      Inner &a = inners[cid];
      Inner &b = inners[nid];
      int half = a.nc / 2;
      b.nc = (int16_t)(a.nc - half);
      b.leaf_kids = a.leaf_kids;
      for (int j = 0; j < b.nc; ++j) {
        b.child[j] = a.child[half + j];
        b.n[j] = a.n[half + j];
        b.last_gap[j] = a.last_gap[half + j];
        for (int c = 0; c < 4; ++c) b.cnt[j][c] = a.cnt[half + j][c];
        mv_n += b.n[j];
        for (int c = 0; c < 4; ++c) mv_cnt[c] += b.cnt[j][c];
      }
      a.nc = (int16_t)half;
      left_last = a.last_gap[a.nc - 1];
      right_last = b.last_gap[b.nc - 1];
    }
    Inner &x = inners[xi];  // re-ref after potential inner realloc
    for (int j = x.nc; j > k + 1; --j) {
      x.child[j] = x.child[j - 1];
      x.n[j] = x.n[j - 1];
      x.last_gap[j] = x.last_gap[j - 1];
      for (int c = 0; c < 4; ++c) x.cnt[j][c] = x.cnt[j - 1][c];
    }
    ++x.nc;
    x.child[k + 1] = nid;
    x.n[k + 1] = mv_n;
    x.last_gap[k + 1] = right_last;
    x.n[k] -= mv_n;
    x.last_gap[k] = left_last;
    for (int c = 0; c < 4; ++c) {
      x.cnt[k + 1][c] = mv_cnt[c];
      x.cnt[k][c] -= mv_cnt[c];
    }
  }

  // Insert the pending $ so that exactly `p` combined rows precede it.
  // Returns via (nb_out, cnt_out) the pending elements strictly before
  // coordinate p and their per-char counts == count_before(p), and
  // records the new element's path for assign_last_dollar.
  void insert_dollar(int64_t p, int64_t *nb_out, int64_t cnt_out[4]) {
    if (leaves.empty()) {
      root = new_leaf();
      root_leaf = true;
    }
    // grow the root if full (preemptive split needs a non-full parent)
    if (root_leaf) {
      int32_t lid = root;
      if (leaves[lid].n == LEAF_CAP) {
        int32_t ri = new_inner();
        Inner &r = inners[ri];
        r.nc = 1;
        r.leaf_kids = 1;
        r.child[0] = lid;
        r.n[0] = (int32_t)leaves[lid].n;
        r.last_gap[0] = leaf_last_gap(leaves[lid]);
        int32_t cc[4] = {0, 0, 0, 0};
        for (int j = 0; j < leaves[lid].n; ++j)
          if (leaves[lid].ch[j] < 4) ++cc[leaves[lid].ch[j]];
        for (int c = 0; c < 4; ++c) r.cnt[0][c] = cc[c];
        split_child(ri, 0);
        root = ri;
        root_leaf = false;
      }
    } else if (inners[root].nc == INT_CAP) {
      int32_t ri = new_inner();
      Inner &r = inners[ri];
      Inner &old = inners[root];
      r.nc = 1;
      r.leaf_kids = 0;
      r.child[0] = root;
      int32_t tn = 0, tc[4] = {0, 0, 0, 0};
      for (int j = 0; j < old.nc; ++j) {
        tn += old.n[j];
        for (int c = 0; c < 4; ++c) tc[c] += old.cnt[j][c];
      }
      r.n[0] = tn;
      r.last_gap[0] = old.last_gap[old.nc - 1];
      for (int c = 0; c < 4; ++c) r.cnt[0][c] = tc[c];
      split_child(ri, 0);
      root = ri;
    }

    int64_t acc_n = 0;  // elements before the current subtree
    int64_t cc[4] = {0, 0, 0, 0};
    path_len = 0;
    int32_t lid = root;
    int32_t x = root_leaf ? -1 : root;
    while (x >= 0) {  // inner levels
      Inner &nx = inners[x];
      int k = 0;
      // first child whose last coord >= p (else the last child)
      while (k < nx.nc - 1) {
        int64_t last_coord = nx.last_gap[k] + acc_n + nx.n[k] - 1;
        if (last_coord >= p) break;
        acc_n += nx.n[k];
        for (int c = 0; c < 4; ++c) cc[c] += nx.cnt[k][c];
        ++k;
      }
      // preemptive split of a full child keeps this a single pass
      bool child_full = nx.leaf_kids
                            ? leaves[nx.child[k]].n == LEAF_CAP
                            : inners[nx.child[k]].nc == INT_CAP;
      if (child_full) {
        split_child(x, k);
        Inner &nx2 = inners[x];
        int64_t last_coord = nx2.last_gap[k] + acc_n + nx2.n[k] - 1;
        if (last_coord < p) {
          acc_n += nx2.n[k];
          for (int c = 0; c < 4; ++c) cc[c] += nx2.cnt[k][c];
          ++k;
        }
      }
      Inner &nx3 = inners[x];
      ++nx3.n[k];  // the new element lands in this subtree
      path_node[path_len] = x;
      path_slot[path_len] = (int16_t)k;
      ++path_len;
      int32_t ch = nx3.child[k];
      if (nx3.leaf_kids) {
        lid = ch;
        break;
      }
      x = ch;
    }
    Leaf &lf = leaves[lid];
    int j = 0;
    while (j < lf.n && lf.gap[j] + acc_n + j < p) {
      if (lf.ch[j] < 4) ++cc[lf.ch[j]];
      ++j;
    }
    int64_t nb = acc_n + j;
    std::memmove(lf.gap + j + 1, lf.gap + j, sizeof(int64_t) * (lf.n - j));
    std::memmove(lf.ch + j + 1, lf.ch + j, sizeof(int8_t) * (lf.n - j));
    lf.gap[j] = p - nb;
    lf.ch[j] = 4;
    ++lf.n;
    ++n_elems;
    dollar_leaf = lid;
    dollar_idx = (int16_t)j;
    // refresh last_gap up the path (the new element may be the last)
    for (int d = path_len - 1; d >= 0; --d) {
      Inner &nx = inners[path_node[d]];
      int k = path_slot[d];
      nx.last_gap[k] = nx.leaf_kids
                           ? leaf_last_gap(leaves[nx.child[k]])
                           : inners[nx.child[k]]
                                 .last_gap[inners[nx.child[k]].nc - 1];
    }
    *nb_out = nb;
    for (int c = 0; c < 4; ++c) cnt_out[c] = cc[c];
  }

  // assign char c to the $ placed by the previous insert_dollar
  void assign_last_dollar(int c) {
    leaves[dollar_leaf].ch[dollar_idx] = (int8_t)c;
    for (int d = 0; d < path_len; ++d)
      ++inners[path_node[d]].cnt[path_slot[d]][c];
  }

  // in-order traversal -> (gap, ch) stream
  void inorder(std::vector<std::pair<int64_t, int8_t>> *out) const {
    out->clear();
    out->reserve((size_t)n_elems);
    if (n_elems == 0) return;
    struct Fr {
      int32_t id;  // inner id or ~leaf id
      int k;
    };
    std::vector<Fr> st;
    st.push_back({root_leaf ? ~root : root, 0});
    while (!st.empty()) {
      Fr &f = st.back();
      if (f.id < 0) {
        const Leaf &lf = leaves[~f.id];
        for (int j = 0; j < lf.n; ++j)
          out->push_back({lf.gap[j], lf.ch[j]});
        st.pop_back();
        continue;
      }
      const Inner &nx = inners[f.id];
      if (f.k >= nx.nc) {
        st.pop_back();
        continue;
      }
      int32_t ch = nx.child[f.k];
      ++f.k;
      st.push_back({nx.leaf_kids ? ~ch : ch, 0});
    }
  }
};

}  // namespace

extern "C" {

// Incremental bounded-memory BWT over the 2-bit packed doubled text.
// inter_out must hold ceil((n+127)/128)*64 bytes (wait: ceil(n/128)*64).
// Returns the primary row; cnt_out[4] receives the char counts (L2
// deltas).  block = chars merged per round (memory/merge-traffic knob).
int64_t bwt_inc_build(const uint8_t *pac2, int64_t n, int64_t block,
                      uint8_t *inter_out, int64_t *cnt_out) {
  int64_t n_blk_bytes = ((n + 127) / 128) * 64;
  std::vector<uint8_t> other(n_blk_bytes);
  // ping-pong: cur = current stored structure, nxt = merge target
  uint8_t *cur = other.data(), *nxt = inter_out;
  int64_t m = 0;           // current stored chars (= length of T[h:])
  int64_t primary = 0;     // current $ row (rows model)
  int64_t C[5] = {0, 0, 0, 0, 0};  // cumulative: C[c] = #chars < c
  int64_t cnt[4] = {0, 0, 0, 0};
  BTree tree;
  tree.reserve_for(block < n ? block : n);
  std::vector<std::pair<int64_t, int8_t>> pend;
  pend.reserve((size_t)(block < n ? block : n) + 1);

  int64_t h = n;
  while (h > 0) {
    int64_t s = h - block;
    if (s < 0) s = 0;
    tree.reset();
    int64_t old_primary = primary;
    int64_t old_m = m;
    int dollar_patch = -1;     // char assigned to the old $ row
    int64_t dollar_coord = primary;  // combined row coord of current $
    bool dollar_is_old = true;
    // count_before(dollar_coord) over the pending structure: the tree
    // is empty at round start, and after each insert_dollar(rank) it
    // equals the counts that insert computed on its way down (nothing
    // mutates the tree in between, and the $ itself sits AT rank, not
    // before it) — so the query result is carried, never re-descended.
    int64_t nb_c = 0, pc_c[4] = {0, 0, 0, 0};
    for (int64_t i = h - 1; i >= s; --i) {
      int c = pac_at(pac2, i);
      // rank(c·S) = 1 + C[c] + Occ_c(rows < dollar_coord), over the
      // combined (old + pending) structure
      int64_t k_old = dollar_coord - nb_c;  // old rows before $
      // old rows -> old stored chars (+ patched old $ row)
      int64_t stored = k_old - (k_old > old_primary ? 1 : 0);
      int64_t occv = occ_prefix(cur, stored, c) + pc_c[c];
      if (dollar_patch == c && k_old > old_primary) ++occv;
      int64_t rank = 1 + C[c] + occv;
      // the current $ row gains char c ...
      if (dollar_is_old) {
        dollar_patch = c;
        dollar_is_old = false;
      } else {
        tree.assign_last_dollar(c);
      }
      ++cnt[c];
      for (int cc = c + 1; cc < 4; ++cc) ++C[cc];
      // ... and the new $ row appears at `rank`
      tree.insert_dollar(rank, &nb_c, pc_c);
      dollar_coord = rank;
      ++m;
      // hide next iteration's occ_prefix DRAM miss behind this one's
      // remaining work (k_old/stored for the next step are known now)
      if (i > s) {
        int64_t k2 = rank - nb_c;
        int64_t s2 = k2 - (k2 > old_primary ? 1 : 0);
        if (s2 > 0) __builtin_prefetch(cur + (s2 >> 7) * 64);
      }
    }
    // merge old + pending into nxt
    tree.inorder(&pend);
    Writer w;
    w.buf = nxt;
    w.cap_blocks = n_blk_bytes / 64;
    size_t pi = 0;
    for (int64_t r = 0; r <= old_m; ++r) {  // old rows incl old $
      while (pi < pend.size() && pend[pi].first == r) {
        if (pend[pi].second < 4) w.put(pend[pi].second);
        ++pi;
      }
      if (r == old_primary) {
        if (dollar_patch >= 0) w.put(dollar_patch);
      } else if (r < old_m + 1) {
        int64_t stored = r - (r > old_primary ? 1 : 0);
        if (stored < old_m) {
          // read old stored char `stored`
          const uint32_t *ww =
              (const uint32_t *)(cur + (stored >> 7) * 64 + 32);
          int cch = (ww[(stored >> 4) & 7] >>
                     ((15 - (stored & 15)) << 1)) & 3;
          w.put(cch);
        }
      }
    }
    while (pi < pend.size()) {  // gap == old_m + 1 (after every old row)
      if (pend[pi].second < 4) w.put(pend[pi].second);
      ++pi;
    }
    w.finish();
    primary = dollar_coord;
    h = s;
    uint8_t *t = cur;
    cur = nxt;
    nxt = t;
  }
  if (cur != inter_out) std::memcpy(inter_out, cur, n_blk_bytes);
  for (int c = 0; c < 4; ++c) cnt_out[c] = cnt[c];
  return primary;
}

// Sampled .sa (+ optional dense sidecar) from the finished BWT by the
// inverse-Psi chain (bwt_cal_sa, bwt.c:70-84): row 0 is the empty
// suffix (SA value n); each inv_psi step moves to the one-shorter
// suffix position.  samples[k] = SA value of row k*intv (samples[0]
// ends up n; the file writer skips it, matching bwt_dump_sa).
void bwt_sa_walk(const uint8_t *inter, int64_t n, int64_t primary,
                 const int64_t *L2, int32_t intv, int64_t *samples,
                 int64_t *sad_or_null) {
  occ64::View g{inter, n, primary, L2};
  int64_t isa = 0, sa_val = n;
  for (int64_t i = 0; i <= n; ++i) {
    if ((isa % intv) == 0) samples[isa / intv] = sa_val;
    if (sad_or_null) sad_or_null[isa] = sa_val;
    if (i == n) break;
    isa = occ64::inv_psi(g, isa);
    --sa_val;
  }
}

}  // extern "C"
