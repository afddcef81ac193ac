// Fully-native one-shot drivers for `aln`, `samse` and `sampe`.
//
// The Python CLI path pays interpreter + import startup (~0.15 s) that
// dwarfs the oracle's whole runtime on warm small-genome one-shots, so
// the native client (client.c) calls bt_cli_main() here first: index
// load (.bwt/.sa/.pac/.ann/.amb -> the occ64 interleaved layout of
// index/fmindex.py), strict-FASTQ intake (txtutil.cpp), the batch
// search (btgap.cpp bt_aln_batch) and the samse/sampe finalizers
// (btsam.cpp) -- no Python at all.  Anything this front end does not
// support byte-exactly (BAM input, gzip, stdin, barcodes, Illumina-1.3
// quals, non-strict FASTQ, missing index files) returns FALLBACK and
// the client execs the Python CLI, which remains the executable spec
// (the aln, sampe and cli modules of the JAX package).
//
// Reference parity anchors: bwtaln.c:159-228 (aln main loop), bwase.c:507-
// 577 (samse), bwape.c:624-731 (sampe), bwa.c:407-441 (SAM header).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "occ64.h"

namespace {

constexpr int FALLBACK = 100;  // client.c execs the Python CLI on this
constexpr int64_t CHUNK = 0x40000;  // reads per batch (aln CHUNK)

// ---- native entry points from the other translation units ----
extern "C" {
int64_t bt_fastq_parse(const uint8_t *, int64_t, int64_t, int32_t, int32_t,
                       uint8_t *, int64_t *, int32_t *, int32_t *, uint8_t *,
                       int64_t *, uint8_t *, int64_t *, int64_t *, int32_t *);
int64_t bt_aln_batch(const uint8_t *, int64_t, int64_t, const int64_t *,
                     const uint8_t *, const int64_t *, int32_t,
                     const int32_t *, const int32_t *, const int32_t *,
                     int32_t, int32_t, int32_t, int32_t, int32_t, int32_t,
                     int32_t, int32_t, int32_t, int32_t, int32_t *,
                     int64_t *, int64_t);
int64_t bt_samse_batch(const uint8_t *, int64_t, int64_t, const int64_t *,
                       const int64_t *, int32_t, const uint8_t *, int64_t,
                       const int64_t *, const int32_t *, const int32_t *,
                       const char *, int32_t, const int64_t *,
                       const int32_t *, int32_t, int32_t, const uint8_t *,
                       const int64_t *, const int32_t *, const int32_t *,
                       const int32_t *, const uint8_t *, const int64_t *,
                       const char *, const int64_t *, const char *,
                       const int32_t *, const uint8_t *, int64_t, int32_t,
                       int32_t, int32_t, int32_t, double, const char *,
                       uint64_t *, char *, int64_t, int64_t *,
                       const void *, int32_t);
int64_t bt_sampe_batch(
    const uint8_t *, int64_t, int64_t, const int64_t *, const int64_t *,
    int32_t, const uint8_t *, int64_t, const int64_t *, const int32_t *,
    const int32_t *, const char *, int32_t, const int64_t *, const int32_t *,
    int32_t, int32_t,
    const uint8_t *, const int64_t *, const int32_t *, const int32_t *,
    const int32_t *, const uint8_t *, const int64_t *, const char *,
    const int64_t *, const char *, const int32_t *,
    const uint8_t *, const int64_t *, const int32_t *, const int32_t *,
    const int32_t *, const uint8_t *, const int64_t *, const char *,
    const int64_t *, const char *, const int32_t *,
    const uint8_t *, int64_t, const uint8_t *, int64_t,
    int32_t, int32_t, int32_t, int32_t, int32_t, double, int32_t, int32_t,
    int32_t, int32_t, int32_t, int32_t, double, int32_t, double *,
    const char *, uint64_t *, char *, int64_t, int64_t *,
    const void *, int32_t);
}

// ---------------------------------------------------------------------
// gap_opt_t twin of aln/opts.py GapOpt: the raw 64-byte .sai header
// struct ("<7if8i").
// ---------------------------------------------------------------------
struct GapOpt {
  int32_t s_mm = 3, s_gapo = 11, s_gape = 4;
  int32_t mode = 0x01 | 0x02;  // GAPE | COMPREAD
  int32_t indel_end_skip = 5, max_del_occ = 10, max_entries = 2000000;
  float fnr = 0.04f;
  int32_t max_diff = -1, max_gapo = 1, max_gape = 6, max_seed_diff = 2;
  int32_t seed_len = 32, n_threads = 1, max_top2 = 30, trim_qual = 0;
};
static_assert(sizeof(GapOpt) == 64, "GapOpt must match the .sai layout");

// bwa_cal_maxdiff (bwtaln.c:42-54) with the reference's int factorial
// wraparound (see btsam.cpp / aln/opts.py for the full rationale)
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

// ---------------------------------------------------------------------
// Index load: the exact inverse of index/build.py's writers, producing
// the fmindex.py occ_inter interleaved blocks directly (the on-disk
// .bwt stream already IS [8xckpt u32 || 8xwords u32] rows; only the
// ragged final block needs padding).
// ---------------------------------------------------------------------
struct Idx {
  std::vector<uint8_t> inter;
  int64_t seq_len = 0, primary = 0, l_pac = 0, seed = 11;
  int64_t L2[5] = {0, 0, 0, 0, 0};
  std::vector<int64_t> ssa;
  int32_t sa_intv = 32;
  std::vector<uint8_t> pac;
  std::vector<int64_t> ctg_off;
  std::vector<int32_t> ctg_len;
  std::vector<int32_t> name_off;
  std::string names_blob;
  std::vector<std::string> names;
  std::vector<int64_t> amb_off;
  std::vector<int32_t> amb_len;
  std::vector<uint8_t> sad_raw;   // .sad.npy bytes (dense SA sidecar)
  const void *sad = nullptr;      // points into sad_raw, or null
  int32_t sad_is64 = 0;
};

static bool read_file(const std::string &p, std::vector<uint8_t> *out) {
  FILE *f = std::fopen(p.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize((size_t)n);
  bool ok = n == 0 || std::fread(out->data(), 1, (size_t)n, f) == (size_t)n;
  std::fclose(f);
  return ok;
}

static bool file_exists(const std::string &p) {
  FILE *f = std::fopen(p.c_str(), "rb");
  if (f) std::fclose(f);
  return f != nullptr;
}

// minimal .npy v1/v2 reader for the dense-SA sidecar ('<i4'/'<i8' 1-D);
// mmaps the file (it can be GBs on mid-size genomes; only the ranks the
// batch actually resolves get paged in).  The mapping is intentionally
// leaked -- the one-shot process exits right after.
static bool load_sad(const std::string &path, std::vector<uint8_t> *raw,
                     const void **data, int32_t *is64) {
  (void)raw;
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 10) {
    ::close(fd);
    return false;
  }
  uint8_t *m = (uint8_t *)mmap(nullptr, (size_t)st.st_size, PROT_READ,
                               MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) return false;
  bool ok = false;
  size_t hlen = 0, hoff = 0;
  if (std::memcmp(m, "\x93NUMPY", 6) == 0) {
    if (m[6] == 1) {
      hlen = (size_t)m[8] | ((size_t)m[9] << 8);
      hoff = 10;
    } else if (st.st_size >= 12) {
      hlen = (size_t)m[8] | ((size_t)m[9] << 8) | ((size_t)m[10] << 16) |
             ((size_t)m[11] << 24);
      hoff = 12;
    }
    if (hoff && (size_t)st.st_size >= hoff + hlen) {
      std::string hdr((const char *)m + hoff, hlen);
      if (hdr.find("'fortran_order': False") != std::string::npos) {
        if (hdr.find("'<i8'") != std::string::npos) {
          *is64 = 1;
          ok = true;
        } else if (hdr.find("'<i4'") != std::string::npos) {
          *is64 = 0;
          ok = true;
        }
      }
    }
  }
  if (!ok) {
    munmap(m, (size_t)st.st_size);
    return false;
  }
  *data = m + hoff + hlen;
  return true;
}

// bwt_only: `aln` needs nothing but the occ blocks -- skip .sa/.pac/
// .ann/.amb/.sad (tens of MB of wasted reads per one-shot otherwise)
static bool load_idx(std::string prefix, Idx *x, bool bwt_only = false) {
  if (file_exists(prefix + ".64.bwt")) prefix += ".64";  // bwa.c:245-269
  std::vector<uint8_t> bwt;
  if (!read_file(prefix + ".bwt", &bwt) || bwt.size() < 40) return false;
  const uint64_t *head = (const uint64_t *)bwt.data();
  x->primary = (int64_t)head[0];
  x->L2[0] = 0;
  for (int i = 1; i < 5; ++i) x->L2[i] = (int64_t)head[i];
  x->seq_len = x->L2[4];
  x->l_pac = x->seq_len >> 1;
  const uint32_t *data = (const uint32_t *)(bwt.data() + 40);
  int64_t n_data = (int64_t)(bwt.size() - 40) / 4;
  int64_t n_words = (x->seq_len + 15) / 16;
  int64_t n_blocks = (x->seq_len + 127) / 128;
  int64_t body = n_words + n_blocks * 8;
  if (n_data != body + 8) return false;  // + trailing checkpoint
  x->inter.assign((size_t)n_blocks * 64, 0);
  int64_t full = body / 16;  // complete 16-word [ckpt||words] rows
  std::memcpy(x->inter.data(), data, (size_t)full * 64);
  if (full < n_blocks)  // ragged final block: pad the missing words
    std::memcpy(x->inter.data() + full * 64, data + full * 16,
                (size_t)(body - full * 16) * 4);
  if (bwt_only) return true;

  if (!load_sad(prefix + ".sad.npy", &x->sad_raw, &x->sad, &x->sad_is64)) {
    x->sad = nullptr;  // optional: the walk path serves without it
    x->sad_raw.clear();
  }
  std::vector<uint8_t> sa;
  if (!read_file(prefix + ".sa", &sa) || sa.size() < 64) return false;
  const uint64_t *sh = (const uint64_t *)sa.data();
  if ((int64_t)sh[0] != x->primary) return false;
  x->sa_intv = (int32_t)sh[5];
  if ((int64_t)sh[6] != x->seq_len) return false;
  int64_t n_sa = (x->seq_len + x->sa_intv) / x->sa_intv;
  if ((int64_t)sa.size() < 56 + (n_sa - 1) * 8) return false;
  x->ssa.resize(n_sa);
  x->ssa[0] = -1;  // bwt.c:437: rank 0 is poisoned
  std::memcpy(x->ssa.data() + 1, sa.data() + 56, (size_t)(n_sa - 1) * 8);

  if (!read_file(prefix + ".pac", &x->pac)) return false;
  if ((int64_t)x->pac.size() < x->l_pac / 4 + 1) return false;
  x->pac.resize((size_t)(x->l_pac / 4 + 1));

  // .ann (bns_restore, bntseq.c:97-211)
  FILE *f = std::fopen((prefix + ".ann").c_str(), "r");
  if (!f) return false;
  long l_pac_ann = 0, n_seqs = 0, seed = 0;
  if (std::fscanf(f, "%ld %ld %ld", &l_pac_ann, &n_seqs, &seed) != 3 ||
      l_pac_ann != x->l_pac) {
    std::fclose(f);
    return false;
  }
  x->seed = seed;
  char name[4096];
  for (long i = 0; i < n_seqs; ++i) {
    long gi = 0, off = 0, len = 0, n_ambs = 0;
    if (std::fscanf(f, "%ld %4095s", &gi, name) != 2) {
      std::fclose(f);
      return false;
    }
    int c = std::fgetc(f);  // rest of the name line = annotation
    while (c != '\n' && c != EOF) c = std::fgetc(f);
    if (std::fscanf(f, "%ld %ld %ld", &off, &len, &n_ambs) != 3) {
      std::fclose(f);
      return false;
    }
    x->names.emplace_back(name);
    x->name_off.push_back((int32_t)x->names_blob.size());
    x->names_blob += name;
    x->names_blob += '\0';
    x->ctg_off.push_back(off);
    x->ctg_len.push_back((int32_t)len);
  }
  std::fclose(f);
  f = std::fopen((prefix + ".amb").c_str(), "r");
  if (!f) return false;
  long amb_lpac = 0, amb_nseq = 0, n_holes = 0;
  if (std::fscanf(f, "%ld %ld %ld", &amb_lpac, &amb_nseq, &n_holes) != 3) {
    std::fclose(f);
    return false;
  }
  for (long i = 0; i < n_holes; ++i) {
    long off = 0, len = 0;
    char ch[8];
    if (std::fscanf(f, "%ld %ld %7s", &off, &len, ch) != 3) {
      std::fclose(f);
      return false;
    }
    x->amb_off.push_back(off);
    x->amb_len.push_back((int32_t)len);
  }
  std::fclose(f);
  return true;
}

// ---------------------------------------------------------------------
// Strict-FASTQ batch intake over a whole in-memory file.
// ---------------------------------------------------------------------
struct Packed {
  int64_t n = 0;
  std::vector<uint8_t> codes;
  std::vector<int64_t> codes_off;
  std::vector<int32_t> lens, full_lens, clip_lens;
  std::vector<uint8_t> quals;
  std::vector<int64_t> qual_off;
  std::vector<uint8_t> names;
  std::vector<int64_t> name_off;
  std::vector<uint8_t> bc_blob;
  std::vector<int32_t> bc_off;
};

struct FqStream {
  std::vector<uint8_t> buf;
  int64_t pos = 0;
  bool done() const { return pos >= (int64_t)buf.size(); }
};

// returns false -> not strict FASTQ: caller must FALLBACK (no output
// has been produced yet by design)
static bool next_batch(FqStream *st, int32_t trim_qual, Packed *pk) {
  int64_t want = CHUNK;
  int64_t ln = (int64_t)st->buf.size() - st->pos;
  pk->n = 0;
  if (ln <= 0) return true;
  pk->codes.resize(ln);
  pk->codes_off.assign(want + 1, 0);
  pk->lens.resize(want);
  pk->full_lens.resize(want);
  pk->names.resize(ln);
  pk->name_off.assign(want + 1, 0);
  pk->quals.resize(ln);
  pk->qual_off.assign(want + 1, 0);
  int64_t consumed = 0;
  int32_t ok = 0;
  int64_t n = bt_fastq_parse(st->buf.data() + st->pos, ln, want,
                             /*eof=*/1, trim_qual, pk->codes.data(),
                             pk->codes_off.data(), pk->lens.data(),
                             pk->full_lens.data(), pk->names.data(),
                             pk->name_off.data(), pk->quals.data(),
                             pk->qual_off.data(), &consumed, &ok);
  if (!ok) return false;
  st->pos += consumed;
  pk->n = n;
  pk->clip_lens.assign(pk->lens.begin(), pk->lens.begin() + n);
  pk->bc_blob.assign((size_t)n, 0);
  pk->bc_off.resize(n);
  for (int64_t i = 0; i < n; ++i) pk->bc_off[i] = (int32_t)i;
  return true;
}

static bool load_fq(const char *path, FqStream *st) {
  if (std::strcmp(path, "-") == 0) return false;  // stdin: Python path
  if (!read_file(path, &st->buf)) return false;
  if (st->buf.size() >= 2 && st->buf[0] == 0x1f && st->buf[1] == 0x8b)
    return false;  // gzip: Python path (kopen)
  return true;
}

// ---------------------------------------------------------------------
// SAM header (bwa_print_sam_hdr, bwa.c:407-441 / cli.py _hdr_lines)
// ---------------------------------------------------------------------
static std::string unescape(const char *s) {
  std::string out;
  for (const char *p = s; *p; ++p) {
    if (p[0] == '\\' && p[1] == 't') {
      out += '\t';
      ++p;
    } else if (p[0] == '\\' && p[1] == 'n') {
      out += '\n';
      ++p;
    } else {
      out += *p;
    }
  }
  return out;
}

static std::string hdr_lines(const Idx &x, const std::string &rg_line,
                             const char *cmd) {
  int n_hd = 0, n_sq = 0;
  if (!rg_line.empty()) {
    size_t p = 0;
    while (p <= rg_line.size()) {
      if (rg_line.compare(p, 4, "@HD\t") == 0) ++n_hd;
      if (rg_line.compare(p, 4, "@SQ\t") == 0) ++n_sq;
      size_t nl = rg_line.find('\n', p);
      if (nl == std::string::npos) break;
      p = nl + 1;
    }
  }
  std::string out;
  char buf[64];
  if (n_hd == 0) out += "@HD\tVN:1.5\tSO:unsorted\tGO:query\n";
  if (n_sq == 0)
    for (size_t i = 0; i < x.names.size(); ++i) {
      out += "@SQ\tSN:";
      out += x.names[i];
      std::snprintf(buf, sizeof buf, "\tLN:%d\n", x.ctg_len[i]);
      out += buf;
    }
  if (!rg_line.empty()) {
    out += rg_line;
    out += '\n';
  }
  out += "@PG\tID:bwa\tPN:bwa-tpu\tVN:0.1.0\tCL:bwa-tpu ";
  out += cmd;
  out += '\n';
  return out;
}

// -r handling: unescape, then rg_id = text between "\tID:" and the next
// tab/newline (cli.py main_samse)
static bool parse_rg(const char *arg, std::string *rg_line,
                     std::string *rg_id) {
  *rg_line = unescape(arg);
  size_t p = rg_line->find("\tID:");
  if (p == std::string::npos) return false;  // Python would traceback
  size_t s = p + 4, e = s;
  while (e < rg_line->size() && (*rg_line)[e] != '\t' && (*rg_line)[e] != '\n')
    ++e;
  *rg_id = rg_line->substr(s, e - s);
  return true;
}

static bool write_out(const char *out_path, const std::string &data) {
  FILE *f = out_path ? std::fopen(out_path, "wb") : stdout;
  if (!f) return false;
  bool ok = data.empty() ||
            std::fwrite(data.data(), 1, data.size(), f) == data.size();
  if (out_path) std::fclose(f);
  else std::fflush(f);
  return ok;
}

// tiny getopt replica (no permutation, ':' = takes an argument)
struct Opts {
  std::vector<std::pair<char, const char *>> flags;
  std::vector<const char *> args;
};

static bool parse_opts(int argc, char **argv, const char *spec, Opts *o) {
  int i = 0;
  for (; i < argc; ++i) {
    const char *a = argv[i];
    if (a[0] != '-' || a[1] == '\0') break;
    if (std::strcmp(a, "--") == 0) {
      ++i;
      break;
    }
    for (int k = 1; a[k]; ++k) {
      const char *sp = std::strchr(spec, a[k]);
      if (!sp) return false;  // unknown flag -> Python for the error text
      if (sp[1] == ':') {
        const char *val = a[k + 1] ? a + k + 1
                          : (i + 1 < argc ? argv[++i] : nullptr);
        if (!val) return false;
        o->flags.emplace_back(a[k], val);
        break;
      }
      o->flags.emplace_back(a[k], nullptr);
    }
  }
  for (; i < argc; ++i) o->args.push_back(argv[i]);
  return true;
}

// ---------------------------------------------------------------------
// aln (bwtaln.c:159-228; cli.py main_aln + the aln_core routine)
// ---------------------------------------------------------------------
static int cmd_aln(int argc, char **argv) {
  GapOpt opt;
  int opte = -1;
  const char *out_path = nullptr;
  Opts o;
  if (!parse_opts(argc, argv, "n:o:e:i:d:l:k:LR:m:t:NM:O:E:q:f:b012IYB:",
                  &o))
    return FALLBACK;
  for (auto &fl : o.flags) {
    const char *a = fl.second;
    switch (fl.first) {
      case 'n':
        if (std::strchr(a, '.')) {
          opt.fnr = (float)std::atof(a);
          opt.max_diff = -1;
        } else {
          opt.max_diff = std::atoi(a);
          opt.fnr = -1.0f;
        }
        break;
      case 'o': opt.max_gapo = std::atoi(a); break;
      case 'e': opte = std::atoi(a); break;
      case 'M': opt.s_mm = std::atoi(a); break;
      case 'O': opt.s_gapo = std::atoi(a); break;
      case 'E': opt.s_gape = std::atoi(a); break;
      case 'd': opt.max_del_occ = std::atoi(a); break;
      case 'i': opt.indel_end_skip = std::atoi(a); break;
      case 'l': opt.seed_len = std::atoi(a); break;
      case 'k': opt.max_seed_diff = std::atoi(a); break;
      case 'm': opt.max_entries = std::atoi(a); break;
      case 't': opt.n_threads = std::atoi(a); break;
      case 'L': opt.mode |= 0x04; break;
      case 'R': opt.max_top2 = std::atoi(a); break;
      case 'q': opt.trim_qual = std::atoi(a); break;
      case 'N':
        opt.mode |= 0x10;
        opt.max_top2 = 0x7FFFFFFF;
        break;
      case 'f': out_path = a; break;
      case 'b': case '0': case '1': case '2': case 'I': case 'B':
        return FALLBACK;  // BAM input / Illumina-1.3 / barcodes
      case 'Y': opt.mode |= 0x08; break;
      default: return FALLBACK;
    }
  }
  if (opte > 0) {
    opt.max_gape = opte;
    opt.mode &= ~0x01;
  }
  if (o.args.size() < 2) return FALLBACK;  // Python prints the usage
  Idx x;
  if (!load_idx(o.args[0], &x, /*bwt_only=*/true)) return FALLBACK;
  FqStream st;
  if (!load_fq(o.args[1], &st)) return FALLBACK;

  std::string out;
  out.append("SAI\x01", 4);
  out.append((const char *)&opt, sizeof opt);
  int64_t tot = 0;
  std::vector<int32_t> md, mg, sl;
  std::vector<uint8_t> flat;
  std::vector<int64_t> seq_off;
  std::vector<int32_t> out_n;
  // raw uninitialized record buffer: the 64-recs/read guess is ~32 MB
  // per 256k-read batch and zeroing it (vector::assign) cost 6% of the
  // whole aln CPU; fresh mmap pages are only faulted where records land
  std::unique_ptr<int64_t[]> rec;
  int64_t rec_cap = 0;
  int32_t mg_run = opt.max_gapo;  // sticky clamp (bwtaln.c:88-101)
  while (true) {
    Packed pk;
    if (!next_batch(&st, opt.trim_qual, &pk)) return FALLBACK;
    if (pk.n == 0) break;
    int64_t n = pk.n;
    // reversed reads (bwtaln.c:116-117 searches back-to-front)
    seq_off.assign(n + 1, 0);
    for (int64_t i = 0; i < n; ++i)
      seq_off[i + 1] = seq_off[i] + pk.lens[i];
    flat.resize(seq_off[n]);
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t *src = pk.codes.data() + pk.codes_off[i];
      uint8_t *dst = flat.data() + seq_off[i];
      int32_t l = pk.lens[i];
      for (int32_t j = 0; j < l; ++j) dst[j] = src[l - 1 - j];
    }
    md.resize(n);
    mg.resize(n);
    sl.resize(n);
    for (int64_t i = 0; i < n; ++i) {
      md[i] = opt.fnr > 0.0f
                  ? cal_maxdiff(pk.lens[i], 0.02, opt.fnr)
                  : opt.max_diff;
      if (md[i] < mg_run) mg_run = md[i];  // local_opt outlives the read
      mg[i] = mg_run;
      sl[i] = pk.lens[i] > opt.seed_len ? opt.seed_len : 0x7FFFFFFF;
    }
    out_n.assign(n, 0);
    int64_t cap = 64 * n > 65536 ? 64 * n : 65536;
    int64_t tot_rec;
    while (true) {
      if (cap > rec_cap) {
        rec.reset(new int64_t[cap * 8]);
        rec_cap = cap;
      }
      tot_rec = bt_aln_batch(
          x.inter.data(), x.seq_len, x.primary, x.L2, flat.data(),
          seq_off.data(), (int32_t)n, md.data(), mg.data(), sl.data(),
          opt.s_mm, opt.s_gapo, opt.s_gape, opt.max_gape,
          opt.max_seed_diff, opt.max_entries, opt.max_del_occ,
          opt.indel_end_skip, opt.max_top2, opt.mode, out_n.data(),
          rec.get(), cap);
      if (tot_rec <= cap) break;
      cap = tot_rec;
    }
    // .sai records (sai.py pack_aln1): n_aln i32 + 24B per aln
    int64_t off = 0;
    for (int64_t i = 0; i < n; ++i) {
      int32_t c = out_n[i];
      out.append((const char *)&c, 4);
      for (int32_t j = 0; j < c; ++j) {
        const int64_t *r8 = rec.get() + (off + j) * 8;
        uint64_t w = ((uint64_t)r8[0] & 0xFF) |
                     (((uint64_t)r8[1] & 0xFF) << 8) |
                     (((uint64_t)r8[2] & 0xFF) << 16) |
                     (((uint64_t)r8[3] & 0xFFFFF) << 24) |
                     (((uint64_t)r8[4] & 0x3FF) << 44) |
                     (((uint64_t)r8[5] & 0x3FF) << 54);
        uint64_t kl[3] = {w, (uint64_t)r8[6], (uint64_t)r8[7]};
        out.append((const char *)kl, 24);
      }
      off += c;
    }
    tot += n;
    std::fprintf(stderr, "[bwa_aln_core] %ld sequences have been "
                         "processed.\n", (long)tot);
  }
  return write_out(out_path, out) ? 0 : 1;
}

// ---------------------------------------------------------------------
// samse (bwase.c:507-577; the samse_core routine)
// ---------------------------------------------------------------------
static int cmd_samse(int argc, char **argv) {
  int n_occ = 3;
  const char *out_path = nullptr;
  std::string rg_line, rg_id;
  Opts o;
  if (!parse_opts(argc, argv, "hn:f:r:", &o)) return FALLBACK;
  for (auto &fl : o.flags) {
    switch (fl.first) {
      case 'n': n_occ = std::atoi(fl.second); break;
      case 'f': out_path = fl.second; break;
      case 'r':
        if (!parse_rg(fl.second, &rg_line, &rg_id)) return FALLBACK;
        break;
      default: return FALLBACK;
    }
  }
  if (o.args.size() < 3) return FALLBACK;
  Idx x;
  if (!load_idx(o.args[0], &x)) return FALLBACK;
  std::vector<uint8_t> sai;
  if (!read_file(o.args[1], &sai) || sai.size() < 4 + sizeof(GapOpt) ||
      std::memcmp(sai.data(), "SAI\x01", 4) != 0)
    return FALLBACK;
  GapOpt opt;
  std::memcpy(&opt, sai.data() + 4, sizeof opt);
  if (opt.mode & (0x20 | 0x200 | (0xFF << 24))) return FALLBACK;
  FqStream st;
  if (!load_fq(o.args[2], &st)) return FALLBACK;

  std::string out = hdr_lines(x, rg_line, "samse");
  uint64_t rng = (((uint64_t)(x.seed & 0xFFFFFFFF)) << 16) | 0x330E;
  const uint8_t *sp = sai.data() + 4 + sizeof(GapOpt);
  int64_t srem = (int64_t)sai.size() - 4 - (int64_t)sizeof(GapOpt);
  while (true) {
    Packed pk;
    if (!next_batch(&st, opt.trim_qual, &pk)) return FALLBACK;
    if (pk.n == 0) break;
    int64_t cap = 300 * pk.n > (1 << 20) ? 300 * pk.n : (1 << 20);
    std::vector<char> buf;
    int64_t used = 0;
    uint64_t rng_in = rng;
    int64_t r;
    while (true) {
      buf.resize(cap);
      rng = rng_in;
      r = bt_samse_batch(
          x.inter.data(), x.seq_len, x.primary, x.L2, x.ssa.data(),
          x.sa_intv, x.pac.data(), x.l_pac, x.ctg_off.data(),
          x.ctg_len.data(), x.name_off.data(), x.names_blob.data(),
          (int32_t)x.names.size(), x.amb_off.data(), x.amb_len.data(),
          (int32_t)x.amb_off.size(), (int32_t)pk.n, pk.codes.data(),
          pk.codes_off.data(), pk.lens.data(), pk.full_lens.data(),
          pk.clip_lens.data(), pk.quals.data(), pk.qual_off.data(),
          (const char *)pk.names.data(), pk.name_off.data(),
          (const char *)pk.bc_blob.data(), pk.bc_off.data(), sp, srem,
          opt.mode, opt.max_top2, n_occ, opt.max_diff, (double)opt.fnr,
          rg_id.empty() ? nullptr : rg_id.c_str(), &rng, buf.data(), cap,
          &used, x.sad, x.sad_is64);
      if (r >= 0) break;
      if (r == -1) return FALLBACK;  // truncated .sai
      cap = -r;
    }
    sp += used;
    srem -= used;
    out.append(buf.data(), (size_t)r);
  }
  return write_out(out_path, out) ? 0 : 1;
}

// ---------------------------------------------------------------------
// sampe (bwape.c:624-731; aln/sampe.py sampe_core)
// ---------------------------------------------------------------------
static int cmd_sampe(int argc, char **argv) {
  int max_isize = 500, force_isize = 0, max_occ = 100000, n_multi = 3;
  int N_multi = 10, is_sw = 1;
  double ap_prior = 1e-5;
  const char *out_path = nullptr;
  std::string rg_line, rg_id;
  Opts o;
  if (!parse_opts(argc, argv, "a:o:sPn:N:c:f:Ar:", &o)) return FALLBACK;
  for (auto &fl : o.flags) {
    switch (fl.first) {
      case 'a': max_isize = std::atoi(fl.second); break;
      case 'o': max_occ = std::atoi(fl.second); break;
      case 's': is_sw = 0; break;
      case 'P': break;  // preload: no-op here, the index IS loaded
      case 'n': n_multi = std::atoi(fl.second); break;
      case 'N': N_multi = std::atoi(fl.second); break;
      case 'c': ap_prior = std::atof(fl.second); break;
      case 'f': out_path = fl.second; break;
      case 'A': force_isize = 1; break;
      case 'r':
        if (!parse_rg(fl.second, &rg_line, &rg_id)) return FALLBACK;
        break;
      default: return FALLBACK;
    }
  }
  if (o.args.size() < 5) return FALLBACK;
  Idx x;
  if (!load_idx(o.args[0], &x)) return FALLBACK;
  std::vector<uint8_t> sai0b, sai1b;
  GapOpt opt0, opt;
  if (!read_file(o.args[1], &sai0b) || sai0b.size() < 4 + sizeof(GapOpt) ||
      std::memcmp(sai0b.data(), "SAI\x01", 4) != 0)
    return FALLBACK;
  if (!read_file(o.args[2], &sai1b) || sai1b.size() < 4 + sizeof(GapOpt) ||
      std::memcmp(sai1b.data(), "SAI\x01", 4) != 0)
    return FALLBACK;
  std::memcpy(&opt0, sai0b.data() + 4, sizeof opt0);
  std::memcpy(&opt, sai1b.data() + 4, sizeof opt);
  if ((opt0.mode | opt.mode) & (0x20 | 0x200 | (0xFF << 24)))
    return FALLBACK;
  FqStream st0, st1;
  if (!load_fq(o.args[3], &st0) || !load_fq(o.args[4], &st1))
    return FALLBACK;

  std::string out = hdr_lines(x, rg_line, "sampe");
  uint64_t rng = (((uint64_t)(x.seed & 0xFFFFFFFF)) << 16) | 0x330E;
  double ii_state[6] = {0.0, 0.0, 0.0, -1.0, -1.0, 0.0};
  const uint8_t *sp0 = sai0b.data() + 4 + sizeof(GapOpt);
  int64_t srem0 = (int64_t)sai0b.size() - 4 - (int64_t)sizeof(GapOpt);
  const uint8_t *sp1 = sai1b.data() + 4 + sizeof(GapOpt);
  int64_t srem1 = (int64_t)sai1b.size() - 4 - (int64_t)sizeof(GapOpt);
  while (true) {
    Packed pk0, pk1;
    if (!next_batch(&st0, opt0.trim_qual, &pk0)) return FALLBACK;
    if (pk0.n == 0) break;
    if (!next_batch(&st1, opt.trim_qual, &pk1)) return FALLBACK;
    if (pk1.n != pk0.n) return FALLBACK;
    int64_t cap = 600 * pk0.n > (1 << 20) ? 600 * pk0.n : (1 << 20);
    std::vector<char> buf;
    int64_t used[2] = {0, 0};
    uint64_t rng_in = rng;
    double ii_in[6];
    std::memcpy(ii_in, ii_state, sizeof ii_in);
    int32_t quiet = 0;
    int64_t r;
    while (true) {
      buf.resize(cap);
      rng = rng_in;
      std::memcpy(ii_state, ii_in, sizeof ii_in);
      r = bt_sampe_batch(
          x.inter.data(), x.seq_len, x.primary, x.L2, x.ssa.data(),
          x.sa_intv, x.pac.data(), x.l_pac, x.ctg_off.data(),
          x.ctg_len.data(), x.name_off.data(), x.names_blob.data(),
          (int32_t)x.names.size(), x.amb_off.data(), x.amb_len.data(),
          (int32_t)x.amb_off.size(), (int32_t)pk0.n,
          pk0.codes.data(), pk0.codes_off.data(), pk0.lens.data(),
          pk0.full_lens.data(), pk0.clip_lens.data(), pk0.quals.data(),
          pk0.qual_off.data(), (const char *)pk0.names.data(),
          pk0.name_off.data(), (const char *)pk0.bc_blob.data(),
          pk0.bc_off.data(),
          pk1.codes.data(), pk1.codes_off.data(), pk1.lens.data(),
          pk1.full_lens.data(), pk1.clip_lens.data(), pk1.quals.data(),
          pk1.qual_off.data(), (const char *)pk1.names.data(),
          pk1.name_off.data(), (const char *)pk1.bc_blob.data(),
          pk1.bc_off.data(), sp0, srem0, sp1, srem1, opt0.mode, opt.mode,
          opt.max_top2, opt.s_mm, opt.max_diff, (double)opt.fnr,
          max_isize, force_isize, max_occ, n_multi, N_multi, is_sw,
          ap_prior, quiet, ii_state,
          rg_id.empty() ? nullptr : rg_id.c_str(), &rng, buf.data(), cap,
          used, x.sad, x.sad_is64);
      if (r >= 0) break;
      if (r == -1 || r == -2) return FALLBACK;  // truncated/mismatched
      cap = -r;
      quiet = 1;  // don't repeat the isize report on the retry
    }
    sp0 += used[0];
    srem0 -= used[0];
    sp1 += used[1];
    srem1 -= used[1];
    out.append(buf.data(), (size_t)r);
  }
  return write_out(out_path, out) ? 0 : 1;
}

// ---------------------------------------------------------------------
// fastmap (fastmap.c:408-483; mem/fastmap.py fastmap_lines is the spec)
// ---------------------------------------------------------------------

struct BI {  // bidirectional interval + info (bwtintv_t, bwt.h:20-23)
  int64_t x0, x1, x2, info;
};

// bwt_extend (bwt.c:262-275) over the occ64 blocks; ops/fm_host.py
// extend() is the executable spec
static void fm_extend(const occ64::View &g, const BI &ik, int is_back,
                      BI ok[4]) {
  int64_t fwd = is_back ? ik.x0 : ik.x1;
  int64_t tk[4], tl[4];
  occ64::occ4_pair(g, fwd - 1, fwd - 1 + ik.x2, tk, tl);
  int64_t bk = is_back ? ik.x1 : ik.x0;
  int64_t span =
      (fwd <= g.primary && g.primary <= fwd + ik.x2 - 1) ? 1 : 0;
  int64_t sz[4];
  for (int c = 0; c < 4; ++c) sz[c] = tl[c] - tk[c];
  int64_t b3 = bk + span, b2 = b3 + sz[3], b1 = b2 + sz[2], b0 = b1 + sz[1];
  int64_t bks[4] = {b0, b1, b2, b3};
  for (int c = 0; c < 4; ++c) {
    int64_t nb = g.L2[c] + 1 + tk[c];
    ok[c] = is_back ? BI{nb, bks[c], sz[c], 0} : BI{bks[c], nb, sz[c], 0};
  }
}

// bwt_smem1a (bwt.c:289-351); mirrors ops/fm_host.py smem1a line by line
static int smem1a(const occ64::View &g, const uint8_t *q, int length,
                  int x, int min_intv_in, int64_t max_intv,
                  std::vector<BI> *mems, std::vector<BI> *prev,
                  std::vector<BI> *curr) {
  mems->clear();
  if (q[x] > 3) return x + 1;
  int64_t min_intv = min_intv_in < 1 ? 1 : min_intv_in;
  BI ik{g.L2[q[x]] + 1, g.L2[3 - q[x]] + 1, g.L2[q[x] + 1] - g.L2[q[x]], 0};
  int64_t ik_info = x + 1;
  curr->clear();
  BI ok[4];
  int i = x + 1;
  for (; i < length; ++i) {
    if (ik.x2 < max_intv) {  // small enough interval
      curr->push_back({ik.x0, ik.x1, ik.x2, ik_info});
      break;
    }
    if (q[i] < 4) {
      int c = 3 - q[i];
      fm_extend(g, ik, 0, ok);
      if (ok[c].x2 != ik.x2) {
        curr->push_back({ik.x0, ik.x1, ik.x2, ik_info});
        if (ok[c].x2 < min_intv) break;
      }
      ik.x0 = ok[c].x0;
      ik.x1 = ok[c].x1;
      ik.x2 = ok[c].x2;
      ik_info = i + 1;
    } else {
      curr->push_back({ik.x0, ik.x1, ik.x2, ik_info});
      break;
    }
  }
  if (i == length) curr->push_back({ik.x0, ik.x1, ik.x2, ik_info});
  for (size_t a = 0, b = curr->size() - 1; a < b; ++a, --b)
    std::swap((*curr)[a], (*curr)[b]);
  int ret = (int)(*curr)[0].info;
  std::swap(*prev, *curr);
  int64_t ik_x2 = ik.x2;  // the reference reuses ik across the loops
  for (i = x - 1; i >= -1; --i) {
    int c = (i < 0 || q[i] >= 4) ? -1 : q[i];
    curr->clear();
    for (const BI &p : *prev) {
      if (c >= 0 && ik_x2 >= max_intv) fm_extend(g, p, 1, ok);
      if (c < 0 || ik_x2 < max_intv || ok[c].x2 < min_intv) {
        if (curr->empty()) {
          if (mems->empty() ||
              i + 1 < (int)(mems->back().info >> 32)) {
            ik_x2 = p.x2;
            mems->push_back({p.x0, p.x1, p.x2,
                             (p.info & 0xFFFFFFFF) |
                                 ((int64_t)(i + 1) << 32)});
          }
        }
      } else if (curr->empty() || ok[c].x2 != curr->back().x2) {
        curr->push_back({ok[c].x0, ok[c].x1, ok[c].x2, p.info});
      }
    }
    if (curr->empty()) break;
    std::swap(*prev, *curr);
  }
  for (size_t a = 0, b = mems->size(); b > a + 1; ++a, --b)
    std::swap((*mems)[a], (*mems)[b - 1]);
  return ret;
}

static int64_t sa_lookup(const Idx &x, int64_t k) {  // bwt_sa (bwt.c:86-96)
  if (x.sad)
    return x.sad_is64 ? ((const int64_t *)x.sad)[k]
                      : (int64_t)((const int32_t *)x.sad)[k];
  occ64::View g{x.inter.data(), x.seq_len, x.primary, x.L2};
  int64_t mask = x.sa_intv - 1, s = 0;
  while (k & mask) {
    ++s;
    k = occ64::inv_psi(g, k);
  }
  return s + x.ssa[k / x.sa_intv];
}

static int fm_pos2rid(const Idx &x, int64_t pos_f) {
  int left = 0, right = (int)x.ctg_off.size();
  while (right - left > 1) {
    int mid = (left + right) >> 1;
    if (x.ctg_off[mid] <= pos_f) left = mid;
    else right = mid;
  }
  return left;
}

static int cmd_fastmap(int argc, char **argv) {
  int min_iwidth = 20, min_len = 17, min_intv = 1;
  int64_t max_intv = 0;
  Opts o;
  if (!parse_opts(argc, argv, "w:l:pi:I:L:", &o)) return FALLBACK;
  for (auto &fl : o.flags) {
    switch (fl.first) {
      case 'w': min_iwidth = std::atoi(fl.second); break;
      case 'l': min_len = std::atoi(fl.second); break;
      case 'i': min_intv = std::atoi(fl.second); break;
      case 'I': max_intv = std::atoll(fl.second); break;
      case 'L': break;  // accepted and ignored, like the Python CLI
      case 'p': return FALLBACK;  // -p needs the raw sequence text
      default: return FALLBACK;
    }
  }
  if (o.args.size() < 2) return FALLBACK;
  Idx x;
  if (!load_idx(o.args[0], &x)) return FALLBACK;
  FqStream st;
  if (!load_fq(o.args[1], &st)) return FALLBACK;
  occ64::View g{x.inter.data(), x.seq_len, x.primary, x.L2};

  std::string out;
  out.reserve(st.buf.size());
  char buf[256];
  std::vector<BI> mems, prev, curr;
  while (true) {
    Packed pk;
    if (!next_batch(&st, 0, &pk)) return FALLBACK;
    if (pk.n == 0) break;
    for (int64_t ri = 0; ri < pk.n; ++ri) {
      const uint8_t *q = pk.codes.data() + pk.codes_off[ri];
      int length = pk.lens[ri];
      const char *name = (const char *)pk.names.data() + pk.name_off[ri];
      out += "SQ\t";
      out += name;
      std::snprintf(buf, sizeof buf, "\t%d\n", length);
      out += buf;
      int start = 0;
      while (start < length) {
        if (q[start] > 3) {
          ++start;
          continue;
        }
        start = smem1a(g, q, length, start, min_intv, max_intv, &mems,
                       &prev, &curr);
        for (const BI &m : mems) {
          int64_t mb = m.info >> 32, me = m.info & 0xFFFFFFFF;
          if (me - mb < min_len) continue;
          std::snprintf(buf, sizeof buf, "EM\t%ld\t%ld\t%ld",
                        (long)mb, (long)me, (long)m.x2);
          out += buf;
          if (m.x2 <= min_iwidth) {
            for (int64_t t = 0; t < m.x2; ++t) {
              int64_t pos = sa_lookup(x, m.x0 + t);
              bool is_rev = pos >= x.l_pac;
              int64_t pos_f = is_rev ? x.seq_len - 1 - pos : pos;
              if (is_rev) pos_f -= (me - mb) - 1;
              int rid = fm_pos2rid(x, pos_f);
              out += '\t';
              out += x.names[rid];
              std::snprintf(buf, sizeof buf, ":%c%ld",
                            is_rev ? '-' : '+',
                            (long)(pos_f - x.ctg_off[rid] + 1));
              out += buf;
            }
          } else {
            out += "\t*";
          }
          out += '\n';
        }
      }
      out += "//\n";
    }
  }
  return write_out(nullptr, out) ? 0 : 1;
}

}  // namespace

extern "C" {

// argv layout is the full command line: argv[0]=program, argv[1]=cmd.
// Returns the exit code, or 100 (FALLBACK) meaning "run the Python CLI
// instead" -- guaranteed to have produced NO output in that case.
int bt_cli_main(int argc, char **argv) {
  if (argc < 2) return FALLBACK;
  if (std::strcmp(argv[1], "aln") == 0) return cmd_aln(argc - 2, argv + 2);
  if (std::strcmp(argv[1], "samse") == 0)
    return cmd_samse(argc - 2, argv + 2);
  if (std::strcmp(argv[1], "sampe") == 0)
    return cmd_sampe(argc - 2, argv + 2);
  if (std::strcmp(argv[1], "fastmap") == 0)
    return cmd_fastmap(argc - 2, argv + 2);
  return FALLBACK;
}

}  // extern "C"
