// Text-derivation helpers for index construction at genome scale.
// numpy's negative-stride byte copy and random fancy-index run at a few
// MB/s; these loops run at memory speed with explicit prefetch, which
// turns two ~30 min GRCh38-scale passes into ~2 min (index/build.py).

#include <cctype>
#include <cstdint>
#include <cstring>

// BWT characters from the (n+1)-entry row model (rows[0] == n): for every
// row value r != 0 emit code2[r-1], in row order; returns the index of
// the $-row (primary).  Equivalent to index/build.py bwt_from_rows.
template <typename I>
static int64_t bwt_chars_t(const uint8_t *code2, const I *rows, I n,
                           uint8_t *bwt_out) {
  int64_t primary = -1;
  int64_t out = 0;
  const int64_t total = (int64_t)n + 1;
  for (int64_t i = 0; i < total; ++i) {
    if (i + 16 < total) __builtin_prefetch(&code2[rows[i + 16]]);
    I r = rows[i];
    if (r == 0) { primary = i; continue; }
    bwt_out[out++] = code2[r - 1];
  }
  return out == (int64_t)n ? primary : -1;
}

extern "C" {

// out[0..n) = fwd, out[n..2n) = reverse complement of fwd (code space
// 0..3, complement = 3-c) — the doubled text of bntseq.c:306-312.
void revcomp_concat(const uint8_t *fwd, int64_t n, uint8_t *out) {
  for (int64_t i = 0; i < n; ++i) out[i] = fwd[i];
  for (int64_t i = 0; i < n; ++i) out[n + i] = (uint8_t)(3 - fwd[n - 1 - i]);
}

int64_t bwt_chars_i32(const uint8_t *code2, const int32_t *rows, int32_t n,
                      uint8_t *bwt_out) {
  return bwt_chars_t<int32_t>(code2, rows, n, bwt_out);
}

int64_t bwt_chars_i64(const uint8_t *code2, const int64_t *rows, int64_t n,
                      uint8_t *bwt_out) {
  return bwt_chars_t<int64_t>(code2, rows, n, bwt_out);
}

}  // extern "C"
// Strict 4-line FASTQ block parser for the backtrack read intake —
// the array twin of aln/seqio.py FastBtFastq.batch + _build_bt (which
// spent ~0.15 s of Python per 8k-read command after the native ports).
// Emits the flat arrays the native finalizers consume directly; any
// structural surprise stops the parse cleanly so the caller can fall
// back to the general parser for the remaining byte stream.

static const int BT_MIN_RDLEN = 35;  // BWA_MIN_RDLEN (bwtaln.h)

extern "C" {

// Parse up to max_reads records from buf[0:len).  eof=1 means buf ends
// the stream.  Outputs (caller-sized: codes/qual blobs <= len bytes,
// names <= len, offsets max_reads+1):
//   codes_flat  nt4 codes, original orientation, full read length
//   codes_off   [n+1] int64
//   lens        post-trim lengths (bwa_trim_read when trim_qual >= 1)
//   full_lens   raw lengths
//   names_blob  NUL-terminated names, /1 and /2 suffixes stripped
//   name_off    [n+1] int64
//   qual_blob   raw ASCII quals (full length)
//   qual_off    [n+1] int64
// Returns n parsed; *consumed = bytes used (record-aligned); *ok = 0
// when a structural surprise requires the general-parser fallback.
int64_t bt_fastq_parse(const uint8_t *buf, int64_t len, int64_t max_reads,
                       int32_t eof, int32_t trim_qual, uint8_t *codes_flat,
                       int64_t *codes_off, int32_t *lens,
                       int32_t *full_lens, uint8_t *names_blob,
                       int64_t *name_off, uint8_t *qual_blob,
                       int64_t *qual_off, int64_t *consumed, int32_t *ok) {
  static uint8_t nt4[256];
  static bool nt4_init = false;
  if (!nt4_init) {
    for (int i = 0; i < 256; ++i) nt4[i] = 4;
    const char *b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      nt4[(uint8_t)b[i]] = (uint8_t)i;
      nt4[(uint8_t)(b[i] + 32)] = (uint8_t)i;
    }
    nt4[(uint8_t)'-'] = 5;
    nt4_init = true;
  }
  int64_t n = 0, pos = 0, cpos = 0, npos = 0, qpos = 0;
  codes_off[0] = name_off[0] = qual_off[0] = 0;
  *ok = 1;
  while (n < max_reads) {
    // locate the 4 line ends
    int64_t ls[4], le[4], p = pos;
    bool complete = true;
    for (int k = 0; k < 4; ++k) {
      ls[k] = p;
      const void *nl = memchr(buf + p, '\n', (size_t)(len - p));
      if (!nl) { complete = false; break; }
      le[k] = (const uint8_t *)nl - buf;
      p = le[k] + 1;
    }
    if (!complete) {
      // trailing partial record: fine mid-stream (caller refills); at
      // eof only pure whitespace may remain (mirrors FastBtFastq)
      if (eof) {
        bool ws = true;
        for (int64_t i = pos; i < len; ++i)
          if (!isspace(buf[i])) { ws = false; break; }
        if (!ws) *ok = 0;
      }
      break;
    }
    const uint8_t *hdr = buf + ls[0];
    int64_t hlen = le[0] - ls[0];
    const uint8_t *seq = buf + ls[1];
    int64_t slen = le[1] - ls[1];
    const uint8_t *plus = buf + ls[2];
    const uint8_t *qual = buf + ls[3];
    int64_t qlen = le[3] - ls[3];
    bool bad = hlen < 1 || hdr[0] != '@' || le[2] == ls[2] ||
               plus[0] != '+' || slen != qlen || slen == 0 ||
               hdr[hlen - 1] == '\r' ||
               memchr(hdr, ' ', (size_t)hlen) != nullptr ||
               memchr(hdr, '\t', (size_t)hlen) != nullptr;
    if (bad) { *ok = 0; break; }
    // name: hdr[1:], strip trailing /1 or /2 when longer than 2 chars
    int64_t nmlen = hlen - 1;
    if (nmlen > 2 && hdr[1 + nmlen - 2] == '/' &&
        (hdr[1 + nmlen - 1] == '1' || hdr[1 + nmlen - 1] == '2'))
      nmlen -= 2;
    memcpy(names_blob + npos, hdr + 1, (size_t)nmlen);
    names_blob[npos + nmlen] = 0;
    npos += nmlen + 1;
    name_off[n + 1] = npos;
    for (int64_t i = 0; i < slen; ++i)
      codes_flat[cpos + i] = nt4[seq[i]];
    cpos += slen;
    codes_off[n + 1] = cpos;
    memcpy(qual_blob + qpos, qual, (size_t)qlen);
    qpos += qlen;
    qual_off[n + 1] = qpos;
    int32_t length = (int32_t)slen;
    if (trim_qual >= 1) {  // bwa_trim_read (bwaseqio.c:80-91)
      int s = 0, mx = 0, max_l = length;
      for (int l = length - 1; l >= BT_MIN_RDLEN; --l) {
        s += trim_qual - (qual[l] - 33);
        if (s < 0) break;
        if (s > mx) { mx = s; max_l = l; }
      }
      length = max_l;
    }
    lens[n] = length;
    full_lens[n] = (int32_t)slen;
    ++n;
    pos = p;
  }
  *consumed = pos;
  return n;
}

}  // extern "C"
