"""FM-index construction: FASTA -> .pac/.ann/.amb/.bwt/.sa.

Byte-compatible with `bwa index` output (bwtindex.c:255-323, bwt.c:385-407),
but built the modern way: one 64-bit SA-IS pass over the doubled text
(native/sais.cpp) replaces the reference's three construction algorithms
(is.c, bwt_gen.c/QSufSort.c blockwise, rope.c rb2) and the O(n) invPsi walk
of bwt_cal_sa (bwt.c:62-84) -- the suffix array is already in hand, so the
sampled SA is a strided gather.
"""

from __future__ import annotations

import logging

import numpy as np

from bwa_tpu_torch.index.pack import fasta2bnt, write_pac, write_ann_amb
from bwa_tpu_torch.native.build import (bwt_chars, revcomp_concat, suffix_array,
                                  suffix_array_rows)

log = logging.getLogger(__name__)

OCC_INTERVAL = 128  # bases per occ checkpoint (bwt.h:37-39)
SA_INTV = 32        # suffix-array sampling interval (bwtindex.c:316)

# numpy working-block for the streaming derivation passes (multiple of
# 128 and 16); bounds every temporary so GRCh38 (6.2e9 chars) builds in
# O(n) + one 8(n+1)-byte suffix array instead of the reference's
# bounded-memory blockwise BWT construction (bwt_gen.c:1431) — with
# 125 GB of host RAM the full 64-bit SA is the faster design.
_BLOCK = 1 << 26


def bwt_from_sa(code2: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT string (sentinel removed) + primary index, from the suffix array.

    Row model: row 0 is the empty suffix (SA value n); rows 1..n are the
    text suffixes in sorted order.  primary = rank of the row whose SA
    value is 0 (the $-row of the BWT); the BWT char of that row is the
    sentinel and is dropped (is.c:208-222 semantics).
    """
    n = code2.shape[0]
    primary = int(np.nonzero(sa == 0)[0][0]) + 1
    rows = np.empty(n + 1, dtype=sa.dtype)
    rows[0] = n
    rows[1:] = sa
    chars = code2[(rows - 1)[rows != 0]]  # T[row-1] for every non-$ row
    return chars.astype(np.uint8), primary


def bwt_from_rows(code2: np.ndarray, rows: np.ndarray) -> tuple[np.ndarray, int]:
    """bwt_from_sa on the (n+1)-row model directly (rows[0] == n from
    suffix_array_rows), blocked so temporaries stay O(_BLOCK) — the full
    boolean mask + fancy-index of bwt_from_sa would cost 3 extra
    8n-byte arrays at GRCh38 scale."""
    n = code2.shape[0]
    bwt_str = np.empty(n, dtype=np.uint8)
    primary = -1
    out = 0
    for lo in range(0, n + 1, _BLOCK):
        chunk = rows[lo:lo + _BLOCK]
        z = np.nonzero(chunk == 0)[0]
        if z.size:
            primary = lo + int(z[0])
        keep = chunk[chunk != 0]
        vals = code2[keep - 1]
        bwt_str[out:out + vals.shape[0]] = vals
        out += vals.shape[0]
    assert out == n and primary >= 0
    return bwt_str, primary


def pack_bwt_words(bwt_str: np.ndarray) -> np.ndarray:
    """Pack the BWT string 16 bases/uint32, base i at bits (15-(i&15))*2
    (bwtindex.c:121-123).  Blocked: temporaries stay O(_BLOCK)."""
    n = bwt_str.shape[0]
    n_words = (n + 15) // 16
    words = np.empty(n_words, dtype=np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    for lo in range(0, max(n, 1), _BLOCK):
        chunk = bwt_str[lo:lo + _BLOCK]
        m = chunk.shape[0]
        nw = (m + 15) // 16
        padded = np.zeros(nw * 16, dtype=np.uint32)
        padded[:m] = chunk
        words[lo // 16: lo // 16 + nw] = (
            padded.reshape(-1, 16) << shifts[None, :]
        ).sum(axis=1, dtype=np.uint32)
    return words


def occ_checkpoints(bwt_str: np.ndarray) -> np.ndarray:
    """Cumulative base counts at every OCC_INTERVAL boundary, plus the final
    total: shape [n_ckpt, 4] uint64, n_ckpt = ceil(n/128)+1
    (bwt_bwtupdate_core, bwtindex.c:150-172).  Blocked running-sum pass."""
    n = bwt_str.shape[0]
    n_ckpt = (n + OCC_INTERVAL - 1) // OCC_INTERVAL + 1
    ckpt = np.empty((n_ckpt, 4), dtype=np.uint64)
    run = np.zeros(4, dtype=np.uint64)
    for lo in range(0, n, _BLOCK):
        chunk = bwt_str[lo:lo + _BLOCK]
        m = chunk.shape[0]
        nb = (m + OCC_INTERVAL - 1) // OCC_INTERVAL
        padded = np.full(nb * OCC_INTERVAL, 255, dtype=np.uint8)
        padded[:m] = chunk
        q = padded.reshape(nb, OCC_INTERVAL)
        per = np.empty((nb, 4), dtype=np.uint64)
        for c in range(4):
            per[:, c] = (q == c).sum(axis=1)
        j0 = lo // OCC_INTERVAL
        ckpt[j0] = run
        if nb > 1:
            ckpt[j0 + 1: j0 + nb] = run + np.cumsum(per[:-1], axis=0)
        run = run + per.sum(axis=0)
    ckpt[-1] = run
    return ckpt


def interleave_bwt(bwt_words: np.ndarray, ckpt: np.ndarray, n: int) -> np.ndarray:
    """On-disk interleaved uint32 stream: per 128-base block, 4 uint64
    counts (8 words) then up to 8 bwt words; trailing checkpoint at the end
    (layout macros bwt.h:73-80).  Vectorized: only the FINAL block may hold
    fewer than 8 words, so the stream is a flat prefix of the [ckpt||words]
    row matrix plus the trailing checkpoint."""
    n_words = bwt_words.shape[0]
    n_ckpt = ckpt.shape[0]
    n_blocks = n_ckpt - 1
    ckpt32 = ckpt.astype(np.uint64).view(np.uint32).reshape(n_ckpt, 8)
    if n_blocks == 0:
        return ckpt32[-1].copy()
    rows = np.zeros((n_blocks, 16), dtype=np.uint32)
    rows[:, :8] = ckpt32[:-1]
    wpad = np.zeros(n_blocks * 8, dtype=np.uint32)
    wpad[:n_words] = bwt_words
    rows[:, 8:] = wpad.reshape(n_blocks, 8)
    body = n_words + n_blocks * 8
    out = np.empty(body + 8, dtype=np.uint32)
    out[:body] = rows.reshape(-1)[:body]
    out[body:] = ckpt32[-1]
    return out


def write_bwt_file(path, primary: int, L2: np.ndarray, interleaved: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.uint64(primary).tofile(f)
        L2[1:5].astype(np.uint64).tofile(f)
        interleaved.tofile(f)


def write_sa_file(path, primary: int, L2: np.ndarray, sa_intv: int,
                  seq_len: int, sa_samples: np.ndarray) -> None:
    """.sa layout per bwt_dump_sa (bwt.c:396-407): header then samples[1:]."""
    with open(path, "wb") as f:
        np.uint64(primary).tofile(f)
        L2[1:5].astype(np.uint64).tofile(f)
        np.uint64(sa_intv).tofile(f)
        np.uint64(seq_len).tofile(f)
        sa_samples[1:].astype(np.uint64).tofile(f)


def _sais_would_swap(n: int) -> bool:
    """True when the ~10.2 bytes/char SA-IS working set (8 B suffix array
    + text + BWT derivation temporaries) exceeds available memory."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    avail = int(line.split()[1]) * 1024
                    return 10.2 * n > 0.9 * avail
    except OSError:
        pass
    return False


def index_build(fasta_path, prefix=None, algo: str = "auto",
                block_size: int | None = None) -> str:
    """Equivalent of `bwa index <fasta>`: writes prefix.{pac,ann,amb,bwt,sa}.

    algo selects the BWT constructor like the reference's -a flag
    (bwtindex.c:215,236): "is"/"div"/"auto" run the one-pass 64-bit SA-IS
    (fast, ~10 bytes/char peak); "bwtsw" and "rb2" run the bounded-memory
    incremental construction (native/bwtinc.cpp — the bwt_gen.c:1431 memory
    property, ~1.3 bytes/char + O(block_size) peak).  "rb2" in the
    reference is the ropebwt2 char-at-a-time dynamic-BWT insertion
    (bwtindex.c:95-120, rope.c); our incremental construction is the same
    algorithm class (dynamic-BWT insertion, counted B+-tree instead of a
    run-length rope) batched blockwise, and the BWT of a text is unique,
    so all five output files are byte-identical to the oracle's rb2
    output (tests/test_index.py::test_index_rb2_oracle_bytes).  Output
    bytes are identical across every algo.  block_size is the
    reference's -b knob (chars merged per incremental round); None
    auto-scales it as max(10M, n/96): merge traffic is O(n^2/block), so
    a fixed 10M block would spend GRCh38-scale builds mostly re-copying
    (620 rounds x ~3.1e9 chars), while n/96 keeps it ~65 rounds at
    ~0.7 GB of extra B-tree (still well inside the bounded envelope).
    """
    prefix = str(prefix if prefix is not None else fasta_path)
    log.info("packing FASTA %s", fasta_path)
    bnt, fwd = fasta2bnt(fasta_path)
    write_pac(prefix + ".pac", fwd)
    write_ann_amb(prefix, bnt)

    # doubled text: forward + reverse complement (bntseq.c:306-312)
    code2 = revcomp_concat(fwd)
    del fwd
    n = code2.shape[0]
    if algo in ("bwtsw", "rb2"):
        if block_size is None:
            # n/192 (was n/96): halves the per-round B+-tree + pending
            # footprint for ~+7% merge traffic — measured at the 1e8
            # probe, PERF.md round-5 scale section
            block_size = max(10_000_000, n // 192)
        # hand the doubled text over in a box and DROP our reference:
        # holding it here kept the 6.2 GB array alive through the whole
        # build (the callee's `del` only cleared its local binding) —
        # it was ~40% of the measured 15.6 GB full-scale steady state
        box = [code2]
        del code2
        return _index_build_bounded(prefix, box, n, block_size)
    if algo not in ("auto", "is", "div"):
        raise ValueError(f"unknown BWT construction algorithm: {algo}")
    if algo == "auto" and _sais_would_swap(n):
        # the in-place SA-IS needs ~10 bytes/char (a 63 GB peak at GRCh38);
        # when that exceeds available RAM the bounded incremental construction
        # (~1.4 GB + O(n/192) at full scale, PERF.md r5) is the only build
        # that finishes — mirror the reference's auto -> bwtsw choice for
        # big genomes (bwtindex.c:276)
        log.info("auto: SA-IS peak (~%.1f GB) exceeds available RAM; "
                 "using the bounded incremental construction", 10.2 * n / 1e9)
        box = [code2]
        del code2
        return _index_build_bounded(prefix, box, n,
                                    max(10_000_000, n // 192))
    log.info("building suffix array over %d bases (SA-IS)", n)
    rows_sa = suffix_array_rows(code2)  # (n+1)-row model, rows_sa[0] == n

    log.info("deriving BWT + occ checkpoints")
    counts = np.bincount(code2, minlength=4).astype(np.uint64)
    L2 = np.zeros(5, dtype=np.uint64)
    np.cumsum(counts, out=L2[1:])
    bwt_str, primary = bwt_chars(code2, rows_sa)
    del code2
    words = pack_bwt_words(bwt_str)
    ckpt = occ_checkpoints(bwt_str)
    del bwt_str
    interleaved = interleave_bwt(words, ckpt, n)
    del words, ckpt
    write_bwt_file(prefix + ".bwt", primary, L2, interleaved)
    del interleaved

    # sampled SA: value of row j*32 in the (n+1)-row model
    n_sa = (n + SA_INTV) // SA_INTV
    samples = rows_sa[np.arange(n_sa, dtype=np.int64) * SA_INTV]
    write_sa_file(prefix + ".sa", primary, L2, SA_INTV, n, samples)
    write_sad_sidecar(prefix, rows_sa, n)
    log.info("index written to %s.*", prefix)
    return prefix


def _index_build_bounded(prefix: str, code2_box: list, n: int,
                         block_size: int) -> str:
    """Bounded-memory .bwt/.sa construction (native/bwtinc.cpp): dynamic-BWT
    block insertion instead of a suffix array.  Peak ~= two n/2-byte
    interleaved buffers + the n/4-byte packed text + O(block_size) treap
    nodes — the property of the reference's blockwise construction
    (bwt_bwtgen2, bwt_gen.c:1292-1638) without QSufSort.  The .sa samples
    come from the inverse-Psi walk (bwt_cal_sa, bwt.c:70-84) since no
    suffix array ever exists."""
    from bwa_tpu_torch.index.pack import pack_codes
    from bwa_tpu_torch.native.build import bwt_incremental, bwt_sa_walk

    code2 = code2_box.pop()  # sole reference now lives in this frame
    log.info("building BWT incrementally over %d bases (block=%d)",
             n, block_size)
    # chunked count FIRST (before pack doubles residency): np.bincount
    # casts its input to int64, which on the 6.2e9-char doubled text is
    # a 49.6 GB transient (measured: it was the entire 56 GB peak of
    # the first full-scale run)
    counts = np.zeros(4, dtype=np.uint64)
    for s in range(0, n, 1 << 28):
        counts += np.bincount(code2[s:s + (1 << 28)],
                              minlength=4).astype(np.uint64)
    pac2 = pack_codes(code2)
    del code2
    L2 = np.zeros(5, dtype=np.uint64)
    np.cumsum(counts, out=L2[1:])
    inter, primary, cnt = bwt_incremental(pac2, n, block_size)
    del pac2
    assert np.array_equal(cnt.astype(np.uint64), counts), \
        "incremental BWT char counts disagree with the text"
    # full-block in-memory layout -> on-disk ragged stream (interleave_bwt
    # semantics: only the final block's word slots are truncated, then the
    # trailing checkpoint)
    n_words = (n + 15) // 16
    n_blocks = (n + 127) // 128
    inter32 = inter.view(np.uint32)
    body = n_words + n_blocks * 8
    stream = np.empty(body + 8, dtype=np.uint32)
    stream[:body] = inter32[:body]
    stream[body:] = counts.view(np.uint32)  # trailing ckpt: per-char totals
    write_bwt_file(prefix + ".bwt", primary, L2, stream)
    del stream

    log.info("deriving sampled SA (inverse-Psi walk)")
    want_sad = n + 1 <= SAD_MAX_LEN
    samples, sad = bwt_sa_walk(inter, n, primary, L2.astype(np.int64),
                               SA_INTV, want_sad)
    del inter
    n_sa = (n + SA_INTV) // SA_INTV
    write_sa_file(prefix + ".sa", primary, L2, SA_INTV, n, samples[:n_sa])
    if want_sad:
        write_sad_sidecar(prefix, sad, n)
    log.info("index written to %s.*", prefix)
    return prefix


# genomes up to this doubled-text size get a dense rank->position sidecar
SAD_MAX_LEN = 1 << 28


def write_sad_sidecar(prefix: str, rows_sa: np.ndarray, n: int) -> None:
    """Dense SA sidecar `<prefix>.sad.npy` (our own acceleration file; the
    reference-format .sa stays byte-identical).  sad[k] is exactly what the
    bwt_sa walk returns for rank k — in particular sad[0] = -1, matching
    the reference's bwt->sa[0] = (bwtint_t)-1 (bwt.c:77-84) — so dense
    lookup and the 31-step inverse-Psi walk are interchangeable.  rows_sa
    is the (n+1)-row model from SA-IS or the dense array from
    bwt_sa_walk — identical except both need sad[0] forced to -1."""
    if n + 1 > SAD_MAX_LEN:
        return
    cdt = np.int32 if n + 2 < 2**31 else np.int64
    sad = rows_sa.astype(cdt, copy=True)
    sad[0] = -1
    np.save(prefix + ".sad.npy", sad)


def read_bwt_file(path):
    """Parse a .bwt file -> (primary, L2[5], seq_len, ckpt[n_ckpt,4] uint64,
    words[n_blocks,8] uint32 zero-padded).  Vectorized inverse of
    interleave_bwt: the stream is a flat prefix of [ckpt||words] 16-word
    rows (only the final block is short) plus the trailing checkpoint."""
    raw = np.fromfile(path, dtype=np.uint8)
    head = raw[:40].view(np.uint64)
    primary = int(head[0])
    L2 = np.zeros(5, dtype=np.uint64)
    L2[1:5] = head[1:5]
    seq_len = int(L2[4])
    data = raw[40:].view(np.uint32)
    n_ckpt = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL + 1
    n_words = (seq_len + 15) // 16
    assert data.shape[0] == n_words + n_ckpt * 8, "inconsistent bwt size"
    n_blocks = n_ckpt - 1
    ckpt = np.empty((n_ckpt, 4), dtype=np.uint64)
    words = np.zeros((max(n_blocks, 1), 8), dtype=np.uint32)
    body = n_words + n_blocks * 8
    if n_blocks:
        rows = np.zeros(n_blocks * 16, dtype=np.uint32)
        rows[:body] = data[:body]
        rows = rows.reshape(n_blocks, 16)
        ckpt[:-1] = np.ascontiguousarray(rows[:, :8]).view(np.uint64)
        words[:] = rows[:, 8:]
    ckpt[-1] = data[body:body + 8].view(np.uint64)
    return primary, L2, seq_len, ckpt, words


def read_sa_file(path, primary: int, seq_len: int, coord_dtype=np.int64):
    raw = np.fromfile(path, dtype=np.uint64)
    assert int(raw[0]) == primary, "SA-BWT inconsistency: primary differs"
    sa_intv = int(raw[5])
    assert int(raw[6]) == seq_len, "SA-BWT inconsistency: seq_len differs"
    n_sa = (seq_len + sa_intv) // sa_intv
    samples = np.empty(n_sa, dtype=np.int64)
    samples[0] = -1  # bwt.c:437: sa[0] is poisoned; row 0 is never sampled at
    samples[1:] = raw[7:7 + n_sa - 1].astype(np.int64)
    return sa_intv, samples.astype(coord_dtype)
