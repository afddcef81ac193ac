"""Traffic: a pool of reads made from the seed, its FASTQ text, and the
endless streams of it that the program reads as its FASTQ files.

One generator serves every mix file (portbench/mixes/<name>.json):

    "reads": {"kind": "single", "lengths": [2000, 10000], "ratio": [16, 1],
              "substitution_rate": 0.05}
    "reads": {"kind": "pairs", "length": 150, "insert_mean": 350,
              "insert_std": 40, "substitution_rate": 0.005}
    "pool_bases": 40000000

Reads are cut from either strand of the genome at uniform places; each
substituted base becomes one of the other three.  Every record's name
has a fixed width, `r<pass>.<index>`, so that a pass of the pool is
renamed in place before it is streamed again.
"""

from __future__ import annotations

import io
import os

import numpy as np

ACGT = np.frombuffer(b"ACGTN", np.uint8)
NAME_W = 13  # "r" + 3 pass digits + "." + 8 index digits


class Pool:
    """Records in stream order (a pair's mates adjacent: mate 1, mate 2):
    codes (flat uint8), offsets [n + 1], origins [n] (start in the doubled
    text, bwa's coordinates), pairs (bool)."""

    def __init__(self, codes, offsets, origins, pairs):
        self.codes, self.offsets, self.origins = codes, offsets, origins
        self.pairs = pairs
        self.n = len(origins)
        self.lengths = np.diff(offsets)
        self.cum_bases = np.concatenate([[0], np.cumsum(self.lengths)])

    def seq(self, k: int) -> np.ndarray:
        return self.codes[self.offsets[k]:self.offsets[k + 1]]

    def name(self, k: int, pass_no: int) -> str:
        i = k // 2 if self.pairs else k
        return f"r{pass_no % 1000:03d}.{i:08d}"

    def stream_bases(self, n_records: int) -> int:
        """Bases of the first n_records records of the endless stream."""
        full, rest = divmod(n_records, self.n)
        return int(full * self.cum_bases[-1] + self.cum_bases[rest])

    def chunk_records(self, chunk_bases: int) -> int:
        """Records of the first -K chunk (bseq_read: until it holds
        chunk_bases bases and an even number of records)."""
        n = int(np.searchsorted(self.cum_bases, chunk_bases))
        n += n % 2
        if n > self.n:
            raise ValueError("the pool holds less than one chunk")
        return n


def _substitute(rng, reads: np.ndarray, rate: float) -> None:
    m = rng.random(reads.shape) < rate
    reads[m] = (reads[m] + rng.integers(1, 4, int(m.sum()),
                                        dtype=np.uint8)) % 4


def _revcomp(rows: np.ndarray) -> np.ndarray:
    return (3 - rows)[:, ::-1]


def make_pool(codes: np.ndarray, mix: dict, seed: int) -> Pool:
    """The mix's pool of reads from `seed` (any integer), vectorised."""
    spec = mix["reads"]
    rng = np.random.default_rng(seed & ((1 << 128) - 1))
    glen = len(codes)
    err = float(spec["substitution_rate"])
    if spec["kind"] == "single":
        lens = np.asarray(spec["lengths"], np.int64)
        ratio = np.asarray(spec.get("ratio", [1] * len(lens)), np.int64)
        unit = int((lens * ratio).sum())
        units = max(1, -(-int(mix["pool_bases"]) // unit))
        per_len = ratio * units
        order = rng.permutation(np.repeat(np.arange(len(lens)), per_len))
        n = len(order)
        out_len = lens[order]
        offsets = np.concatenate([[0], np.cumsum(out_len)])
        flat = np.empty(int(offsets[-1]), np.uint8)
        origins = np.empty(n, np.int64)
        for g, L in enumerate(lens):
            ix = np.flatnonzero(order == g)
            s = rng.integers(0, glen - L + 1, len(ix))
            rows = codes[s[:, None] + np.arange(L)]
            _substitute(rng, rows, err)
            rev = rng.random(len(ix)) < 0.5
            rows[rev] = _revcomp(rows[rev])
            origins[ix] = np.where(rev, 2 * glen - (s + L), s)
            pos = offsets[ix][:, None] + np.arange(L)
            flat[pos] = rows
        return Pool(flat, offsets, origins, False)
    if spec["kind"] == "pairs":
        L = int(spec["length"])
        npairs = max(1, -(-int(mix["pool_bases"]) // (2 * L)))
        isize = np.maximum(L + 10, np.rint(rng.normal(
            float(spec["insert_mean"]), float(spec["insert_std"]),
            npairs)).astype(np.int64))
        s = rng.integers(0, glen - isize + 1)
        left = codes[s[:, None] + np.arange(L)]
        right = _revcomp(codes[(s + isize - L)[:, None] + np.arange(L)])
        _substitute(rng, left, err)
        _substitute(rng, right, err)
        o_left, o_right = s, 2 * glen - (s + isize)
        swap = rng.random(npairs) < 0.5
        m1 = np.where(swap[:, None], right, left)
        m2 = np.where(swap[:, None], left, right)
        o1 = np.where(swap, o_right, o_left)
        o2 = np.where(swap, o_left, o_right)
        flat = np.stack([m1, m2], 1).reshape(-1)
        origins = np.stack([o1, o2], 1).reshape(-1)
        offsets = np.arange(2 * npairs + 1, dtype=np.int64) * L
        return Pool(flat, offsets, origins, True)
    raise ValueError(f"unknown read kind {spec['kind']!r}")


class Fastq:
    """The FASTQ text of some of the pool's records (a stream: every
    record, or a pair's mate 1 or mate 2), with the offsets of each
    record and of its name's pass digits."""

    def __init__(self, pool: Pool, records: np.ndarray):
        L = pool.lengths[records]
        size = 1 + NAME_W + 1 + L + 3 + L + 1
        off = np.concatenate([[0], np.cumsum(size)])
        buf = np.empty(int(off[-1]), np.uint8)
        st = off[:-1]
        idx = records // 2 if pool.pairs else records
        names = np.empty((len(records), NAME_W), np.uint8)
        names[:, 0] = ord("r")
        names[:, 1:4] = ord("0")
        names[:, 4] = ord(".")
        digits = idx[:, None] // 10 ** np.arange(7, -1, -1) % 10
        names[:, 5:] = digits + ord("0")
        buf[st] = ord("@")
        buf[st[:, None] + 1 + np.arange(NAME_W)] = names
        seq_at = st + 2 + NAME_W
        buf[seq_at - 1] = ord("\n")
        # every record's bases, then its quality line
        within = np.arange(int(L.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(L)[:-1]]), L)
        src = np.repeat(pool.offsets[records], L) + within
        dst = np.repeat(seq_at, L) + within
        buf[dst] = ACGT[pool.codes[src]]
        sep = seq_at + L
        buf[sep] = ord("\n")
        buf[sep + 1] = ord("+")
        buf[sep + 2] = ord("\n")
        buf[dst + np.repeat(L + 3, L)] = ord("I")
        buf[off[1:] - 1] = ord("\n")
        self.buf, self.off = buf, off
        self.digit_at = st + 2  # the pass's 3 digits follow the "r"

    def rename(self, pass_no: int) -> None:
        for i, d in enumerate(f"{pass_no % 1000:03d}"):
            self.buf[self.digit_at + i] = ord(d)


def fastq_streams(pool: Pool) -> list[Fastq]:
    """One FASTQ for single reads, two (mate 1, mate 2) for pairs."""
    if pool.pairs:
        return [Fastq(pool, np.arange(0, pool.n, 2)),
                Fastq(pool, np.arange(1, pool.n, 2))]
    return [Fastq(pool, np.arange(pool.n))]


class Stream(io.FileIO):
    """A FASTQ stream as the file the program reads: the first `limit`
    records under pass `first_pass` (the warm-up), or the pool again and
    again without end, renamed a pass at a time.  The text sits in an
    anonymous in-memory file (memfd), so that the reader thread reads it
    with the same system calls as a FASTQ file in the page cache, and
    nothing is written to disk."""

    def __init__(self, fq: Fastq, first_pass: int,
                 limit: int | None = None):
        self.fq, self.pass_no, self.endless = fq, first_pass, limit is None
        self.size = int(fq.off[-1 if limit is None
                               else min(limit, len(fq.off) - 1)])
        super().__init__(os.memfd_create("portbench-fastq"), "rb+")
        self._load()

    def _load(self) -> None:
        self.fq.rename(self.pass_no)
        view = memoryview(self.fq.buf)[:self.size]
        while view:
            view = view[os.pwrite(self.fileno(), view,
                                  self.size - len(view)):]
        self.seek(0)

    def readinto(self, b) -> int:
        n = super().readinto(b)
        if n == 0 and self.endless:
            self.pass_no += 1
            self._load()
            n = super().readinto(b)
        return n


def open_stream(fq: Fastq, first_pass: int, limit: int | None = None):
    """The stream behind the buffer that open() gives a file of its
    block size."""
    raw = Stream(fq, first_pass, limit)
    size = os.fstat(raw.fileno()).st_blksize
    return io.BufferedReader(raw, size if size > 1 else
                             io.DEFAULT_BUFFER_SIZE)


def sample_records(pool: Pool, seed: int, count: int, longest: int
                   ) -> np.ndarray:
    """Stream indices (within one pass) of the records whose answers are
    compared: `count` drawn from the seed and the `longest` longest (whole
    pairs for paired traffic), sorted."""
    rng = np.random.default_rng((seed + 0x5eed) & ((1 << 128) - 1))
    units = pool.n // 2 if pool.pairs else pool.n
    per = pool.lengths[0::2] + pool.lengths[1::2] if pool.pairs \
        else pool.lengths
    pick = set(rng.choice(units, min(count, units), replace=False).tolist())
    pick |= set(np.argsort(-per, kind="stable")[:longest].tolist())
    u = np.array(sorted(pick), np.int64)
    if pool.pairs:
        return np.sort(np.concatenate([2 * u, 2 * u + 1]))
    return u
