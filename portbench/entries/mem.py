"""The `mem` entry: bwa_tpu_torch.cli.main_mem driven as a user runs it,
on an endless FASTQ stream, for a window of wall time.

Set-up loads the index and makes the engine once, as the resident daemon
does (cli._ENGINE_CACHE), makes the pool of reads from the seed and runs
one whole -K chunk of it through main_mem.  The window then streams the
pool again and again, each pass under fresh read names, from in-memory
files that main_mem's reader thread reads as its FASTQ files (no thread
of the benchmark feeds them); its SAM goes to a sink in memory that
counts each read's record, times it, and keeps the sampled reads'.  The
sink refuses the first record written after the window's end, so the
command stops at its next chunk.  The rate counts the chunks whose every
record was written inside the window, over the time from the window's
start to the last such record.
"""

from __future__ import annotations

import array
import math
import os
import sys
from time import perf_counter

import numpy as np

from portbench import traffic
from portbench.genome import genome_codes, index_prefix
from portbench.reference import mem as ref

# host layers the traced run brackets: (module, attribute, span)
SPANS = (
    ("bwa_tpu_torch.mem.pipeline", "process_seqs", "process_seqs"),
    ("bwa_tpu_torch.mem.batch_seed", "trip_order", "seed"),
    ("bwa_tpu_torch.mem.batch_seed", "collect_se_flat", "seed"),
    ("bwa_tpu_torch.mem.native_fin", "finalize_se_arrays", "finalize"),
    ("bwa_tpu_torch.mem.native_fin", "finalize_pe_arrays", "finalize"),
    ("bwa_tpu_torch.index.fmindex:FMIndex", "sa_lookup", "sa_lookup"),
)
GENERATOR_SPANS = (
    ("bwa_tpu_torch.mem.batch_seed", "se_flat_buckets", "seed"),
)
# innermost first: the label of an idle gap of the card
LABELS = ("sa_lookup", "seed", "finalize", "process_seqs")


class WindowClosed(Exception):
    """Raised by the sink at the first record after the window's end."""


class SamSink:
    """main_mem's output file: the header, then one write a read.  keep:
    a flag a pool record, whether its text is kept for the judge."""

    def __init__(self, keep: np.ndarray, deadline: float = math.inf):
        self.keep, self.n_pool = keep.astype(bool).tobytes(), len(keep)
        self.deadline = deadline
        self.header = None
        self.n = 0
        self.times = array.array("d")
        self.kept: dict[int, str] = {}

    def write(self, s: str) -> int:
        if self.header is None:
            self.header = s
            return len(s)
        now = perf_counter()
        if now > self.deadline:
            raise WindowClosed()
        k = self.n
        self.times.append(now)
        if self.keep[k % self.n_pool]:
            self.kept[k] = s
        self.n = k + 1
        return len(s)

    def flush(self) -> None:
        pass


def _resolve(path: str):
    import importlib

    mod, _, cls = path.partition(":")
    m = importlib.import_module(mod)
    return getattr(m, cls) if cls else m


class Cell:
    """One cell of a `mem` mix on a configuration."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device

    # ----------------------------------------------------------- set-up
    def setup(self) -> dict:
        """Genome, index, engine, pool and the warm-up chunk; returns what
        set-up measured besides its time."""
        from bwa_tpu_torch import cli
        from bwa_tpu_torch.engine import make_engine
        from bwa_tpu_torch.index.fmindex import FMIndex

        os.environ["BWA_TPU_NO_DAEMON"] = "1"
        self.make_inputs()
        self.prefix, built_s = index_prefix(self.cfg, self.codes)
        fm = FMIndex.load(self.prefix)
        engine = make_engine(fm, self.device)
        cli._ENGINE_CACHE[os.path.realpath(self.prefix)] = (
            fm, engine, self.device)
        self.streams = traffic.fastq_streams(self.pool)
        warm = self.pool.chunk_records(self.chunk_bases())
        per_stream = warm // 2 if self.pool.pairs else warm
        sink = SamSink(np.zeros(self.pool.n, bool))
        self._main_mem(sink, first_pass=999, limit=per_stream)
        if sink.n != warm:
            raise RuntimeError(f"warm-up wrote {sink.n} of {warm} records")
        self._sync()
        return dict(index_build_s=built_s, pool_records=self.pool.n,
                    pool_bases=int(self.pool.cum_bases[-1]),
                    warm_records=warm)

    def make_inputs(self) -> None:
        """The genome, the pool of reads and the sample, from the seeds
        alone (the control makes them too)."""
        self.codes = genome_codes(self.cfg)
        self.pool = traffic.make_pool(self.codes, self.mix, self.seed)
        s = self.mix["sample"]
        self.sample = traffic.sample_records(self.pool, self.seed,
                                             int(s["count"]),
                                             int(s["longest"]))

    def chunk_bases(self) -> int:
        a = self.mix["args"]
        return int(a[a.index("-K") + 1])

    def _sync(self):
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def _main_mem(self, sink, first_pass, limit=None, hook=None):
        """main_mem over the pool's streams; WindowClosed ends it."""
        from bwa_tpu_torch import cli
        from bwa_tpu_torch.io import fastq as fq_mod

        names = [f"portbench-stream-{i}.fq" for i in range(len(self.streams))]
        unopened = dict(zip(names, self.streams))
        opened = []
        real_open = fq_mod._open

        def _open(path):
            if path in unopened:
                f = traffic.open_stream(unopened.pop(path), first_pass, limit)
                opened.append(f)
                return f
            return real_open(path)

        fq_mod._open = _open
        try:
            rc = cli.main_mem([*self.mix["args"], "--device", self.device,
                               self.prefix, *names], out_fp=sink,
                              chunk_done_hook=hook)
            if rc != 0:
                raise RuntimeError(f"main_mem returned {rc}")
        except WindowClosed:
            pass
        finally:
            fq_mod._open = real_open
            for f in opened:
                f.close()

    # ----------------------------------------------------------- window
    def window(self, seconds: float, tracer=None) -> dict:
        """Streams the pool through main_mem for `seconds`: the rate, the
        window, and what judge() reads.  tracer: started before the
        window's clock and stopped once main_mem has returned."""
        chunks = []

        def hook(n):
            chunks.append(n)

        if tracer is not None:
            tracer.start()
        t0 = perf_counter()
        sink = SamSink(np.isin(np.arange(self.pool.n), self.sample),
                       deadline=t0 + seconds)
        self._main_mem(sink, first_pass=0, hook=hook)
        self._sync()
        trace = tracer.stop() if tracer is not None else None
        ends = np.cumsum(chunks).astype(np.int64)
        done = ends[ends <= sink.n]
        if len(done) == 0:
            raise RuntimeError("no chunk completed inside the window")
        n = int(done[-1])
        times = np.frombuffer(sink.times, np.float64)
        t1 = float(times[n - 1])
        self.sink, self.n_counted = sink, n
        ends_s = times[done - 1] - t0
        return dict(t0=t0, t1=t1, trace=trace,
                    chunk_s=np.diff(ends_s, prepend=0.0).tolist(),
                    e2e={"mem_bases_per_s":
                         self.pool.stream_bases(n) / (t1 - t0)})

    # ----------------------------------------------------------- judge
    def expected(self, i: int, bits=None) -> dict:
        """The reference's primary record of pool record i."""
        sc = ref.Scoring(self.mix["scoring"])
        g = self._genome
        if not self.pool.pairs:
            return ref.record_of(sc, g, self.pool.seq(i),
                                 int(self.pool.origins[i]), bits)
        j = i - i % 2
        r = self.mix["reads"]
        recs = [ref.record_of(sc, g, self.pool.seq(k),
                              int(self.pool.origins[k]), bits)
                for k in (j, j + 1)]
        bounds = ref.insert_bounds(float(r["insert_mean"]),
                                   float(r["insert_std"]))
        return ref.pair_records(*recs, bounds)[i - j]

    def answers(self) -> dict:
        """Stream index -> SAM text of the compared records that were due
        inside the window."""
        return {k: s for k, s in self.sink.kept.items()
                if k < self.n_counted}

    def control_answers(self, bits: int = 8) -> dict:
        """The control in the program's place: the sampled records of one
        pass as the reference writes them with every score held in
        `bits`-bit saturating integers."""
        self._genome = ref.Genome(self.codes)
        out = {}
        for k in self.sample.tolist():
            w = self.expected(k, bits)
            f = [self.pool.name(k, 0), str(w["flag"])]
            if w["flag"] & ref.UNMAP:
                f += ["*", "0", "0", "*", "*", "0", "0", "*", "*"]
            else:
                f += [self.cfg["contig_name"], str(w["pos"]), "60",
                      w["cigar"], "=" if "pnext" in w else "*",
                      str(w.get("pnext", 0)), str(w.get("tlen", 0)), "*",
                      "*", f"NM:i:{w['NM']}", f"AS:i:{w['AS']}"]
            out[k] = "\t".join(f) + "\n"
        return out

    def judge(self, answers: dict, bits=None, log=None) -> dict:
        """Each answer against the reference: (checked, differing); the
        first few that differ are printed to `log` (standard error)."""
        log = log or sys.stderr
        self._genome = ref.Genome(self.codes)
        cache: dict[int, dict] = {}
        contig = self.cfg["contig_name"]
        pairs = self.pool.pairs
        differ = 0
        shown = 0
        for k in sorted(answers):
            i = k % self.pool.n
            if i not in cache:
                cache[i] = self.expected(i, bits)
            want = cache[i]
            got = answers[k]
            why = _differs(got, want, self.pool.name(i, k // self.pool.n),
                           contig, pairs)
            if why:
                differ += 1
                if shown < 5:
                    shown += 1
                    print(f"portbench: record {k} differs ({why}): "
                          f"{got.splitlines()[0][:300] if got else got!r} "
                          f"want {want}", file=log)
        return dict(checked=len(answers), differing=differ)


def _differs(sam: str, want: dict, name: str, contig: str, pairs: bool):
    """Why the record differs from the reference's, or None."""
    if not sam:
        return "no record"
    lines = [ln.split("\t") for ln in sam.rstrip("\n").split("\n")]
    if any(f[0] != name for f in lines):
        return "name"
    prim = [f for f in lines if not int(f[1]) & 0x900]
    if len(prim) != 1:
        return "primary records"
    f = prim[0]
    mask = 0xFF if pairs else (ref.UNMAP | ref.REV)
    if int(f[1]) & mask != want["flag"] & mask:
        return "flag"
    if want["flag"] & ref.UNMAP:
        return None
    tags = dict(t.split(":", 1) for t in f[11:])
    got = (f[2], int(f[3]), f[5], tags.get("NM"), tags.get("AS"))
    exp = (contig, want["pos"], want["cigar"],
           f"i:{want['NM']}",
           f"i:{want['AS']}")
    if got != exp:
        return "pos/cigar/NM/AS"
    if pairs and "pnext" in want:
        if (f[6], int(f[7]), int(f[8])) != ("=", want["pnext"],
                                             want["tlen"]):
            return "mate"
    return None


def span_targets():
    """(owner, attribute, span, generator) of every bracketed call."""
    for mod, attr, span in SPANS:
        yield _resolve(mod), attr, span, False
    for mod, attr, span in GENERATOR_SPANS:
        yield _resolve(mod), attr, span, True
