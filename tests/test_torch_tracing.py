"""The port's tracer (bwa_tpu_torch/tracing.py) on the CPU: off it records
nothing; on, main_mem's SAM bytes are unchanged, every span lies inside
its parent, a chunk's spans share one ordinal across main_mem's three
threads, sa_lookup counts the walk's steps as a plain walk does, the
native finalize's phases and spans lie inside its call, program spans
share the profiler's clock, and their self times agree with the
benchmark's own wrapped spans."""

import io
import os
import socket
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAYERS = ("process_seqs", "seed", "sa_lookup", "finalize")
# each layer's spans less these (portbench/metrics' self times)
INNER = {"process_seqs": ("seed", "finalize"), "seed": ("sa_lookup",),
         "sa_lookup": (), "finalize": ("sa_lookup",)}


@pytest.fixture(autouse=True)
def _tracer_off():
    from bwa_tpu_torch import tracing

    tracing.enable(False)
    tracing.drain()
    yield
    tracing.enable(False)
    tracing.drain()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 150 kb genome's index without the dense SA sidecar (so sa_lookup
    walks the sampled SA, as on a chromosome-sized genome), 16 SE reads
    and 8 pairs, each in two -K chunks, and 4 short pairs in one (few
    plain-kernel operations for the profiler's trace)."""
    from bwa_tpu_torch.index.build import index_build

    d = tmp_path_factory.mktemp("torch_tracing")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    Path(prefix + ".sad.npy").unlink()
    write_fastq(d / "se.fq", simulate_reads(g, 16, read_len=150, seed=93,
                                            err_rate=0.02))
    r1, r2 = simulate_reads(g, 8, read_len=150, seed=91, paired=True)
    write_fastq(d / "r1.fq", r1)
    write_fastq(d / "r2.fq", r2)
    r1, r2 = simulate_reads(g, 4, read_len=70, seed=95, paired=True)
    write_fastq(d / "s1.fq", r1)
    write_fastq(d / "s2.fq", r2)
    return dict(prefix=prefix, genome=g, dir=d,
                se=["-K", "1200", "--device", "cpu", prefix,
                    str(d / "se.fq")],
                pe=["-K", "1200", "--device", "cpu", prefix,
                    str(d / "r1.fq"), str(d / "r2.fq")],
                short=["--device", "cpu", prefix, str(d / "s1.fq"),
                       str(d / "s2.fq")])


def _mem(argv, on):
    """main_mem(argv) with the tracer on or off: (SAM, drained spans)."""
    from bwa_tpu_torch import tracing
    from bwa_tpu_torch.cli import main_mem

    tracing.enable(on)
    try:
        out = io.StringIO()
        assert main_mem(argv, out) == 0
    finally:
        tracing.enable(False)
    return out.getvalue(), tracing.drain()


@pytest.fixture(scope="module")
def runs(world):
    """SE and PE, the tracer off and on (PE under the forced trip sort, so
    that the trip order's spans are there)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BWA_TPU_NO_DAEMON", "1")
    out = {}
    try:
        for mode in ("se", "pe"):
            if mode == "pe":
                mp.setenv("BWA_TPU_TRIP_SORT", "force")
            for on in (False, True):
                out[mode, on] = _mem(world[mode], on)
    finally:
        mp.undo()
    return out


def test_off_records_nothing(runs):
    """Off, no span is kept and a span site gets the shared no-op."""
    from bwa_tpu_torch import tracing

    assert runs["se", False][1] == [] and runs["pe", False][1] == []
    assert tracing.span("x") is tracing.OFF
    with tracing.span("x") as sp:
        sp.count("n", 3)
    tracing.count("x", "n")
    assert tracing.drain() == []


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_sam_unchanged_by_tracing(runs, mode):
    """The SAM bytes are the same with the tracer on and off, and on it
    saw every layer of the path."""
    off, on = runs[mode, False], runs[mode, True]
    assert off[0] == on[0] and off[0].count("\n") > 16
    names = {s.name for s in on[1]}
    assert set(LAYERS) | {"cli.wait_reads", "cli.hand_off", "io.parse",
                          "io.queue_full", "io.write", "seed.dispatch",
                          "seed.wait", "seed.demux", "finalize.pack",
                          "finalize.native", "finalize.unpack",
                          "fin.regions"} <= names
    if mode == "pe":
        assert {"seed.trip_order", "seed.probe", "fin.pestat",
                "fin.pairs"} <= names


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_spans_nest_and_share_chunks(runs, mode):
    """Every span lies inside its parent on the parent's thread; each
    chunk's ordinal is on the main thread's process_seqs, the reader's
    io.parse and the writer's io.write."""
    spans = runs[mode, True][1]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.t0 <= s.t1 and s.cpu0 <= s.cpu1
        if s.parent:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
            assert p.thread == s.thread and p.chunk == s.chunk
    threads = {s.name: s.thread for s in spans}
    assert threads["io.parse"] == "mem-reader"
    assert threads["io.write"] == "mem-writer"
    assert threads["process_seqs"] == threading.main_thread().name
    chunks = {n: sorted(s.chunk for s in spans if s.name == n)
              for n in ("process_seqs", "io.write")}
    assert chunks["process_seqs"] == chunks["io.write"] == [0, 1]
    parsed = {s.chunk for s in spans if s.name == "io.parse"}
    assert {0, 1} <= parsed
    seeds = [s for s in spans if s.name == "seed"]
    assert sum(s.counters.get("buckets", 0) for s in seeds) == 2
    assert sum(s.counters.get("host_fallbacks", 0) for s in seeds) == 0


def test_sa_lookup_counts_walk_steps(world):
    """sa_lookup's ranks are the ranks passed, and its walk_steps those
    of a plain Python inverse-Psi walk of the same ranks."""
    from bwa_tpu_torch import tracing
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.ops.fm_host import HostFM

    fm = FMIndex.load(world["prefix"])
    assert fm.sad is None
    ranks = np.random.default_rng(5).integers(0, fm.seq_len + 1, 300)
    tracing.enable()
    pos = fm.sa_lookup(ranks)
    tracing.enable(False)
    (sp,) = tracing.drain()
    host = HostFM(fm)
    steps = 0
    for k in ranks.tolist():
        while k % fm.sa_intv:
            k = host.inv_psi(k)
            steps += 1
    assert sp.name == "sa_lookup"
    assert sp.counters == {"ranks": 300, "walk_steps": steps,
                           "device_ranks": 0} and steps > 0
    assert pos.tolist() == [host.sa_walk(int(k)) for k in ranks]


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_native_phases_inside_the_call(runs, mode):
    """The native phase totals sum to at most finalize.native's span; its
    native spans lie inside it, PE's in the order regions, pestat,
    pairs."""
    spans = runs[mode, True][1]
    natives = [s for s in spans if s.name == "finalize.native"]
    assert len(natives) == 2
    assert sum(s.counters["extensions"] for s in natives) > 0
    for nat in natives:
        c = nat.counters
        phases = sum(c[p + "_ns"] for p in ("chain", "extend", "rescue",
                                            "pair", "sam"))
        assert 0 < phases <= nat.t1 - nat.t0
        assert c["cigars"] >= 0 and 0 <= c["rescue_hits"] \
            <= c["rescue_tries"]
        kids = sorted((s for s in spans if s.parent == nat.id),
                      key=lambda s: s.t0)
        want = (["fin.regions", "fin.pestat", "fin.pairs"] if mode == "pe"
                else ["fin.regions"])
        assert [s.name for s in kids] == want
        t = nat.t0
        for s in kids:
            assert t <= s.t0 <= s.t1 <= nat.t1
            t = s.t1


def test_spans_share_the_profilers_clock(tmp_path):
    """A program span around a record_function("pb.x") block maps to
    within 1 ms of it on portbench's Trace clock."""
    import time

    from torch.profiler import record_function

    from bwa_tpu_torch import tracing

    sys.path.insert(0, str(ROOT))
    from portbench.trace import Profile

    warm = Profile(tmp_path)  # the profiler's first start is slow
    warm.start()
    warm.stop()
    prof = Profile(tmp_path)
    prof.start()
    tracing.enable()
    with tracing.span("x"):
        with record_function("pb.x"):
            time.sleep(0.02)
    tracing.enable(False)
    trace = prof.stop()
    (sp,) = tracing.drain()
    (iv,) = trace.span("x")
    assert abs(iv[0] - sp.t0 * 1e-9) < 1e-3
    assert abs(iv[1] - sp.t1 * 1e-9) < 1e-3


def test_self_times_agree_with_benchmark_spans(world, monkeypatch,
                                               tmp_path):
    """With the benchmark's wrapped spans (portbench/entries/mem.py) and
    the program's both on, the self times of process_seqs, seed,
    sa_lookup and finalize agree within 1% of the run."""
    sys.path.insert(0, str(ROOT))
    from bwa_tpu_torch import tracing
    from portbench.entries import mem as entry
    from portbench.trace import Profile, Spans, minus, total, union

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    wrapped = Spans()
    for owner, attr, name, gen in entry.span_targets():
        (wrapped.wrap_generator if gen else wrapped.wrap)(owner, attr, name)
    prof = Profile(tmp_path)
    try:
        prof.start()
        _, spans = _mem(world["short"], True)
        trace = prof.stop()
    finally:
        wrapped.restore()
    mine = {n: np.array([[s.t0 * 1e-9, s.t1 * 1e-9] for s in spans
                         if s.name == n]).reshape(-1, 2) for n in LAYERS}
    theirs = {n: trace.span(n) for n in LAYERS}
    t0 = min(s.t0 for s in spans) * 1e-9
    run_s = max(s.t1 for s in spans) * 1e-9 - t0

    def self_s(iv, layer):
        out = union(iv[layer])
        for c in INNER[layer]:
            out = minus(out, iv[c])
        return total(out)

    for layer in LAYERS:
        assert len(theirs[layer]) and len(mine[layer])
        assert abs(self_s(mine, layer) - self_s(theirs, layer)) \
            <= 0.01 * run_s, layer


def test_buffer_drops_the_oldest(monkeypatch):
    """Past its capacity the buffer drops its oldest spans and counts
    them."""
    from bwa_tpu_torch import tracing

    monkeypatch.setattr(tracing, "CAPACITY", 3)
    d0 = tracing.snapshot()["dropped"]
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    tracing.enable(False)
    snap = tracing.snapshot()
    assert snap["dropped"] - d0 == 2 and snap["held"] == 3
    assert "K1" in snap["launches"]
    assert [s.name for s in tracing.drain()] == ["s2", "s3", "s4"]


def test_daemon_done_line_traced(world, monkeypatch, capsys):
    """A request served with the tracer on logs its self time per span
    and its counters beside its launches."""
    import json

    from bwa_tpu_torch import cli, server, tracing
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex

    key = os.path.realpath(world["prefix"])
    fm = FMIndex.load(world["prefix"])
    engine = make_engine(fm, "cpu")
    monkeypatch.setitem(cli._ENGINE_CACHE, key, (fm, engine, "cpu"))
    a, b = socket.socketpair()
    argv = ["mem", "-K", "100000", "--device", "cpu", world["prefix"],
            str(world["dir"] / "se.fq")]
    a.sendall(json.dumps({"argv": argv, "env": {}}).encode() + b"\n")
    tracing.enable()
    try:
        assert server._serve_one(b, cli, engine, "cpu") == "serve"
    finally:
        tracing.enable(False)
        b.close()
    reply = a.makefile("rb").read()
    a.close()
    assert reply.startswith(b'{"ok": 0}\n')
    done = [ln for ln in capsys.readouterr().err.splitlines()
            if "] done rc=0" in ln]
    assert len(done) == 1
    spans = json.loads(done[0].split(" spans=")[1].split(" counters=")[0])
    counters = json.loads(done[0].split(" counters=")[1])
    assert set(LAYERS) <= set(spans) and spans["process_seqs"] >= 0
    assert counters["sa_lookup.ranks"] > 0
    assert counters["finalize.native.extensions"] > 0
