"""Spans and counters of the port's host layers, off by default.

A span is a named stretch of one thread's work: its start and end on the
monotonic clock (time.perf_counter_ns, the clock a torch.profiler trace
is mapped onto, and CLOCK_MONOTONIC, on which the native library stamps
its own spans), the thread's CPU time at both ends (time.thread_time_ns),
the thread's name, its parent span, the ordinal of the main_mem chunk it
belongs to (shared by the chunk's spans on the main, reader and writer
threads), and the counters set on it.  Closed spans wait in a bounded
buffer, the oldest dropped and counted; drain() takes them.

    with tracing.span("sa_lookup") as sp:
        sp.count("ranks", n)

Switched on by enable(), or for the whole process by BWA_TPU_TRACE=1 in
the environment when this module is first imported.  Off, a span site
tests ON once: it reads no clock and allocates nothing.

The span names of `mem`:
    cli.wait_reads, process_seqs, cli.hand_off      main_mem's thread
    io.parse, io.queue_full                         its reader thread
    io.write                                        its writer thread
    seed > seed.trip_order > seed.probe, seed.dispatch, seed.wait,
        seed.demux > sa_lookup                      mem/batch_seed.py
    finalize > finalize.pack, finalize.native > fin.regions, fin.pestat,
        fin.pairs (the native library's), finalize.unpack
Counters: seed: buckets, ladder_climbs, host_fallbacks; sa_lookup: ranks,
walk_steps; finalize.native: reruns, the native phases' nanoseconds
(chain_ns, extend_ns, rescue_ns, pair_ns, sam_ns) and counts (extensions,
rescue_tries, rescue_hits, cigars).
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import os
import threading
import time

CAPACITY = 1 << 16  # closed spans held until drain()

ON = os.environ.get("BWA_TPU_TRACE", "") not in ("", "0")

# the native library's layout (native/trace.h), in its enums' order
NATIVE_PHASES = ("chain", "extend", "rescue", "pair", "sam")
NATIVE_COUNTS = ("extensions", "rescue_tries", "rescue_hits", "cigars")
NATIVE_SPANS = ("fin.regions", "fin.pestat", "fin.pairs")
NATIVE_MAX_SPANS = 16

_local = threading.local()
_buf: collections.deque = collections.deque()
_lock = threading.Lock()
_ids = itertools.count(1)
_dropped = 0


class Span:
    """One span, open until close() (or the end of its with block)."""

    __slots__ = ("name", "id", "parent", "thread", "chunk", "t0", "t1",
                 "cpu0", "cpu1", "counters")

    def __init__(self, name, parent, chunk, t0, cpu0, t1=None, cpu1=None):
        self.name, self.parent, self.chunk = name, parent, chunk
        self.id = next(_ids)
        self.thread = threading.current_thread().name
        self.t0, self.cpu0, self.t1, self.cpu1 = t0, cpu0, t1, cpu1
        self.counters: dict = {}

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + int(n)

    def close(self) -> None:
        self.t1 = time.perf_counter_ns()
        self.cpu1 = time.thread_time_ns()
        _local.stack.remove(self)
        _keep(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.thread!r}, chunk={self.chunk}, "
                f"{self.t0}-{self.t1}, {self.counters})")


class _Off:
    """What a span site gets while tracing is off."""

    __slots__ = ()

    def count(self, key, n=1):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def enable(on: bool = True) -> None:
    global ON
    ON = bool(on)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _keep(sp: Span) -> None:
    global _dropped
    with _lock:
        if len(_buf) >= CAPACITY:
            _buf.popleft()
            _dropped += 1
        _buf.append(sp)


def span(name: str):
    """A span of this thread's work from now until its close(); OFF while
    tracing is off."""
    if not ON:
        return OFF
    st = _stack()
    sp = Span(name, st[-1].id if st else 0, getattr(_local, "chunk", None),
              time.perf_counter_ns(), time.thread_time_ns())
    st.append(sp)
    return sp


def each(name: str, items):
    """items, each made inside a span of its own (a generator's work
    between two yields: its caller's work between items is not in it)."""
    if not ON:
        return items
    return _each(name, iter(items))


def _each(name, it):
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def count(on: str, key: str, n: int = 1) -> None:
    """Adds n to counter `key` of this thread's innermost open span named
    `on` (nothing when none is open)."""
    if not ON:
        return
    for sp in reversed(_stack()):
        if sp.name == on:
            sp.count(key, n)
            return


def set_chunk(k: int | None) -> None:
    """The chunk ordinal of this thread's spans from now on."""
    if ON:
        _local.chunk = k


def drain() -> list[Span]:
    """The closed spans held, oldest first; the buffer is left empty."""
    with _lock:
        out = list(_buf)
        _buf.clear()
    return out


def snapshot() -> dict:
    """The process's kernel launches so far (server.launch_counts), the
    spans held and the spans dropped."""
    from bwa_tpu_torch.server import launch_counts

    with _lock:
        held, dropped = len(_buf), _dropped
    return {"launches": launch_counts(), "held": held, "dropped": dropped}


def summary(spans: list[Span]) -> dict:
    """Self time in seconds per span name (a span less its children) and
    every counter's total, as "<span>.<counter>"."""
    child: dict[int, int] = {}
    for s in spans:
        if s.parent:
            child[s.parent] = child.get(s.parent, 0) + (s.t1 - s.t0)
    self_s: dict[str, float] = {}
    counters: dict[str, int] = {}
    for s in spans:
        d = s.t1 - s.t0 - child.get(s.id, 0)
        self_s[s.name] = self_s.get(s.name, 0.0) + d * 1e-9
        for k, v in s.counters.items():
            key = f"{s.name}.{k}"
            counters[key] = counters.get(key, 0) + v
    return {"self_s": self_s, "counters": counters}


# ---------------------------------------------------------------- native
class _Native:
    """The native library's phase totals, counts and spans of the calls
    made on this thread inside the block, set on (and recorded under)
    the span given."""

    __slots__ = ("sp", "lib")

    def __init__(self, sp):
        from bwa_tpu_torch.native.build import get_lib

        self.sp, self.lib = sp, get_lib()

    def __enter__(self):
        self.lib.bt_trace_begin()
        return self

    def __exit__(self, *exc):
        n = len(NATIVE_PHASES) + len(NATIVE_COUNTS) + 1 + 5 * NATIVE_MAX_SPANS
        out = (ctypes.c_int64 * n)()
        self.lib.bt_trace_take(out)
        v = list(out)
        for i, p in enumerate(NATIVE_PHASES):
            self.sp.count(p + "_ns", v[i])
        base = len(NATIVE_PHASES)
        for i, c in enumerate(NATIVE_COUNTS):
            self.sp.count(c, v[base + i])
        base += len(NATIVE_COUNTS)
        for j in range(v[base]):
            sid, t0, t1, c0, c1 = v[base + 1 + 5 * j:base + 6 + 5 * j]
            # a closed child of sp, stamped by the native library
            _keep(Span(NATIVE_SPANS[sid], self.sp.id, self.sp.chunk, t0, c0,
                       t1, c1))
        return False


def native(sp):
    """A block whose native calls report to the open span sp (OFF for
    OFF, the span a site gets while tracing is off)."""
    return OFF if sp is OFF else _Native(sp)
