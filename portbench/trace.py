"""Spans, launch records and the device trace of a traced run.

Spans are `torch.profiler.record_function` ranges that the benchmark
opens around the calls into each layer (Spans.wrap replaces a module
attribute that the program calls), so that they and the card's activity
share the profiler's clock.  The trace is read back from the profiler's
Chrome trace: host ranges of the benchmark (names "pb.<layer>") and the
card's kernels, copies and fills, as [start, end) intervals in seconds.
"""

from __future__ import annotations

import gzip
import json
import os
import time
from pathlib import Path

import numpy as np

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Wraps module attributes that the program calls; restore() puts the
    originals back."""

    def __init__(self):
        self._saved = []
        self.launches: dict[str, list] = {}

    def _set(self, owner, attr, fn):
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def wrap(self, owner, attr: str, span: str) -> None:
        """owner.attr runs inside the span `pb.<span>`."""
        import functools

        from torch.profiler import record_function

        real = getattr(owner, attr)

        @functools.wraps(real)
        def spanned(*a, **k):
            with record_function("pb." + span):
                return real(*a, **k)

        self._set(owner, attr, spanned)

    def wrap_generator(self, owner, attr: str, span: str) -> None:
        """Each item that owner.attr's generator yields is made inside the
        span `pb.<span>`; the caller's work between items is not."""
        import functools

        from torch.profiler import record_function

        real = getattr(owner, attr)

        @functools.wraps(real)
        def spanned(*a, **k):
            it = iter(real(*a, **k))
            while True:
                with record_function("pb." + span):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item

        self._set(owner, attr, spanned)

    def record(self, owner, attr: str, key: str, count) -> None:
        """After each call of owner.attr, count(args, kwargs, result) gives
        a record (device values allowed) kept under launches[key]."""
        import functools

        real = getattr(owner, attr)
        kept = self.launches.setdefault(key, [])

        @functools.wraps(real)
        def counted(*a, **k):
            out = real(*a, **k)
            kept.append(count(a, k, out))
            return out

        self._set(owner, attr, counted)

    def restore(self) -> None:
        for owner, attr, real in reversed(self._saved):
            setattr(owner, attr, real)
        self._saved = []


class Profile:
    """torch.profiler over the window, with a clock mark that maps
    time.perf_counter() onto the trace's clock."""

    def __init__(self, out_dir: Path):
        self.out_dir = out_dir
        self.prof = None
        self.mark_pc = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize()
        self.mark_pc = time.perf_counter()
        with record_function("pb.clock_mark"):
            pass

    def stop(self) -> "Trace":
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"trace.{os.getpid()}.json"
        try:
            self.prof.export_chrome_trace(str(path))
            return Trace.load(path, self.mark_pc)
        finally:
            path.unlink(missing_ok=True)


def union(iv: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of [start, end) rows."""
    if len(iv) == 0:
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, float)


def clip(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    if len(iv) == 0:
        return np.zeros((0, 2))
    c = np.stack([np.maximum(iv[:, 0], lo), np.minimum(iv[:, 1], hi)], 1)
    return c[c[:, 1] > c[:, 0]]


def total(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def minus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The parts of union a that union b does not cover."""
    a, b = union(a), union(b)
    out = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return np.asarray(out, float).reshape(-1, 2)


class Trace:
    """The traced run's host spans (by layer) and device activity, in
    seconds on the perf_counter clock."""

    def __init__(self, spans: dict, gpu: list):
        self.spans = spans  # "pb.<layer>" -> [n, 2]
        self.gpu = gpu      # (name, start, end)

    @classmethod
    def load(cls, path: Path, mark_pc: float) -> "Trace":
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f)["traceEvents"]
        mark = next(e["ts"] for e in events
                    if e.get("name") == "pb.clock_mark"
                    and e.get("cat") == "user_annotation")
        spans: dict[str, list] = {}
        gpu = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), e.get("name", "")
            s = (e["ts"] - mark) * 1e-6 + mark_pc
            iv = (s, s + e.get("dur", 0) * 1e-6)
            if cat == "user_annotation" and name.startswith("pb."):
                spans.setdefault(name, []).append(iv)
            elif cat in GPU_CATS:
                gpu.append((name,) + iv)
        return cls({k: np.asarray(v, float) for k, v in spans.items()}, gpu)

    def span(self, layer: str) -> np.ndarray:
        return self.spans.get("pb." + layer, np.zeros((0, 2)))

    def kernels(self, pattern: str) -> np.ndarray:
        return np.asarray([(s, e) for n, s, e in self.gpu if pattern in n],
                          float).reshape(-1, 2)

    def busy(self) -> np.ndarray:
        return union(np.asarray([(s, e) for _, s, e in self.gpu],
                                float).reshape(-1, 2))
