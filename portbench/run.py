#!/usr/bin/env python3
"""The benchmark of bwa_tpu_torch (the PyTorch and CUDA port), one cell a
run:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is looked up by name in BENCHMARK.json; its configuration
(portbench/configs/<config>.json), its traffic mix
(portbench/mixes/<traffic>.json) and its per-layer metrics
(portbench/metrics/<name>.py) are files found by name, and the mix names
the entry that drives the program (portbench/entries/<entry>.py).
--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
metrics and the breakdown of the card's time, read from torch.profiler.
The last line of standard output is one JSON object; the numbers that
decided `correct` are printed beside their limits as the last lines of
standard error and under "checks", the last key of that object.

Exits non-zero and prints no result without a CUDA card, or when a
module of JAX or of the JAX package is loaded once the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "bwa_tpu")


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str):
    """(workload, configuration entry, configuration file, mix file)."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    ce = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = json.loads((ROOT / ce["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{wl['traffic']}.json").read_text())
    return wl, ce, cfg, mix


def metrics_of(bench: dict, wl: dict, kind: str) -> list[dict]:
    """The cell's metrics of `kind` (end_to_end, per_layer): those that
    list it, or list no cells and move one of its end-to-end metrics."""
    name = wl["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved
                             else [])]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def no_banned_modules() -> bool:
    """True when no module of JAX or of the JAX package is loaded (top-level
    names compared whole); else names them on standard error."""
    bad = sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
    return not bad


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"portbench: needs {n} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; a run never falls back to the CPU", file=sys.stderr)
        raise SystemExit(1)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_info(device: str, wl: dict) -> dict:
    """The result's device: the card's name, the cards used, the peak of
    memory allocated on the card, its name and power limit."""
    import torch

    if device != "cuda":
        return {"platform": device, "kind": device, "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(wl["chips"]),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "name_and_power_limit": power_limit()}


def host_counters() -> dict:
    """What the host did meanwhile: the machine's CPU ticks and those the
    hypervisor gave to other guests (/proc/stat), and the CPU seconds of
    this process and of its main thread."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        ticks = [0] * 8
    return {"ticks": sum(ticks), "steal": ticks[7] if len(ticks) > 7 else 0,
            "process_cpu_s": time.process_time(),
            "main_cpu_s": time.thread_time()}


def host_probe() -> dict:
    """The host's own speed now, on fixed work that is no part of the
    program: the median time of a sort of 2**20 int64 keys and of a fixed
    Python loop, as rates."""
    import statistics

    import numpy as np

    keys = np.random.default_rng(0).integers(0, 2**62, 1 << 20)
    sort_s, loop_s = [], []
    for _ in range(7):
        t = time.perf_counter()
        np.sort(keys)
        sort_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i * i
        loop_s.append(time.perf_counter() - t)
    return {"sort_mkeys_per_s": (1 << 20) / 1e6 / statistics.median(sort_s),
            "loop_mops_per_s": 0.1 / statistics.median(loop_s)}


def _proc_numbers(path: str, key: str) -> list[float]:
    """The number after `key` on each line of a /proc file that starts
    with it."""
    try:
        with open(path) as f:
            return [float(ln.split(":")[1].split()[0]) for ln in f
                    if ln.startswith(key)]
    except (OSError, ValueError, IndexError):
        return []


def host_report(before: dict, after: dict) -> dict:
    """The window's share of stolen ticks, its CPU seconds, and at its end
    the mean clock of the machine's cores and the process's memory in
    transparent huge pages."""
    d = {k: after[k] - before[k] for k in before}
    mhz = _proc_numbers("/proc/cpuinfo", "cpu MHz")
    huge = _proc_numbers("/proc/self/smaps_rollup", "AnonHugePages")
    return {"steal_share": d["steal"] / d["ticks"] if d["ticks"] else None,
            "process_cpu_s": d["process_cpu_s"],
            "main_cpu_s": d["main_cpu_s"],
            "cpu_mhz": sum(mhz) / len(mhz) if mhz else None,
            "anon_huge_kb": huge[0] if huge else None}


class Context:
    """What a per-layer reader reads: the trace, the window (perf_counter
    seconds) and the launches the readers' install() recorded."""

    def __init__(self, trace, t0, t1, launches):
        self.trace, self.t0, self.t1 = trace, t0, t1
        self.launches = launches

    def kernel_seconds(self, pattern: str) -> float:
        from portbench.trace import total

        return total(self.trace.kernels(pattern))


def breakdown(ctx, labels) -> dict:
    """The card's ten longest-running operations, and the window's ten
    longest idle gaps, each named by the benchmark span the host's main
    thread was in at the gap's middle."""
    import numpy as np

    from portbench.trace import clip, minus

    by_name: dict[str, float] = {}
    for n, s, e in ctx.trace.gpu:
        d = min(e, ctx.t1) - max(s, ctx.t0)
        if d > 0:
            by_name[n] = by_name.get(n, 0.0) + d
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    gaps = minus(np.array([[ctx.t0, ctx.t1]]),
                 clip(ctx.trace.busy(), ctx.t0, ctx.t1))
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:10]
    out = []
    for s, e in longest:
        mid = (s + e) / 2
        lab = next((lb for lb in labels
                    if any(a <= mid < b for a, b in ctx.trace.span(lb))),
                   "cli")
        out.append([lab, float(e - s)])
    return {"device_ops": [[n[:120], float(v)] for n, v in ops],
            "idle_gaps": out}


def run(argv, device="cuda", check_card=True):
    """One run of a cell; returns the exit code.  device and check_card
    are for the CPU tests (the command line always asks for the card)."""
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # any compile cache a library keeps stays at a fixed path in the
    # checkout (the port's own builds go to build/kernels, build/native)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    bench = load_benchmark()
    wl, _, cfg, mix = cell_of(bench, args.workload)
    if check_card:
        require_cards(int(wl["chips"]))
    from portbench.trace import Profile, Spans, clip, total

    entry = importlib.import_module(f"portbench.entries.{mix['entry']}")
    cell = entry.Cell(cfg, mix, args.seed, device)
    info = cell.setup()
    setup_s = time.perf_counter() - T_START
    readers, spans, tracer = [], None, None
    if args.trace:
        readers = [(m, load_reader(m["name"]))
                   for m in metrics_of(bench, wl, "per_layer")]
        spans = Spans()
        for owner, attr, span, gen in entry.span_targets():
            (spans.wrap_generator if gen else spans.wrap)(owner, attr, span)
        for _, r in readers:
            if hasattr(r, "install"):
                r.install(spans)
        tracer = Profile(ROOT / "build" / "portbench" / "trace")
    probe = host_probe()  # after set-up's clock, before the window's
    before = host_counters()
    try:
        res = cell.window(args.seconds, tracer)
    except Exception:  # the program failed inside the window: not correct
        traceback.print_exc()
        if no_banned_modules():
            print(json.dumps({"correct": False, "attempted": 0, "failed": 0,
                              "metrics": {}, "device": device_info(
                                  device, wl), "checks": {}}), flush=True)
            return 0
        return 3
    finally:
        if spans is not None:
            spans.restore()
    host = host_report(before, host_counters())
    host["probe_before"], host["probe_after"] = probe, host_probe()
    dev = device_info(device, wl)
    values = dict(res["e2e"], setup_s=setup_s)
    out_metrics = {}
    brk = None
    if args.trace:
        ctx = Context(res["trace"], res["t0"], res["t1"], spans.launches)
        for m, r in readers:
            v = r.read(ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        dev["busy_s"] = total(clip(ctx.trace.busy(), ctx.t0, ctx.t1))
        dev["window_s"] = ctx.t1 - ctx.t0
        brk = breakdown(ctx, entry.LABELS)
    else:
        for m in metrics_of(bench, wl, "end_to_end"):
            out_metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    chunk_s = res["chunk_s"]
    del res
    answers = cell.answers()
    verdict = cell.judge(answers)
    limits = json.loads((HERE / "limits" / f"{wl['name']}.json").read_text())
    share = verdict["differing"] / max(verdict["checked"], 1)
    checks = {"records_checked": {"value": verdict["checked"],
                                  "limit": limits["min_records_checked"]},
              "records_differing_share": {
                  "value": share, "limit": limits["records_differing_share"]}}
    correct = (verdict["checked"] >= limits["min_records_checked"]
               and share <= limits["records_differing_share"])
    if not no_banned_modules():
        return 3
    result = {"correct": bool(correct), "attempted": int(cell.n_counted),
              "failed": verdict["differing"], "metrics": out_metrics,
              "device": dev}
    if brk is not None:
        result["breakdown"] = brk
    result["setup"] = info
    result["chunk_s"] = chunk_s
    result["host"] = host
    result["checks"] = checks
    print(f"portbench: {wl['name']} seed {args.seed}: {info}",
          file=sys.stderr)
    print(f"check records_checked {verdict['checked']} at least "
          f"{limits['min_records_checked']}", file=sys.stderr)
    print(f"check records_differing_share {share!r} limit "
          f"{limits['records_differing_share']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
