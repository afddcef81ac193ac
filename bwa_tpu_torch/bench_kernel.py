"""Extension-kernel microbenchmark on a CUDA card.

    python -m bwa_tpu_torch.bench_kernel [--kind band|full] [N,Q,T,w ...]

The port's counterpart of the repository's bench_kernel.py: the same
problems (95%-matching sequences, so z-drop never cuts rows early: the
worst-case work) and shapes (1024x2048x2048, 1024x1024x1024 and
4096x256x512, all at w = 100), through the two kernels behind
ops/ksw_pallas.py: K2 in host-array mode (the band, extend_band_pallas)
and K5 (extend_batch_pallas, each problem in a window of its own band
width); --kind runs one of the two.  One JSON line per kernel and
shape:

- kernel_s: one launch on device-resident inputs, CUDA events around
  `reps` launches after a warm-up, divided by `reps`.
- e2e_s: the host-array wrapper (numpy rows in, numpy outputs back:
  padding, upload and download included), best of `reps` wall times.
- longest_rows, ns_per_row: the longest problem's rows swept and
  kernel_s over them, null when no row was swept (shapes with N = 1 or
  4 time one warp's row chain of K2 alone on the card).

Cells: banded = N*T*min(2w+1, Q); full-equiv = N*Q*T (what the unbanded
spec computes for the same problems).  Each line names the card and its
power limit.  Without a card it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from bwa_tpu_torch.ops import ksw_pallas
from bwa_tpu_torch.ops.ksw_band import (_band_for, ksw_band_arrays,
                                        ksw_band_arrays_plain)
from bwa_tpu_torch.ops.ksw_full import full_rows, ksw_full

SHAPES = ((1024, 2048, 2048, 100), (1024, 1024, 1024, 100),
          (4096, 256, 512, 100))
ZDROP = 100
# kernel name -> (kernel wrapper, plain version, host-array entry point)
KERNELS = {
    "band": (ksw_band_arrays, ksw_band_arrays_plain,
             ksw_pallas.extend_band_pallas),
    "full": (ksw_full, full_rows, ksw_pallas.extend_batch_pallas),
}


def make_problems(N, Q, T, w, h0=60):
    rng = np.random.default_rng(42)
    qs = rng.integers(0, 4, (N, Q), dtype=np.uint8)
    ts = rng.integers(0, 4, (N, T), dtype=np.uint8)
    L = min(Q, T)
    ts[:, :L] = np.where(rng.random((N, L)) < 0.95, qs[:, :L], ts[:, :L])
    mat = np.array([[1, -4, -4, -4, -1],
                    [-4, 1, -4, -4, -1],
                    [-4, -4, 1, -4, -1],
                    [-4, -4, -4, 1, -1],
                    [-1, -1, -1, -1, -1]], np.int32)
    return (qs, np.full(N, Q, np.int64), ts, np.full(N, T, np.int64), mat,
            np.full(N, w, np.int64), np.full(N, h0, np.int64))


def ragged_problems(seed, n, q, t, w_hi=120):
    """The repository's tests/test_ksw_pallas.py problems: ragged query and
    target lengths (qlen < Q on most rows), 85% of the target copies the
    query from its fourth base on; bands drawn from [10, w_hi).  Returns
    make_problems's tuple."""
    rng = np.random.default_rng(seed)
    mat = np.full((5, 5), -4, np.int32)
    for i in range(4):
        mat[i, i] = 1
    mat[4, :] = -1
    mat[:, 4] = -1
    qs = rng.integers(0, 4, (n, q)).astype(np.uint8)
    ts = rng.integers(0, 4, (n, t)).astype(np.uint8)
    lim = min(q, t - 3)
    ts[:, 3:3 + lim] = np.where(rng.random((n, lim)) < 0.85,
                                qs[:, :lim], ts[:, 3:3 + lim])
    qlens = rng.integers(q // 3, q + 1, n).astype(np.int32)
    tlens = rng.integers(t // 3, t + 1, n).astype(np.int32)
    ws = rng.integers(10, w_hi, n).astype(np.int32)
    h0s = rng.integers(1, 60, n).astype(np.int32)
    return qs, qlens, ts, tlens, mat, ws, h0s


def entry_args(problems, zdrop=ZDROP):
    """The entry points' arguments (extend_*_pallas minus device) for a
    problem tuple (qs, qlens, ts, tlens, mat, ws, h0s)."""
    qs, qlens, ts, tlens, mat, ws, h0s = problems
    return (qs, qlens, ts, tlens, mat, 6, 1, 6, 1, ws, 5, zdrop, h0s)


def host_args(N, Q, T, w):
    """The entry points' arguments at one benchmark shape."""
    return entry_args(make_problems(N, Q, T, w))


def device_args(kind, N, Q, T, w, device="cuda"):
    """Device-resident inputs of one kernel for these problems: the
    arguments of KERNELS[kind][0] (and of its plain version)."""
    a = host_args(N, Q, T, w)
    QP = -(-(Q + 1) // 128) * 128 if kind == "full" else Q
    q, t, ql, tl, wd, h0 = ksw_pallas.device_rows(*a[:11], a[12], QP,
                                                  device)
    rest = (a[4], 6, 1, 6, 1, ZDROP)
    if kind == "band":
        return (q, t, ql, tl, wd, h0, *rest, _band_for(int(wd.max())))
    return (q, t, ql, tl, wd, h0, *rest)


def card() -> tuple[str, str]:
    """(name, power limit) of the first card, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    name, limit = r.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def kernel_ms(fn, args, reps: int) -> tuple[float, torch.Tensor]:
    """CUDA-event time of one launch (mean over reps after a warm-up) and
    the warm-up's output."""
    out = fn(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn(*args)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def run_shape(kind, N, Q, T, w, reps=3):
    """One JSON-ready result for one kernel and shape; also the rows the
    kernel swept (for a bound) under "rows_swept"."""
    kern, _, entry = KERNELS[kind]
    ha = host_args(N, Q, T, w)
    entry(*ha)  # warm
    e2e = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        entry(*ha)
        e2e = min(e2e, time.perf_counter() - t0)
    ms, out = kernel_ms(kern, device_args(kind, N, Q, T, w), reps)
    kern_s = ms / 1e3
    band_cells = N * T * min(2 * w + 1, Q)
    full_cells = N * Q * T
    name, limit = card()
    return {
        "metric": f"ksw_extend_{kind}_gcups",
        "kernel": "K2 host-array" if kind == "band" else "K5",
        "shape": f"{N}x{Q}x{T}/w{w}",
        "kernel_s": kern_s,
        "kernel_band_gcups": band_cells / kern_s / 1e9,
        "kernel_full_equiv_gcups": full_cells / kern_s / 1e9,
        "e2e_s": e2e,
        "e2e_band_gcups": band_cells / e2e / 1e9,
        "e2e_full_equiv_gcups": full_cells / e2e / 1e9,
        "rows_swept": int(out[:, 6].to(torch.int64).sum()),
        # the longest problem's rows: a launch lasts as long as its chain
        "longest_rows": int(out[:, 6].max()),
        "ns_per_row": (kern_s * 1e9 / int(out[:, 6].max())
                       if int(out[:, 6].max()) else None),
        "device": name,
        "power_limit": limit,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_kernel: no CUDA card: nothing to measure",
              file=sys.stderr)
        return 1
    kinds = list(KERNELS)
    if "--kind" in argv:
        k = argv.index("--kind")
        kinds = [argv[k + 1]]
        argv = argv[:k] + argv[k + 2:]
    shapes = [tuple(int(x) for x in a.split(",")) for a in argv] or SHAPES
    for N, Q, T, w in shapes:
        for kind in kinds:
            print(json.dumps(run_shape(kind, N, Q, T, w)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
