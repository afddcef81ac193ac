"""K9, K10a, K10b, K11 (csrc/smem_batch.cu) and K1's state mode (K12a,
K12b, K13: csrc/seed_machine.cu) alone on a CUDA card.

    python3 bwa_tpu_torch/bench_smem.py [--root DIR] [--reps N]
                                        [--part smem|state|all]

Times the kernels of this checkout or, with --root, of another checkout
of the repository (a parent commit unpacked with `git archive`), so that
two commits run the same inputs on one card, each in a process of its
own.  The inputs, made from chip_smoke.py's seed:

- 4f: every launch that step 4f of chip_smoke.py makes on its 4,096 x
  150 bp reads (K10a and K10b: the unfused route's calls; K11: the fused
  route's), each in the form the route picks, and their sum a kernel;
- forms: K10a's first call (x = 0) and its pass-2 call, K10b's first
  call and K11's call at occtab rows of R = 4 and 1, K10a in each of the
  tree's forms;
- repeat: a 150 kb genome with tandem arrays (those of
  tests/test_torch_cuda.py's repeat world), 4,096 reads in or before
  them and random reads, x inside each (backward rows of tens of
  entries): K10a in each form and K11, at R = 1 and 4;
- scratch: 512 reads of 8,000 bases, x inside each, whose lists pass a
  block's shared memory (the global-scratch plan): K10a in each form and
  K11;
- state (--part state or all): step 4f's first state-mode launches,
  through the route functions (engine.collect_seeds under
  BWA_TPU_SEED_MACHINE=split and BWA_TPU_SEED_COMPACT=1 on the first
  bucket `mem` seeds of step 4d's 24,576 x 150 bp reads): each launch of
  K12a pass 1, K12a pass 2, K12b and K13's first segment, its wrapper's
  CUDA-event ms and the kernel alone; and K9 on step 4f's 65,536 rows
  (its longest walk where the tree counts it).

Each K10/K11 call is timed three ways over --reps launches after a
warm-up: ms,
CUDA events around the wrapper calls; busy_ms, the same with the card
kept busy ahead of the host (the device time of the wrapper's kernels);
kernel_ms, the kernel alone (torch.profiler).  A state-mode launch is
timed over --reps route calls: ms, its wrapper's CUDA events; kernel_ms,
its own kernel in the profiler.  out_hash hashes the outputs: equal
across forms and trees.  One JSON line a row, each naming the card and
its power limit; the last line the 4f sums.  Without a card it exits
non-zero.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# the kernel functions, as the profiler names them
KERNEL_NAMES = {"K10a": "smem1a_kernel", "K10b": "strategy1_kernel",
                "K11": "collect_kernel"}
WRAPPERS = {"K10a": "smem1a_batch", "K10b": "seed_strategy1_batch",
            "K11": "collect_intv_device"}
# tandem arrays of the repeat input: (start, unit, copies), those of
# tests/test_torch_cuda.py's repeat_world
REPEAT_ARRAYS = ((20_000, b"AC", 60), (60_000, b"AGT", 45),
                 (100_000, b"A", 40))


def kernel_time(fn, reps, name):
    """Device ms a call of the kernels whose name holds `name`, from
    torch.profiler's CUDA activity (None where it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if name in e.key)
    return us / reps / 1e3 if us else None


def launch_times(fn, reps, name):
    """Device ms of each launch of the kernels whose name holds `name` in
    a call of fn, in launch order, the mean over reps calls
    (torch.profiler's kernel records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if name in e.name
                  and e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    per = len(evs) // reps
    return [sum(evs[r * per + i].time_range.elapsed_us()
                for r in range(reps)) / reps / 1e3 for i in range(per)]


class WrapperTimer:
    """CUDA events around each call of a module's function (restored by
    restore()): ms() the mean ms of each call position over the runs
    since begin()."""

    def __init__(self, mod, name):
        import torch

        self.mod, self.name, self.real = mod, name, getattr(mod, name)
        self.runs, self.cur = [], None
        real, runs = self.real, self.runs

        def timed(*a, **kw):
            e = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = real(*a, **kw)
            e[1].record()
            runs[-1].append(e)
            return out

        setattr(mod, name, timed)

    def begin(self):
        self.runs.append([])

    def ms(self):
        import torch

        torch.cuda.synchronize()
        runs = [r for r in self.runs if r]
        n = min(len(r) for r in runs)
        return [sum(r[i][0].elapsed_time(r[i][1]) for r in runs) / len(runs)
                for i in range(n)]

    def restore(self):
        setattr(self.mod, self.name, self.real)


def state_part(cs, card, root, fa, fm, eng, codes, reps):
    """The state part: step 4f's first K12a pass-1, K12a pass-2, K12b and
    K13 launches through the route functions, and K9; one JSON line
    each."""
    import os

    import numpy as np
    import torch

    from bwa_tpu_torch.cli import main as cli_main
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.ops import fm_machine as fmm

    d = REPO / "build" / "smoke"
    fq = d / "bench_state_se.fq"
    cs.write_fastq(fq, cs.simulate(codes, 24576, 150, cs.SEED + 12, 0.005,
                                   0.0002, "t")[0])
    first = []
    real = fm_ops.BatchedFMEngine.collect_seeds

    def grab(self, *a, **kw):
        if not first:
            first.append((a, kw))
        return real(self, *a, **kw)

    fm_ops.BatchedFMEngine.collect_seeds = grab
    try:
        with cs.env_set(BWA_TPU_SEED_MACHINE="split"):
            with open(os.devnull, "w") as null:
                cli_main(["mem", "--device", "cuda", str(fa), str(fq)],
                         out_fp=null)
    finally:
        fm_ops.BatchedFMEngine.collect_seeds = real
    a, kw = first[0]
    # the wrappers the routes call: this tree's, else the parent's names
    names = {"smem": "smem_pass" if hasattr(fmm, "smem_pass")
             else "smem_machine",
             "seed3": "seed3_pass" if hasattr(fmm, "seed3_pass")
             else "seed3_machine", "segment": "segment"}
    rows = []
    for route, env, kinds in (
            ("split", {"BWA_TPU_SEED_MACHINE": "split"},
             (("K12a pass 1", "smem", 0), ("K12a pass 2", "smem", 1),
              ("K12b", "seed3", 0))),
            ("compact", {"BWA_TPU_SEED_COMPACT": "1"},
             (("K13", "segment", 0),))):
        timers = {k: WrapperTimer(fmm, n) for k, n in names.items()}
        try:
            def call():
                for t in timers.values():
                    t.begin()
                return eng.collect_seeds(*a, **kw)

            with cs.env_set(**env):
                h = hashlib.sha256()
                for o in call():
                    h.update(np.ascontiguousarray(o).tobytes())
                kern = launch_times(call, reps, "seed_machine_kernel")
                for t in timers.values():  # the profiled runs' events out
                    t.runs.clear()
                for _ in range(reps):
                    call()
                wms = {w: timers[w].ms() for _, w, _ in kinds}
        finally:
            for t in timers.values():
                t.restore()
        # the kernel launches of a split call: pass 1, pass 2, pass 3
        order = {"K12a pass 1": 0, "K12a pass 2": 1, "K12b": 2, "K13": 0}
        for kernel, w, i in kinds:
            k_ms = kern[order[kernel]] if order[kernel] < len(kern) else None
            row = dict(card=card, root=str(root), kernel=kernel, input="4f",
                       route=route, B=int(a[0].shape[0]),
                       L=int(a[0].shape[1]), ms=wms[w][i], kernel_ms=k_ms,
                       gap_ms=None if k_ms is None else wms[w][i] - k_ms,
                       out_hash=h.hexdigest()[:16])
            print(json.dumps(dict(state_bench=row)), flush=True)
            rows.append(row)
    rng = np.random.default_rng(cs.SEED + 13)  # step 4f's K9 rows
    ks = torch.from_numpy(rng.integers(0, fm.seq_len, 65536)).to(
        eng.idx["cdt"]).cuda()
    work = torch.zeros(2, dtype=torch.int64, device="cuda")
    out = fm_ops.sa_batch(eng.idx, ks, work=work)
    longest = int(work[1]) or None  # a tree that counts the longest walk
    row = dict(card=card, root=str(root), kernel="K9", input="4f",
               B=int(ks.numel()), walk_steps=int(work[0]),
               longest_walk=longest,
               ms=cs.cuda_time(lambda: fm_ops.sa_batch(eng.idx, ks), reps),
               kernel_ms=kernel_time(lambda: fm_ops.sa_batch(eng.idx, ks),
                                     reps, "sa_kernel"),
               out_hash=hashlib.sha256(out.cpu().numpy().tobytes())
               .hexdigest()[:16])
    row["ns_per_step"] = None if longest is None or row["kernel_ms"] is None \
        else row["kernel_ms"] * 1e6 / longest
    print(json.dumps(dict(state_bench=row)), flush=True)
    return rows + [row]


def repeat_input(d, seed, B=4096):
    """The repeat input's genome (indexed in d), and B reads of 150 bases
    or less with x from the seed: (fm, q, qlen, x)."""
    import numpy as np

    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 150_000).astype(np.uint8)
    for s, unit, n in REPEAT_ARRAYS:
        u = np.frombuffer(unit, np.uint8)
        codes[s:s + len(u) * n] = np.tile(
            np.searchsorted(np.frombuffer(b"ACGT", np.uint8), u), n)
    fa = d / "repeats.fa"
    if not (d / "repeats.fa.sa").exists():
        seq = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()
        fa.write_bytes(b">repeats\n" + seq + b"\n")
        index_build(str(fa))
    rows = []
    for s, unit, n in REPEAT_ARRAYS:
        span = len(unit) * n
        for m in (30, 45, 60, span):
            for f in (0, 30):
                rows.append(codes[s - f:s + min(m, span) + 30][:150])
    for _ in range(8):
        p = int(rng.integers(0, 149_000))
        rows.append(codes[p:p + 150])
    rows = (rows * (-(-B // len(rows))))[:B]
    q = np.full((B, 150), 4, np.uint8)
    ql = np.array([len(r) for r in rows], np.int32)
    for k, r in enumerate(rows):
        q[k, :len(r)] = r
    x = np.array([rng.integers(0, n) for n in ql], np.int32)
    return FMIndex.load(str(fa)), q, ql, x


def main(argv) -> int:
    root = Path(argv[argv.index("--root") + 1]).resolve() \
        if "--root" in argv else REPO
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 10
    part = argv[argv.index("--part") + 1] if "--part" in argv else "all"
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # run as a file, its own folder heads sys.path: the package's modules
    # would shadow top-level names; the tree's root takes its place
    if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a card")
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex, FMIndex
    from bwa_tpu_torch.mem import batch_seed
    from bwa_tpu_torch.ops import cuda_kernels
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.options import MemOptions

    card = (cs.smi("--query-gpu=name,power.limit") or ["(no nvidia-smi)"])[0]
    cuda_kernels.build_all()
    d = REPO / "build" / "smoke"
    d.mkdir(parents=True, exist_ok=True)
    fa, codes = cs.make_genome(d)
    fm = FMIndex.load(str(fa))
    reads = cs.simulate(codes, 4096, 150, cs.SEED + 3, 0.005, 0.0002,
                        "s")[0]
    opt = MemOptions()
    eng = fm_ops.BatchedFMEngine(fm, device="cuda")
    if part in ("state", "all"):
        state_part(cs, card, root, fa, fm, eng, codes, reps)
    if part == "state":
        return 0
    recs = {k: cs.Recorder(fm_ops, w) for k, w in WRAPPERS.items()}
    try:
        reads_ = [r for _, r in reads]
        q, lens, _ = batch_seed._pad_reads(reads_)
        eng.collect_seeds(q, lens, opt, 96, fused=True)
        batch_seed.collect_intv_batch_unfused(opt, eng, reads_)
    finally:
        for r in recs.values():
            r.restore()
    has_form = "form" in inspect.signature(fm_ops.smem1a_batch).parameters

    def run(kernel, inp, args, kw, forms=(None,)):
        """Rows of one call in each form (None: the call's own)."""
        fn = getattr(fm_ops, WRAPPERS[kernel])
        out = []
        for form in forms if has_form else (None,):
            k = dict(kw, **({} if form is None else {"form": form}))
            if not has_form:
                k.pop("form", None)
            h = hashlib.sha256()
            for o in fn(*args, **k):
                h.update(o.cpu().numpy().tobytes())
            row = dict(card=card, root=str(root), kernel=kernel, input=inp,
                       form=k.get("form"), B=int(args[1].shape[0]),
                       ms=cs.cuda_time(lambda: fn(*args, **k), reps),
                       busy_ms=cs.busy_time(lambda: fn(*args, **k), reps),
                       kernel_ms=kernel_time(lambda: fn(*args, **k), reps,
                                             KERNEL_NAMES[kernel]),
                       out_hash=h.hexdigest()[:16])
            plan = getattr(fm_ops, "smem_plans", {}).get(kernel)
            if plan:
                row["plan"] = plan
            print(json.dumps(dict(smem_bench=row)), flush=True)
            out.append(row)
        if len({r["out_hash"] for r in out}) > 1:
            cs.fail(f"{kernel} {inp}: the forms' outputs differ")
        return out

    sums = {}
    for kernel, rec in recs.items():  # 4f: every launch, the route's form
        rows = [run(kernel, f"4f_{i}", args, kw)[0]
                for i, (_, args, kw) in enumerate(rec.calls)]
        sums[kernel] = dict(launches=len(rows), **{
            t: sum(r[t] or 0.0 for r in rows)
            for t in ("ms", "busy_ms", "kernel_ms")})
    both = fm_ops.SMEM_FORMS if has_form else (None,)
    idx1 = DeviceFMIndex(fm, device="cuda", occ_r=1).tree()
    for tree, r in ((eng.idx, 4), (idx1, 1)):  # forms
        k10a = recs["K10a"].calls
        for inp, (_, args, kw) in (("first", k10a[0]), ("pass2", k10a[-1])):
            run("K10a", f"{inp}_R{r}", [tree, *args[1:]], kw, both)
        for kernel in ("K10b", "K11"):
            _, args, kw = recs[kernel].calls[0]
            run(kernel, f"first_R{r}", [tree, *args[1:]], kw)

    rfm, rq, rql, rx = repeat_input(d, cs.SEED + 30)
    cap = rq.shape[1] + 2
    rqt, rlt = torch.from_numpy(rq).cuda(), torch.from_numpy(rql).cuda()
    act = torch.ones(len(rql), dtype=torch.bool, device="cuda")
    for r in (1, 4):  # repeat: occtab rows of R blocks
        ridx = DeviceFMIndex(rfm, device="cuda", occ_r=r).tree()
        ones = torch.ones(len(rql), dtype=ridx["cdt"], device="cuda")
        run("K10a", f"repeat_R{r}", [ridx, rqt, rlt,
                                     torch.from_numpy(rx).cuda(), ones, 0,
                                     act, cap], {}, both)
        run("K11", f"repeat_R{r}", [
            ridx, rqt, rlt, opt.min_seed_len,
            int(opt.min_seed_len * opt.split_factor + 0.499),
            opt.split_width, opt.max_mem_intv],
            dict(cap=cap, cap_s=96, key64=False))

    rng = np.random.default_rng(cs.SEED + 31)  # scratch: 8,000-base reads
    L = 8000
    starts = rng.integers(0, len(codes) - L, 512)
    lq = np.stack([codes[s:s + L] for s in starts])
    lq[np.arange(512)[:, None], rng.integers(0, L, (512, 8))] = \
        rng.integers(0, 4, (512, 8))
    lx = rng.integers(0, L, 512).astype(np.int32)
    lqt = torch.from_numpy(lq).cuda()
    llt = torch.full((512,), L, dtype=torch.int32, device="cuda")
    ones = torch.ones(512, dtype=eng.idx["cdt"], device="cuda")
    act = torch.ones(512, dtype=torch.bool, device="cuda")
    run("K10a", "scratch_R4", [eng.idx, lqt, llt, torch.from_numpy(lx).cuda(),
                               ones, 0, act, L + 2], {}, both)
    run("K11", "scratch_R4", [
        eng.idx, lqt, llt, opt.min_seed_len,
        int(opt.min_seed_len * opt.split_factor + 0.499), opt.split_width,
        opt.max_mem_intv], dict(cap=L + 2, cap_s=512, key64=False))
    print(json.dumps(dict(smem_bench_4f_sums=dict(card=card, root=str(root),
                                                  **sums))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
