"""Reads data-parallel over the cards of one host.

The reference's parallelism is pthread data-parallelism over reads with
one shared index (kthread.c, bwashm.c).  The JAX package runs it as
shard_map over a one-axis "dp" mesh; here the same scheme in PyTorch:

  * a mesh is an ordered tuple of devices and an axis name; a device may
    repeat (two shards on one card, or CPU shards in the tests);
  * the index is uploaded once to every distinct device (the engine keeps
    a tree a device, BatchedFMEngine.trees) and each shard reads its own
    device's copy;
  * a batch's lanes split into one contiguous block a shard in lane order,
    as P("dp") splits the leading axis; every shard's inputs go up and
    every shard's kernels are queued before any shard is waited on, so
    cards overlap;
  * outputs join in shard order; a batch-wide scalar (the machine's
    steps) is the maximum over shards, as the JAX package's pmax;
  * the PE pipeline's one batch-global collective, the insert-size
    candidates of mem_pestat (bwamem.c:1256-1259), is a gather in shard
    order (pestat_allgather); the JAX package's psums (sharded_seed_step)
    are sums over the shards in shard order.

A shard whose launch fails raises; nothing falls back to fewer devices.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class Mesh:
    """An ordered tuple of torch devices along one named axis."""

    def __init__(self, devices, axis: str = "dp"):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> tuple:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def _device(d) -> torch.device:
    """d as a torch.device with its index (a bare "cuda" is the current
    card), so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              devices=None) -> Mesh:
    """The first n_devices visible cards (all of them by default), or the
    devices given (which may repeat: ["cpu"] * 8 in the tests, ["cuda:0",
    "cuda:0"] for two shards on one card).  Raises with fewer cards than
    asked for."""
    if devices is not None:
        devices = list(devices)
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             f"devices given")
        return Mesh(devices, axis)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n < 1 or count < n:
        raise RuntimeError(
            f"need {max(n, 1)} CUDA devices, have {count} (pass devices="
            f"[...] for a mesh of repeated or CPU devices)")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def guard(device: torch.device):
    """A context in which `device` is the thread's current CUDA device
    (nothing for a CPU device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def blocks(n: int, size: int) -> list[slice]:
    """The lanes of each of `size` shards: n // size contiguous lanes
    each, in lane order (n a multiple of size)."""
    if n % size:
        raise ValueError(f"{n} lanes do not split over {size} shards")
    per = n // size
    return [slice(s * per, (s + 1) * per) for s in range(size)]


def _to(a, sl: slice, dev: torch.device):
    """Rows sl of a (a numpy array or a tensor on any device) on dev."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
    return a[sl].to(dev)


def _join(parts, dev: torch.device):
    return torch.cat([p.to(dev) for p in parts])


class ShardedMachine:
    """The production seeding step (collect_seeds_dispatch's machine and
    per-lane sort) over a mesh; see machine_sharded."""

    def __init__(self, trees, mesh: Mesh, consts: tuple, cap: int,
                 cap_s: int, use_p3: bool, tagged: bool):
        self.trees, self.mesh = trees, mesh
        self.consts, self.cap, self.cap_s = consts, cap, cap_s
        self.use_p3, self.tagged = use_p3, tagged

    def launch(self, q, qlen, *lane_shard) -> list:
        """Queue every shard's machine and sort, waiting on none: one
        (seeds, seed_n, ovf, done_step, steps) a shard, each on its
        shard's device."""
        from bwa_tpu_torch.ops import fm_machine
        from bwa_tpu_torch.ops.fm import _next_valid_device

        if bool(lane_shard) != self.tagged:
            raise ValueError("a tagged step takes (job_lo, hi1, hi3), an "
                             "untagged one none")
        B, L = q.shape
        parts = blocks(B, self.mesh.size)
        ins = [(_to(q, sl, dev), _to(qlen, sl, dev))
               for sl, dev in zip(parts, self.mesh.devices)]
        outs = []
        for sl, dev, (qd, qld) in zip(parts, self.mesh.devices, ins):
            shard = tuple(np.asarray(a)[sl] for a in lane_shard) or None
            with guard(dev):
                nvd = _next_valid_device(qd, qld)
                seeds, seed_n, steps, ovf, done = fm_machine.seed_machine(
                    self.trees[dev], qd, qld, nvd, *self.consts,
                    cap=self.cap, cap_s=self.cap_s, use_p3=self.use_p3,
                    shard=shard)
                seeds = fm_machine.sort_seeds(seeds, seed_n,
                                              key64=bool(L >= 32768))
            outs.append((seeds, seed_n, ovf, done, steps))
        return outs

    def __call__(self, q, qlen, *lane_shard):
        """(sorted seeds, seed_n, ovf, done_step, steps) joined in shard
        order on the mesh's first device; steps (an int) is the longest
        shard's."""
        outs = self.launch(q, qlen, *lane_shard)
        dev = self.mesh.devices[0]
        joined = [_join([o[i] for o in outs], dev) for i in range(4)]
        return (*joined, max(int(o[4]) for o in outs))


def machine_sharded(trees, mesh: Mesh, min_seed_len, split_len,
                    split_width, max_intv3, cap: int, cap_s: int,
                    use_p3: bool, tagged: bool) -> ShardedMachine:
    """The production collect_seeds_dispatch step over the mesh: per-shard
    unified three-pass seeding (fm_machine.seed_machine: kernel K1 on a
    card, its plain version on the CPU) and per-lane sort, each shard
    against its device's index tree (trees: device -> tree), reads split
    over the shards.  This is what `mem` runs a batch on a mesh engine
    (engine.make_engine), so every card of the host seeds, as the
    reference keeps every core busy with kt_for (kthread.c:49-61,
    bwamem.c:1252).

    Returns fn(q, qlen[, job_lo, hi1, hi3]) -> (sorted seeds, seed_n,
    ovf, done_step, steps), with fn.launch for the shards' outputs before
    the join; the lane-sharding inputs are per-lane arrays and split like
    q (tagged=False takes none)."""
    return ShardedMachine(trees, mesh, (min_seed_len, split_len,
                                        split_width, max_intv3),
                          cap, cap_s, use_p3, tagged)


def sharded_seed_machine(trees, mesh: Mesh, opt, cap: int, cap_s: int):
    """machine_sharded with the options' constants, a stack cap of 16 and
    untagged lanes: fn(q, qlen) -> (sorted seeds [B, cap_s, 5], seed_n,
    ovf) (the dry run's step; cap is not read, as in the JAX package)."""
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    fn = machine_sharded(trees, mesh, opt.min_seed_len, split_len,
                         opt.split_width, opt.max_mem_intv, cap=16,
                         cap_s=cap_s, use_p3=bool(opt.max_mem_intv > 0),
                         tagged=False)

    def step(q, qlen):
        seeds, seed_n, ovf, _, _ = fn(q, qlen)
        return seeds, seed_n, ovf

    return step


def sharded_seed_step(trees, mesh: Mesh, cap: int):
    """The JAX package's multi-chip seeding step over the mesh: fn(q, qlen,
    x) runs, on each shard's block of reads against its device's tree, one
    bwt_smem1a call a read from x (ops/fm.py::smem1a_batch, kernel K10a on
    a card) and bwt_sa of each read's first mem's first row
    (ops/fm.py::sa_batch, K9), and sums two batch statistics over the
    shards in shard order (the JAX package's psums): the reads seeded and
    the sum of their positions.  Returns (ret, pos, mem_n) joined in shard
    order on the mesh's first device, n_seeded and mean_pos (0-d tensors
    there)."""
    from bwa_tpu_torch.ops import fm as fm_ops

    def step(q, qlen, x):
        # K10a's form from the host's x (read once, before any shard is
        # queued, where it lies on a card): the wrapper never waits
        xh, lh = (a if isinstance(a, np.ndarray) else a.cpu().numpy()
                  for a in (x, qlen))
        form = fm_ops.smem1a_form(xh, xh < lh)
        parts = blocks(q.shape[0], mesh.size)
        ins = [(_to(q, sl, dev), _to(qlen, sl, dev), _to(x, sl, dev))
               for sl, dev in zip(parts, mesh.devices)]
        outs = []
        for dev, (qd, qld, xd) in zip(mesh.devices, ins):
            idx = trees[dev]
            with guard(dev):
                minv = torch.ones(qd.shape[0], dtype=idx["cdt"],
                                  device=dev)
                ret, m0, _, _, _, _, mem_n = fm_ops.smem1a_batch(
                    idx, qd, qld, xd, minv, 0, xd < qld, cap, form=form)
                has = mem_n > 0
                pos = fm_ops.sa_batch(
                    idx, torch.where(has, m0[:, 0], torch.ones_like(m0[:, 0])))
                outs.append((ret, pos, mem_n, has.sum(dtype=torch.int32),
                             torch.where(has, pos, torch.zeros_like(pos))
                             .sum(dtype=pos.dtype)))
        dev0 = mesh.devices[0]
        n_seeded, mean_pos = outs[0][3].to(dev0), outs[0][4].to(dev0)
        for o in outs[1:]:  # the psums, in shard order
            n_seeded = n_seeded + o[3].to(dev0)
            mean_pos = mean_pos + o[4].to(dev0)
        return (*(_join([o[i] for o in outs], dev0) for i in range(3)),
                n_seeded, mean_pos)

    return step


class ShardedGap:
    """The device backtrack search over a mesh; see gap_machine_sharded."""

    def __init__(self, mesh: Mesh, kw: dict):
        self.mesh, self.kw = mesh, kw

    def launch(self, trees, q, qlen, md, mg, seed_en, sb, wb, active, scal,
               *, max_steps: int, n_lists: int | None = None) -> list:
        """Queue every shard's K7 (or plain version), waiting on none: its
        output dict a shard, each on its shard's device."""
        from bwa_tpu_torch.ops import gap_machine as gm

        parts = blocks(q.shape[0], self.mesh.size)
        ins = [[_to(a, sl, dev) for a in (q, qlen, md, mg, seed_en, sb, wb,
                                          active)]
               for sl, dev in zip(parts, self.mesh.devices)]
        outs = []
        for dev, args in zip(self.mesh.devices, ins):
            with guard(dev):
                outs.append(gm.gap_machine(trees[dev], *args, scal,
                                           max_steps=max_steps,
                                           n_lists=n_lists, **self.kw))
        return outs

    def __call__(self, trees, q, qlen, md, mg, seed_en, sb, wb, active,
                 scal, *, max_steps: int, n_lists: int | None = None):
        """The outputs joined in shard order on the mesh's first device,
        steps the longest shard's."""
        outs = self.launch(trees, q, qlen, md, mg, seed_en, sb, wb, active,
                           scal, max_steps=max_steps, n_lists=n_lists)
        dev = self.mesh.devices[0]
        res = {k: _join([o[k] for o in outs], dev) for k in outs[0]
               if k != "steps"}
        res["steps"] = torch.tensor(
            [max(int(o["steps"][0]) for o in outs)], dtype=torch.int32,
            device=dev)
        return res


def gap_machine_sharded(mesh: Mesh, cap: int, cap_a: int, use_seed: bool,
                        f_gape: bool, f_nonstop: bool,
                        f_loggap: bool) -> ShardedGap:
    """The device backtrack search (ops/gap_machine.py: kernel K7 on a
    card, bwt_match_gap, bwtgap.c:109-264) with reads split over the
    mesh, each shard against its device's tree: the mesh analog of
    bwtaln.c:102's static pthread read partition.  Every per-lane array
    splits with the batch; steps is the slowest shard's.

    fn(trees, q, qlen, md, mg, seed_en, sb, wb, active, scal, *,
    max_steps, n_lists=None) -> gap_machine's output dict."""
    return ShardedGap(mesh, dict(cap=cap, cap_a=cap_a, use_seed=use_seed,
                                 f_gape=f_gape, f_nonstop=f_nonstop,
                                 f_loggap=f_loggap))


def pestat_allgather(mesh: Mesh):
    """The PE pipeline's one batch-global collective: every shard's padded
    (dir, isize) candidate rows, joined in shard order (the mem_pestat
    sync point, bwamem.c:1256-1259).  fn(parts) with one [n, 2] tensor a
    shard returns the [sum n, 2] rows on the mesh's first device; in one
    process the gather is a copy onto that device."""

    def gather(parts):
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} parts for {mesh.size} shards")
        return _join(list(parts), mesh.devices[0])

    return gather
