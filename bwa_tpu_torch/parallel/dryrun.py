"""The mesh's dry run: paired-end mem, the production pipeline and `aln`
over an n-shard mesh, each held byte for byte to one device.

    python -m bwa_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

dryrun_multichip(n, device) runs on a small genome made from a seed
(FMIndex.build_in_memory) and asserts:
  * per-shard seeding (mesh.sharded_seed_machine), per-shard chaining,
    extension, pairing and SAM on the host, with the insert-size
    candidates gathered in shard order (mesh.pestat_allgather): PE SAM
    equal to one worker's;
  * process_seqs on a mesh engine: SAM equal to a single-device engine's;
  * aln_batch_device on a mesh engine: .sai bytes equal to a single-device
    engine's.
On "cuda" the mesh is the first n cards when there are that many, else n
shards on the current card; on "cpu" it is n CPU shards.

entry(device) is the JAX package's flagship step (__graft_entry__.entry):
bwt_smem1a and bwt_sa over 64 reads of the same small genome.
"""

from __future__ import annotations

import io
import sys

import numpy as np
import torch


def _tiny_index(n_bases=20000, seed=42):
    from bwa_tpu_torch.index.fmindex import FMIndex

    rng = np.random.default_rng(seed)
    fwd = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    return FMIndex.build_in_memory(fwd)


def _tiny_reads(fm, n=64, L=100, seed=1):
    rng = np.random.default_rng(seed)
    code2 = np.concatenate([fm.pac_codes, (3 - fm.pac_codes)[::-1]])
    q = np.zeros((n, L), dtype=np.uint8)
    for i in range(n):
        s = int(rng.integers(0, fm.l_pac - L))
        q[i] = code2[s:s + L]
        for _ in range(3):
            q[i, int(rng.integers(0, L))] = int(rng.integers(0, 4))
    return q


def entry(device: str = "cuda"):
    """(fn, example_args): the JAX package's flagship device step
    (__graft_entry__.entry) in the port -- one bwt_smem1a call a read from
    position 0 (ops/fm.py::smem1a_batch, kernel K10a on a card), then
    bwt_sa of each read's first mem's first row (sa_batch, K9) -- over
    64 reads of 100 bases (three substitutions each) on _tiny_index's
    20 kb genome, on `device`.  fn(idx, q, qlen, x, minv, active) returns
    (ret, mem_n, pos)."""
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex
    from bwa_tpu_torch.ops import fm as fm_ops

    fm = _tiny_index()
    dev = torch.device(device)
    idx = DeviceFMIndex(fm, device=dev).tree()
    q = _tiny_reads(fm)
    B, L = q.shape
    cdt = idx["cdt"]
    x, active = np.zeros(B, np.int32), np.ones(B, bool)
    form = fm_ops.smem1a_form(x, active)  # on the host's arrays

    def fn(idx, q, qlen, x, minv, active):
        ret, m0, _, _, _, _, mem_n = fm_ops.smem1a_batch(
            idx, q, qlen, x, minv, 0, active, L + 2, form=form)
        pos = fm_ops.sa_batch(idx, torch.where(mem_n > 0, m0[:, 0],
                                               torch.ones_like(m0[:, 0])))
        return ret, mem_n, pos

    return fn, (idx, torch.from_numpy(q).to(dev),
                torch.full((B,), L, dtype=torch.int32, device=dev),
                torch.from_numpy(x).to(dev),
                torch.ones(B, dtype=cdt, device=dev),
                torch.from_numpy(active).to(dev))


def dry_mesh(n_devices: int, device: str):
    """The dry run's mesh of n_devices shards on `device`."""
    from bwa_tpu_torch.parallel.mesh import make_mesh

    if device == "cuda" and torch.cuda.device_count() >= n_devices:
        return make_mesh(n_devices)
    return make_mesh(devices=[device] * n_devices)


def _pe_batch(fm, n_pairs, L=100):
    """n_pairs FR pairs of L-base reads from the genome (fragments of 250
    to 400 bases, two substitutions a read), interleaved."""
    rng = np.random.default_rng(7)
    code2 = np.concatenate([fm.pac_codes, (3 - fm.pac_codes)[::-1]])
    q = np.zeros((2 * n_pairs, L), np.uint8)
    for p in range(n_pairs):
        frag = int(rng.integers(250, 400))
        s = int(rng.integers(0, fm.l_pac - frag))
        q[2 * p] = code2[s:s + L]
        q[2 * p + 1] = (3 - code2[s + frag - L:s + frag])[::-1]
        for _ in range(2):
            q[2 * p, int(rng.integers(0, L))] = int(rng.integers(0, 4))
            q[2 * p + 1, int(rng.integers(0, L))] = int(rng.integers(0, 4))
    return q


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The paired-end pipeline sharded over an n_devices "dp" mesh, with
    production shardings: per-shard device seeding (the unified three-pass
    machine, kernel K1 on a card, against each device's index tree),
    per-shard chaining/extension/pairing/SAM on the host, and the
    pipeline's one batch-global collective, the mem_pestat insert-size
    gather (bwamem.c:1256-1259).  Asserts the shard-order SAM bytes equal
    a single worker's; then the production process_seqs and aln over a
    mesh engine against single-device engines (module docstring)."""
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.mem.batch_seed import CachedSeedEngine
    from bwa_tpu_torch.mem.pairing import (pestat_candidates,
                                           pestat_from_candidates, sam_pe)
    from bwa_tpu_torch.mem.pipeline import align1_core, process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.ops.fm import BatchedFMEngine
    from bwa_tpu_torch.options import MEM_F_PE, MemOptions
    from bwa_tpu_torch.parallel.mesh import (pestat_allgather,
                                             sharded_seed_machine)

    fm = _tiny_index(n_bases=20000)
    mesh = dry_mesh(n_devices, device)
    eng_mesh = make_engine(fm, device, mesh=mesh)
    if eng_mesh.mesh is not mesh:
        raise AssertionError("make_engine must route through the mesh")
    opt = MemOptions()
    opt.flag |= MEM_F_PE
    opt.T = 20

    # enough FR pairs that mem_pestat fits a distribution (MIN_DIR_CNT)
    # even on small meshes, an equal slice a shard
    L = 100
    pairs_per_shard = max(4, -(-32 // n_devices))
    n_pairs = pairs_per_shard * n_devices
    B = 2 * n_pairs
    q = _pe_batch(fm, n_pairs, L)
    codes = [q[i] for i in range(B)]

    cap_s = 24
    seed_step = sharded_seed_machine(eng_mesh.trees, mesh, opt, cap=L + 2,
                                     cap_s=cap_s)
    seeds, seed_n, ovf = seed_step(q, np.full(B, L, np.int32))
    seeds, seed_n = seeds.cpu().numpy(), seed_n.cpu().numpy()
    if ovf.any():
        raise AssertionError("the dry run's seeding overflowed")

    def regs_for(i):
        n = int(seed_n[i])
        mems = [(int(seeds[i, j, 0]), int(seeds[i, j, 1]),
                 int(seeds[i, j, 2]),
                 (int(seeds[i, j, 3]) << 32) | int(seeds[i, j, 4]))
                for j in range(n)]
        cache = {int(seeds[i, j, 0]) + k: int(fm.sad[int(seeds[i, j, 0]) + k])
                 for j in range(n) for k in range(int(seeds[i, j, 2]))}
        return align1_core(opt, CachedSeedEngine(fm, cache), fm, codes[i],
                           mems=mems)

    def pair_sam(pes, gp, regs):
        rd = [Read(name=f"p{gp}", seq=codes[2 * gp].tobytes(), qual=None),
              Read(name=f"p{gp}", seq=codes[2 * gp + 1].tobytes(),
                   qual=None)]
        sam_pe(opt, fm, pes, gp, rd, [codes[2 * gp], codes[2 * gp + 1]],
               regs, None)
        return rd[0].sam + rd[1].sam

    # ---- sharded: per-shard regs -> candidate gather -> pes -> SAM
    shard_regs = [[regs_for(s * 2 * pairs_per_shard + j)
                   for j in range(2 * pairs_per_shard)]
                  for s in range(n_devices)]
    cap_c = pairs_per_shard
    parts = []
    for s, dev in enumerate(mesh.devices):
        rows = np.full((cap_c, 2), -1, np.int32)
        for j, (d, dist) in enumerate(
                pestat_candidates(opt, fm.l_pac, shard_regs[s])[:cap_c]):
            rows[j] = (d, dist)
        parts.append(torch.from_numpy(rows).to(dev))
    gathered = pestat_allgather(mesh)(parts).cpu().numpy()
    pes_sharded = pestat_from_candidates(
        opt, [(int(d), int(x)) for d, x in gathered if d >= 0])
    sam_sharded = "".join(
        pair_sam(pes_sharded, s * pairs_per_shard + pp,
                 [shard_regs[s][2 * pp], shard_regs[s][2 * pp + 1]])
        for s in range(n_devices) for pp in range(pairs_per_shard))

    # ---- one worker: the same batch
    all_regs = [r for s in range(n_devices) for r in shard_regs[s]]
    pes_single = pestat_from_candidates(
        opt, pestat_candidates(opt, fm.l_pac, all_regs))
    sam_single = "".join(
        pair_sam(pes_single, gp, [all_regs[2 * gp], all_regs[2 * gp + 1]])
        for gp in range(n_pairs))
    if sam_sharded != sam_single:
        raise AssertionError("sharded SAM differs from single-device SAM")
    if sam_sharded.count("\n") < B:
        raise AssertionError("the sharded run wrote too few SAM records")

    # ---- production: process_seqs over the mesh engine against the same
    # pipeline on one device
    b2a = np.frombuffer(b"ACGTN", np.uint8)

    def pipeline_sam(eng):
        reads = [Read(name=f"p{p}", seq=b2a[q[2 * p + e]].tobytes(),
                      qual=b"I" * L)
                 for p in range(n_pairs) for e in (0, 1)]
        process_seqs(opt, eng, fm, reads)
        return "".join(r.sam for r in reads)

    eng_one = BatchedFMEngine(fm, device=mesh.devices[0])
    sam_mesh = pipeline_sam(eng_mesh)
    if sam_mesh != pipeline_sam(eng_one):
        raise AssertionError("mesh-routed process_seqs differs from "
                             "single-device")
    if sam_mesh.count("\n") < B:
        raise AssertionError("the mesh pipeline wrote too few SAM records")

    # ---- aln over the mesh: K7 a shard (mesh.gap_machine_sharded), .sai
    # bytes against the single-device run of the same batch
    from types import SimpleNamespace

    from bwa_tpu_torch.aln.batch_search import aln_batch_device
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.aln.sai import SaiWriter

    qa = _tiny_reads(fm, n=64, L=100, seed=5)
    pk = SimpleNamespace(n=64, lens=np.full(64, 100, np.int32),
                         codes_flat=qa.reshape(-1),
                         codes_off=(np.arange(65) * 100).astype(np.int64))
    gopt = GapOpt()

    def sai_bytes(eng):
        out_n, rows = aln_batch_device(fm, eng, pk, gopt)
        b = io.BytesIO()
        SaiWriter(b, gopt).write_batch_raw(out_n, rows)
        return b.getvalue()

    sai_mesh = sai_bytes(eng_mesh)
    if sai_mesh != sai_bytes(eng_one):
        raise AssertionError("sharded aln .sai differs from single-device")
    if not sai_mesh:
        raise AssertionError("the mesh aln wrote no .sai bytes")


def _main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="bwa_tpu_torch.parallel.dryrun")
    ap.add_argument("n", nargs="?", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    n = a.n or max(2, torch.cuda.device_count() if a.device == "cuda" else 8)
    dryrun_multichip(n, a.device)
    print(f"dryrun_multichip OK: {dry_mesh(n, a.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
