"""The cross-check programs in plain PyTorch against the JAX package on its
CPU backend, tolerance 0 (integers throughout): sa_batch (bwt_sa, kernel
K9's plain version), the engine's smem_pass and seed3_pass (bwt_smem1a
and bwt_seed_strategy1 one read a lane, K10a and K10b), collect_seeds
(fused=True) (collect_intv_device, K11), collect_intv_batch_unfused,
sharded_seed_step on a mesh of CPU shards, and the dry run's entry().
The reads are simulated ones (real SMEM structure) and random ones with
Ns, as tests/test_fm_device.py draws them.  The kernels are held to these
plain versions in test_torch_cuda.py."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datagen import random_genome, simulate_reads, write_fasta
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


def _random_reads(n, L, seed):
    """Random reads of 30..L bases, half of them with an N."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(30, L + 1))
        r = rng.integers(0, 4, size=ln).astype(np.uint8)
        if rng.random() < 0.5:
            r[rng.integers(0, ln)] = 4
        out.append(r)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build
    from bwa_tpu.index.fmindex import FMIndex as JFM
    from bwa_tpu.ops.fm import BatchedFMEngine as JEngine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE
    from bwa_tpu_torch.ops.fm import BatchedFMEngine

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_crosscheck")
    g = random_genome(130_000, seed=43, n_contigs=2)
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    codes = [NT4_TABLE[np.frombuffer(s, np.uint8)]
             for _, s, _ in simulate_reads(g, 40, read_len=150, seed=23,
                                           err_rate=0.02)]
    codes += _random_reads(16, 150, seed=1)
    old = os.environ.get("BWA_TPU_MESH")
    os.environ["BWA_TPU_MESH"] = "off"  # one JAX device: no shard_map
    try:
        jeng = JEngine(JFM.load(prefix))
    finally:
        if old is None:
            os.environ.pop("BWA_TPU_MESH")
        else:
            os.environ["BWA_TPU_MESH"] = old
    fm = FMIndex.load(prefix)
    return dict(prefix=prefix, fm=fm, jeng=jeng, codes=codes,
                eng=BatchedFMEngine(fm, device="cpu"))


def _pad(codes):
    L = max(len(c) for c in codes)
    q = np.full((len(codes), L), 4, np.uint8)
    lens = np.array([len(c) for c in codes], np.int32)
    for i, c in enumerate(codes):
        q[i, :len(c)] = c
    return q, lens


def _tree64(tt):
    """The CPU tree with its coordinates held as int64 (the 2*l_pac+2 >=
    2^31 regime) over the same index."""
    return dict(tt, cdt=torch.int64, L2=tt["L2"].long(),
                ckpt=tt["ckpt"].long(), ssa=tt["ssa"].long())


def _equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_array_equal(g.astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=f"{what}: output {i}")


def test_sa_batch_matches_jax(world):
    from bwa_tpu.ops.fm import sa_batch as jsa
    from bwa_tpu_torch.ops.fm import sa_batch

    fm = world["fm"]
    rng = np.random.default_rng(0)
    ks = np.concatenate([rng.integers(0, fm.seq_len + 1, 600),
                         [0, fm.primary, fm.seq_len, 32, 31]])
    want = np.asarray(jsa(world["jeng"].idx, jnp.asarray(ks.astype(np.int32))))
    tt = world["eng"].idx
    got = sa_batch(tt, torch.from_numpy(ks.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    ok = ks < fm.seq_len
    np.testing.assert_array_equal(want[ok], fm.sa_lookup(ks[ok]))
    got64 = sa_batch(_tree64(tt), torch.from_numpy(ks))
    assert got64.dtype == torch.int64
    np.testing.assert_array_equal(got64.numpy(), want)


def test_sa_batch_refuses_a_light_index(world):
    from bwa_tpu_torch.ops.fm import sa_batch

    tt = {k: v for k, v in world["eng"].idx.items() if k != "ssa"}
    with pytest.raises(ValueError, match="sampled suffix array"):
        sa_batch(tt, torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("max_intv,cap", [(0, None), (30, None), (0, 2)],
                         ids=["max0", "max30", "cap2"])
def test_smem_pass_matches_jax(world, max_intv, cap):
    q, lens = _pad(world["codes"])
    B, L = q.shape
    cap = cap or L + 2
    rng = np.random.default_rng(2)
    xs = np.array([rng.integers(0, max(1, n - 5)) for n in lens], np.int32)
    minv = rng.integers(1, 3, B).astype(np.int64)
    active = rng.random(B) < 0.9
    args = (q, lens, xs, minv, max_intv, active, cap)
    want = world["jeng"].smem_pass(*args)
    got = world["eng"].smem_pass(*args)
    _equal(got, want, "smem_pass")
    assert (want[6] > 0).sum() > B // 2
    if cap < 10:  # the tiny cap overflows the lists: other mems
        full = world["jeng"].smem_pass(*args[:-1], L + 2)
        assert (want[6] != full[6]).any()


def test_smem1a_int64_coordinates(world):
    from bwa_tpu_torch.ops.fm import smem1a_batch

    q, lens = _pad(world["codes"])
    B, L = q.shape
    tt = world["eng"].idx
    a = [torch.from_numpy(v) for v in (q, lens, np.zeros(B, np.int32))]
    ones = torch.ones(B, dtype=torch.int64)
    act = torch.ones(B, dtype=torch.bool)
    got = smem1a_batch(_tree64(tt), *a, ones, 0, act, L + 2)
    want = smem1a_batch(tt, *a, ones.int(), 0, act, L + 2)
    assert got[1].dtype == torch.int64
    _equal(got, want, "smem1a int64 against int32")


@pytest.mark.parametrize("min_len,max_intv", [(19, 20), (12, 5)])
def test_seed3_pass_matches_jax(world, min_len, max_intv):
    q, lens = _pad(world["codes"])
    B = q.shape[0]
    rng = np.random.default_rng(3)
    xs = np.array([rng.integers(0, n) for n in lens], np.int32)
    active = rng.random(B) < 0.9
    args = (q, lens, xs, min_len, max_intv, active)
    want = world["jeng"].seed3_pass(*args)
    got = world["eng"].seed3_pass(*args)
    _equal(got, want, "seed3_pass")
    assert want[1].any()


@pytest.mark.parametrize("cap_s", [96, 4])
def test_collect_seeds_fused_matches_jax(world, cap_s):
    from bwa_tpu.options import MemOptions as JOpt
    from bwa_tpu_torch.options import MemOptions

    q, lens = _pad(world["codes"][:24] + world["codes"][-8:])
    want = world["jeng"].collect_seeds(q, lens, JOpt(), cap_s, fused=True)
    got = world["eng"].collect_seeds(q, lens, MemOptions(), cap_s,
                                     fused=True)
    _equal(got, want, "collect_seeds(fused=True)")
    if cap_s < 10:
        assert (want[5] > cap_s).any()


def test_collect_intv_device_int64(world):
    from bwa_tpu_torch.ops.fm import collect_intv_device

    q, lens = _pad(world["codes"][:12])
    tt = world["eng"].idx
    a = (torch.from_numpy(q), torch.from_numpy(lens), 19, 28, 10, 20)
    got = collect_intv_device(_tree64(tt), *a, cap=q.shape[1] + 2,
                              cap_s=64, key64=False)
    want = collect_intv_device(tt, *a, cap=q.shape[1] + 2, cap_s=64,
                               key64=False)
    assert got[0].dtype == torch.int64
    _equal(got, want, "collect_intv_device int64 against int32")


def test_collect_intv_batch_unfused_matches_jax(world):
    from bwa_tpu.mem.batch_seed import collect_intv_batch_unfused as jun
    from bwa_tpu.options import MemOptions as JOpt
    from bwa_tpu_torch.mem.batch_seed import (collect_intv_batch,
                                              collect_intv_batch_unfused)
    from bwa_tpu_torch.options import MemOptions

    codes = world["codes"][:20] + world["codes"][-6:]
    want = jun(JOpt(), world["jeng"], codes)
    got = collect_intv_batch_unfused(MemOptions(), world["eng"], codes)
    assert got == want
    # and the unified machine's per-read seeds
    assert collect_intv_batch(MemOptions(), world["eng"], codes) == want
    assert sum(map(len, want)) > len(codes)


def test_sharded_seed_step_matches_jax(world):
    from bwa_tpu.parallel.mesh import make_mesh as jmesh
    from bwa_tpu.parallel.mesh import sharded_seed_step as jstep
    from bwa_tpu_torch.parallel.mesh import make_mesh, sharded_seed_step

    q, lens = _pad(world["codes"][:28] + world["codes"][-4:])
    B, L = q.shape
    rng = np.random.default_rng(5)
    xs = np.array([rng.integers(0, n) for n in lens], np.int32)
    jfn = jstep(world["jeng"].idx, jmesh(4), L + 2)
    want = [np.asarray(o) for o in jfn(jnp.asarray(q), jnp.asarray(lens),
                                       jnp.asarray(xs))]
    mesh = make_mesh(devices=["cpu"] * 4)
    trees = {mesh.devices[0]: world["eng"].idx}
    got = sharded_seed_step(trees, mesh, L + 2)(q, lens, xs)
    _equal(got, want, "sharded_seed_step")
    assert int(want[3]) > B // 2


def test_dryrun_entry_matches_jax():
    import importlib
    import sys
    from pathlib import Path

    from bwa_tpu_torch.parallel.dryrun import entry

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        graft = importlib.import_module("__graft_entry__")
    finally:
        sys.path.pop(0)
    jfn, jargs = graft.entry()
    want = [np.asarray(o) for o in jfn(*jargs)]
    fn, args = entry("cpu")
    got = fn(*args)
    _equal(got, want, "entry()")
    assert (want[1] > 0).all()
