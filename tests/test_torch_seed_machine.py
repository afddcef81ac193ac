"""The port's seeding machine (plain version) against the JAX package's
fm_machine.seed_machine + sort_seeds: seeds, seed_n and the overflow flags
must be equal.  Kernel K1 is held to the plain version in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datagen import random_genome, simulate_reads, write_fasta
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build
    from bwa_tpu.index.fmindex import FMIndex as JFM
    from bwa_tpu.index.fmindex import DeviceFMIndex as JDev
    from bwa_tpu_torch.index.fmindex import FMIndex, DeviceFMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_seed")
    g = random_genome(150_000, seed=41, n_contigs=2)
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    fm = FMIndex.load(prefix)
    codes = lambda rs: [NT4_TABLE[np.frombuffer(s, np.uint8)]  # noqa: E731
                        for _, s, _ in rs]
    short = codes(simulate_reads(g, 24, read_len=150, seed=5,
                                 err_rate=0.02))
    long = codes(simulate_reads(g, 2, read_len=600, seed=6, err_rate=0.05,
                                indel_rate=0.01))
    return dict(jt=JDev(JFM.load(prefix)).tree(), fm=fm,
                tt=DeviceFMIndex(fm, device="cpu").tree(), short=short,
                long=long)


def _packed_pairs(codes, L):
    """pack_k=2 lanes: read i | N | read B2+i | N (mem/batch_seed.py)."""
    B2 = len(codes) // 2
    q = np.full((B2, 2 * (L + 1)), 4, np.uint8)
    ql = np.zeros(B2, np.int32)
    for r in range(2):
        for i in range(B2):
            c = codes[r * B2 + i]
            q[i, r * (L + 1):r * (L + 1) + len(c)] = c
            ql[i] = r * (L + 1) + len(c)
    return q, ql


def _lanes(world, kind):
    from bwa_tpu_torch.mem.batch_seed import _pack_bucket
    from bwa_tpu_torch.options import MemOptions

    if kind == "pack2":
        return _packed_pairs(world["short"], 192) + (None,)
    if kind == "plain":
        q, ql = _packed_pairs(world["short"][:8], 192)
        q[:, :40] = q[:, 40:80]  # a repeat inside each lane
        return q, ql, None
    opt = MemOptions()
    opt.apply_mode("pacbio")
    q, ql, L, B2, pack_k, cs, shard, ns = _pack_bucket(opt, world["long"], 64)
    n = len(world["long"]) * ns
    return q[:n], ql[:n], tuple(a[:n] for a in shard)


CASES = [  # (lanes, stack cap, seed cap, pass 3)
    ("pack2", 16, 48, True),
    ("pack2", 2, 6, True),
    ("pack2", 16, 48, False),
    ("plain", 16, 48, True),
    ("shard", 16, 96, True),
    ("shard", 3, 8, True),
]


def _consts(kind):
    # (min_seed_len, split_len, split_width, max_mem_intv): mem defaults,
    # and the pacbio preset's split factor for sharded long reads
    return (17, 170, 10, 20) if kind == "shard" else (19, 28, 10, 20)


def _jax_machine(world, q, ql, shard, consts, cap, cap_s, use_p3):
    from bwa_tpu.ops import fm_machine as jm
    from bwa_tpu.ops.fm import _next_valid_device

    qd, qld = jnp.asarray(q), jnp.asarray(ql)
    s, n, _, o, _ = jm.seed_machine(
        world["jt"], qd, qld, _next_valid_device(qd, qld),
        *(np.int32(c) for c in consts), cap=cap, cap_s=cap_s, use_p3=use_p3,
        shard=shard)
    return (np.asarray(jm.sort_seeds(s, n, key64=False)), np.asarray(n),
            np.asarray(o))


def _torch_machine(tt, q, ql, shard, consts, cap, cap_s, use_p3):
    from bwa_tpu_torch.ops import fm_machine as tm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    qd = torch.from_numpy(q)
    qld = torch.from_numpy(ql)
    s, n, _, o, _ = tm.seed_machine(tt, qd, qld, _next_valid_device(qd, qld),
                                    *consts, cap=cap, cap_s=cap_s,
                                    use_p3=use_p3, shard=shard)
    return (tm.sort_seeds(s, n, key64=False).cpu().numpy(), n.cpu().numpy(),
            o.cpu().numpy())


@pytest.mark.parametrize("kind,cap,cap_s,use_p3", CASES)
def test_plain_machine_matches_jax(world, kind, cap, cap_s, use_p3):
    q, ql, shard = _lanes(world, kind)
    consts = _consts(kind)
    want = _jax_machine(world, q, ql, shard, consts, cap, cap_s, use_p3)
    got = _torch_machine(world["tt"], q, ql, shard, consts, cap, cap_s,
                         use_p3)
    for g, w, name in zip(got, want, ("seeds", "seed_n", "ovf")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if cap <= 3:
        assert want[2].any()  # the tiny caps do overflow
    if shard is not None:
        assert set(np.unique(want[0][:, :, 5])) - {0}  # provenance tags


def test_engine_collect_seeds_matches_jax(world):
    """The engine's host-facing arrays (width-dieted, overflow-flagged)."""
    from bwa_tpu.ops.fm import BatchedFMEngine as JEngine
    from bwa_tpu.index.fmindex import FMIndex as JFM
    from bwa_tpu_torch.ops.fm import BatchedFMEngine
    from bwa_tpu_torch.options import MemOptions

    opt = MemOptions()
    q, ql, _ = _lanes(world, "pack2")
    fm = world["fm"]
    got = BatchedFMEngine(fm, device="cpu").collect_seeds(q, ql, opt, 48,
                                                          stack_cap=3)
    want = JEngine(JFM.load(fm.prefix)).collect_seeds(q, ql, opt, 48,
                                                      stack_cap=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
