"""The port's device FM index and FM primitives (bwa_tpu_torch) against the
JAX package's (bwa_tpu), on the CPU: bit patterns and counts must be equal."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datagen import random_genome, write_fasta
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_fm")
    fa = d / "g.fa"
    write_fasta(fa, random_genome(120_000, seed=31, n_contigs=2))
    return index_build(str(fa))


@pytest.fixture(scope="module")
def fms(prefix):
    from bwa_tpu.index.fmindex import FMIndex as JFM
    from bwa_tpu_torch.index.fmindex import FMIndex

    return JFM.load(prefix), FMIndex.load(prefix)


def _jax_tree(jfm, R):
    from bwa_tpu.index.fmindex import DeviceFMIndex as JDev

    old = os.environ.get("BWA_TPU_OCC_R")
    os.environ["BWA_TPU_OCC_R"] = str(R)
    try:
        return JDev(jfm).tree()
    finally:
        if old is None:
            del os.environ["BWA_TPU_OCC_R"]
        else:
            os.environ["BWA_TPU_OCC_R"] = old


def _bits(t, k):
    """uint32 bit-pattern arrays are held as int32 in the port."""
    return t.numpy().view(np.uint32) if k in ("words", "occtab") \
        else t.numpy()


@pytest.mark.parametrize("R", [1, 4])
def test_device_index_bits_and_from_arrays(fms, R):
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex

    jfm, fm = fms
    jt = _jax_tree(jfm, R)
    own = DeviceFMIndex(fm, device="cpu", occ_r=R)
    arrays = dict(primary=int(jt["primary"]), seq_len=int(jt["seq_len"]),
                  l_pac=int(jt["l_pac"]), sa_intv=int(jt["sa_intv"]),
                  **{k: np.asarray(jt[k]) for k in
                     ("L2", "ckpt", "words", "ssa", "pac", "occtab")})
    carried = DeviceFMIndex.from_arrays(arrays, device="cpu")
    for dv in (own, carried):
        assert dv.primary == int(jt["primary"])
        assert dv.seq_len == int(jt["seq_len"])
        for k in ("L2", "ckpt", "words", "ssa", "pac", "occtab"):
            np.testing.assert_array_equal(_bits(getattr(dv, k), k),
                                          np.asarray(jt[k]), err_msg=k)
    assert own.occtab.shape[1] == 4 + 8 * R


def _positions(fm, rng, n=400):
    edge = [-1, 0, 1, fm.primary - 1, fm.primary, fm.primary + 1,
            fm.seq_len - 1, fm.seq_len, 127, 128, 129, 511, 512]
    return np.concatenate([edge, rng.integers(-1, fm.seq_len + 1, n)])


@pytest.mark.parametrize("R", [1, 4])
def test_occ4_extend_set_intv(fms, R):
    from bwa_tpu.ops import fm as jops
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex
    from bwa_tpu_torch.ops import fm as tops

    jfm, fm = fms
    jt = _jax_tree(jfm, R)
    tt = DeviceFMIndex(fm, device="cpu", occ_r=R).tree()
    rng = np.random.default_rng(R)
    k = _positions(fm, rng).astype(np.int32)
    np.testing.assert_array_equal(
        tops._occ4(tt, torch.from_numpy(k)).numpy(),
        np.asarray(jops._occ4(jt, jnp.asarray(k))))
    # intervals of real substrings plus the whole-text interval
    x0 = rng.integers(1, fm.seq_len - 50, 64).astype(np.int32)
    x2 = rng.integers(1, 50, 64).astype(np.int32)
    x1 = rng.integers(1, fm.seq_len - 50, 64).astype(np.int32)
    x0[0], x1[0], x2[0] = 0, 0, fm.seq_len
    for back in (False, True):
        got = tops._extend(tt, *(torch.from_numpy(a) for a in (x0, x1, x2)),
                           back)
        want = jops._extend(jt, *(jnp.asarray(a) for a in (x0, x1, x2)),
                            back)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c = np.array([0, 1, 2, 3, 4, -1], np.int32)
    for g, w in zip(tops._set_intv(tt, torch.from_numpy(c)),
                    jops._set_intv(jt, jnp.asarray(c))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_occ1_b0_and_int64_coords(fms):
    from bwa_tpu.ops import fm as jops
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex
    from bwa_tpu_torch.ops import fm as tops

    jfm, fm = fms
    jt = _jax_tree(jfm, 1)
    tt = DeviceFMIndex(fm, device="cpu").tree()
    rng = np.random.default_rng(9)
    k = rng.integers(0, fm.seq_len, 300).astype(np.int32)
    c = rng.integers(0, 4, 300).astype(np.int32)
    np.testing.assert_array_equal(
        tops._occ1(tt, torch.from_numpy(k), torch.from_numpy(c)).numpy(),
        np.asarray(jops._occ1(jt, jnp.asarray(k), jnp.asarray(c))))
    x = (k - (k > fm.primary)).astype(np.int32)
    np.testing.assert_array_equal(
        tops._B0(tt, torch.from_numpy(x)).numpy(),
        np.asarray(jops._B0(jt, jnp.asarray(x))))
    # int64 coordinates (the 2*l_pac+2 >= 2^31 regime) count the same
    t64 = dict(tt, cdt=torch.int64, L2=tt["L2"].long(), ckpt=tt["ckpt"].long())
    kk = torch.from_numpy(_positions(fm, rng).astype(np.int64))
    a = tops._occ4(tt, kk.int())
    b = tops._occ4(t64, kk)
    assert b.dtype == torch.int64
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_lane_helpers():
    from bwa_tpu.ops import fm as jops
    from bwa_tpu_torch.ops import fm as tops

    rng = np.random.default_rng(4)
    q = rng.integers(0, 5, (9, 40)).astype(np.uint8)
    ql = rng.integers(0, 41, 9).astype(np.int32)
    np.testing.assert_array_equal(
        tops._next_valid_device(torch.from_numpy(q), torch.from_numpy(ql))
        .numpy(), np.asarray(jops._next_valid_device(jnp.asarray(q),
                                                     jnp.asarray(ql))))
    sn = np.array([3, 0, 7], np.int32)
    ov = np.array([False, True, False])
    ds = np.array([5, 9, 2], np.int32)
    np.testing.assert_array_equal(
        tops._pack_meta(torch.from_numpy(sn), torch.from_numpy(ov),
                        torch.from_numpy(ds), 11).numpy(),
        np.asarray(jops._pack_meta(jnp.asarray(sn), jnp.asarray(ov),
                                   jnp.asarray(ds), jnp.int32(11))))


def test_sa_lookup_native_walker(fms, prefix):
    """Without the dense sidecar the port walks the SA natively; both
    routes give the reference's bwt_sa values."""
    from bwa_tpu_torch.index.fmindex import FMIndex

    _, fm = fms
    rng = np.random.default_rng(2)
    ks = rng.integers(0, fm.seq_len + 1, 300)
    dense = fm.sa_lookup(ks)
    walk = FMIndex.load(prefix)
    walk.__dict__["sad"] = None
    np.testing.assert_array_equal(walk.sa_lookup(ks), dense)
