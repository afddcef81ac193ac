"""The port's extension kernel entry point (bwa_tpu_torch/ops/ksw_pallas.py,
plain versions of K5 and of K2's host-array mode on the CPU) equals the JAX
package's Pallas kernels in interpret mode, output for output."""

import numpy as np
import pytest
import torch

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


_SHAPES = [(1, 37, 80, 150, 100), (2, 64, 128, 128, -1),
           (3, 16, 33, 300, 20), (4, 8, 700, 900, 100)]


@pytest.mark.parametrize("kind,seed,n,q,t,zdrop",
                         [("full", *s) for s in _SHAPES[:3]]
                         + [("band", *s) for s in _SHAPES])
def test_entry_point_matches_jax(kind, seed, n, q, t, zdrop):
    from bwa_tpu.ops import ksw_pallas as jax_kp

    from bwa_tpu_torch.bench_kernel import entry_args, ragged_problems
    from bwa_tpu_torch.ops import ksw_pallas as torch_kp

    problems = ragged_problems(seed, n, q, t)
    assert (problems[1] < q).any()
    args = entry_args(problems, zdrop)
    name = "extend_batch_pallas" if kind == "full" else "extend_band_pallas"
    want = getattr(jax_kp, name)(*args, interpret=True)
    got = getattr(torch_kp, name)(*args, device="cpu")
    for field, a, b in zip(("score", "qle", "tle", "gtle", "gscore",
                            "max_off"), want, got):
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("kind,q,w_hi", [("full", 4300, 900),
                                         ("band", 4300, 2300)])
def test_entry_point_past_4096_matches_jax_spec(kind, q, w_hi):
    """Past the widths the first kernels refused: extend_batch_pallas at
    Q = 4,300 (QP = 4,352) and extend_band_pallas at P = 4,608 (bands up
    to 2,299), on the CPU, against the JAX package's XLA spec
    bwa_tpu.ops.ksw_batch.extend_batch (cheaper here than the Pallas
    kernels in interpret mode at that width)."""
    import jax.numpy as jnp

    from bwa_tpu.ops.ksw_batch import extend_batch

    from bwa_tpu_torch.bench_kernel import entry_args, ragged_problems
    from bwa_tpu_torch.ops import ksw_pallas as torch_kp
    from bwa_tpu_torch.ops.ext_gather import band_clamp
    from bwa_tpu_torch.ops.ksw_band import _band_for

    qs, qlens, ts, tlens, mat, ws, h0s = ragged_problems(9, 4, q, 240, w_hi)
    qlens[:2] = q
    ws[0] = w_hi - 1
    args = entry_args((qs, qlens, ts, tlens, mat, ws, h0s))
    want = extend_batch(jnp.asarray(qs), jnp.asarray(qlens),
                        jnp.asarray(ts), jnp.asarray(tlens),
                        jnp.asarray(mat), 6, 1, 6, 1, jnp.asarray(ws), 5,
                        args[11], jnp.asarray(h0s), max_tlen=ts.shape[1])
    name = "extend_batch_pallas" if kind == "full" else "extend_band_pallas"
    got = getattr(torch_kp, name)(*args, device="cpu")
    for field, a, b in zip(("score", "qle", "tle", "gtle", "gscore",
                            "max_off"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=field)
    wc = band_clamp(qlens, ws, 1, 6, 1, 6, 1, 5)
    assert _band_for(int(wc.max())) > 4096 or kind == "full"
    assert int(np.asarray(want[0]).max()) > 60
