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
