"""Engine construction: the batched seeding engine on an explicit device.

"cuda" (the default) runs the seeding machine and the band extension as
the hand-written CUDA kernels; "cpu" runs their plain PyTorch versions
(the tests' setting).  Nothing is probed: a CUDA engine on a machine
without a card raises.

With more than one card visible and BWA_TPU_MESH not "off", a "cuda"
engine is a mesh over all of them (parallel/mesh.py), as the JAX package
meshes every visible chip; a "cpu" engine, or one on a named card such as
"cuda:1", is never meshed unless the caller passes `mesh`.
"""

from __future__ import annotations

import os

import torch


def make_engine(fm, device: str | torch.device = "cuda", mesh=None):
    from bwa_tpu_torch.ops.fm import BatchedFMEngine

    if mesh is None and auto_mesh(device):
        from bwa_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
    return BatchedFMEngine(fm, device=device, mesh=mesh)


def auto_mesh(device) -> bool:
    """Whether make_engine meshes an engine on `device` by itself."""
    d = torch.device(device)
    return (d.type == "cuda" and d.index is None
            and os.environ.get("BWA_TPU_MESH", "auto") != "off"
            and torch.cuda.is_available() and torch.cuda.device_count() > 1)
