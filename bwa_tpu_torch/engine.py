"""Engine construction: the batched seeding engine on an explicit device.

"cuda" (the default) runs the seeding machine and the band extension as
the hand-written CUDA kernels; "cpu" runs their plain PyTorch versions
(the tests' setting).  Nothing is probed: a CUDA engine on a machine
without a card raises.
"""

from __future__ import annotations

import torch


def make_engine(fm, device: str | torch.device = "cuda"):
    from bwa_tpu_torch.ops.fm import BatchedFMEngine

    return BatchedFMEngine(fm, device=device)
