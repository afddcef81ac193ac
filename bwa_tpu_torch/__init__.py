"""bwa_tpu_torch — the bwa-tpu read aligner ported to PyTorch and CUDA.

Host layers (FASTQ/SAM text, index construction, the C++ finalize) are the
same algorithms as the JAX package, held here as the port's own copies; the
device side runs on a CUDA card through hand-written kernels (csrc/), with a
plain PyTorch version of every kernel beside it for CPU tensors.
"""

__version__ = "0.1.0"

from bwa_tpu_torch.options import MemOptions  # noqa: F401
