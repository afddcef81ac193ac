from bwa_tpu_torch.utils.rand48 import Rand48  # noqa: F401
from bwa_tpu_torch.utils.hash64 import hash_64  # noqa: F401
