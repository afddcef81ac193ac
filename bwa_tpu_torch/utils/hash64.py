"""Thomas Wang's 64-bit mix hash, bit-exact vs the reference (utils.h:98-109).

Used for deterministic tie-breaking of equal-score alignments
(mem_mark_primary_se, bwamem.c:553) and pair selection (bwamem_pair.c:248).
"""

import numpy as np

_M = (1 << 64) - 1


def hash_64(key: int) -> int:
    key &= _M
    key = (key + ((~(key << 32)) & _M)) & _M
    key ^= key >> 22
    key = (key + ((~(key << 13)) & _M)) & _M
    key ^= key >> 8
    key = (key + (key << 3)) & _M
    key ^= key >> 15
    key = (key + ((~(key << 27)) & _M)) & _M
    key ^= key >> 31
    return key


def hash_64_np(key: np.ndarray) -> np.ndarray:
    """Vectorized hash_64 over a uint64 array."""
    key = key.astype(np.uint64)
    with np.errstate(over="ignore"):
        key = key + ~(key << np.uint64(32))
        key ^= key >> np.uint64(22)
        key = key + ~(key << np.uint64(13))
        key ^= key >> np.uint64(8)
        key = key + (key << np.uint64(3))
        key ^= key >> np.uint64(15)
        key = key + ~(key << np.uint64(27))
        key ^= key >> np.uint64(31)
    return key
