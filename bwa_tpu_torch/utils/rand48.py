"""Bit-exact reimplementation of the POSIX drand48 family.

The reference uses srand48/lrand48 to replace ambiguous (N) reference bases
with pseudo-random bases at pack time (bntseq.c:266,296, fixed seed 11) and
drand48 to sample among equal-best backtrack hits (bwase.c:36-40).  Index and
SAM byte-equality therefore require the exact 48-bit LCG sequence.

X_{n+1} = (a * X_n + c) mod 2^48,  a = 0x5DEECE66D, c = 0xB
srand48(seed):  X = (seed << 16) | 0x330E
lrand48():      advance, return top 31 bits of X
drand48():      advance, return X / 2^48 as a double
"""

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Rand48:
    __slots__ = ("x",)

    def __init__(self, seed: int = 0):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self.x = (((seed & 0xFFFFFFFF) << 16) | 0x330E) & _MASK

    def _step(self) -> int:
        self.x = (_A * self.x + _C) & _MASK
        return self.x

    def lrand48(self) -> int:
        return self._step() >> 17

    def mrand48(self) -> int:
        v = self._step() >> 16
        return v - (1 << 32) if v >= (1 << 31) else v

    def drand48(self) -> float:
        return self._step() / float(1 << 48)
