"""Scalar host implementations of the FM-index primitives.

This is the executable specification for the batched device kernels in
ops/fm.py: occ/rank (bwt.c:107-220), bidirectional extension (bwt.c:262-275),
SMEM generation (bwt_smem1a, bwt.c:289-351), third-round seeding
(bwt_seed_strategy1, bwt.c:358-379) and SA lookup (bwt.c:86-96).
Used directly only in tests and for rare host-side fallbacks.
"""

from __future__ import annotations

import numpy as np

from bwa_tpu_torch.index.fmindex import FMIndex

_M32 = 0xFFFFFFFF


def _popcount32(x: int) -> int:
    return bin(x & _M32).count("1")


class HostFM:
    def __init__(self, fm: FMIndex):
        self.fm = fm
        self.primary = fm.primary
        self.seq_len = fm.seq_len
        self.L2 = fm.L2.astype(np.int64)
        self.ckpt = fm.ckpt.astype(np.int64)
        self.words = fm.words

    # ---- occ ----

    def occ4(self, k: int) -> np.ndarray:
        """Counts of each base in B[0..k] inclusive (bwt_occ4)."""
        if k == -1:
            return np.zeros(4, dtype=np.int64)
        if k == self.seq_len:
            return (self.L2[1:5] - self.L2[0:4]).copy()
        k -= k >= self.primary
        j = k >> 7
        cnt = self.ckpt[j].copy()
        kw = (k >> 4) & 7
        kb = k & 15
        block = self.words[j]
        add = np.zeros(4, dtype=np.int64)
        for w in range(kw + 1):
            word = int(block[w])
            nkeep = 16 if w < kw else kb + 1
            mask2 = (~((1 << ((16 - nkeep) << 1)) - 1)) & _M32
            word &= mask2
            vm = mask2 & 0x55555555
            hi = (word >> 1) & 0x55555555
            lo = word & 0x55555555
            c3 = _popcount32(hi & lo)
            c2 = _popcount32(hi & ~lo)
            c1 = _popcount32(lo & ~hi)
            c0 = _popcount32(vm & ~hi & ~lo)
            add += (c0, c1, c2, c3)
        return cnt + add

    def occ(self, k: int, c: int) -> int:
        if k == self.seq_len:
            return int(self.L2[c + 1] - self.L2[c])
        if k == -1:
            return 0
        return int(self.occ4(k)[c])

    def B0(self, x: int) -> int:
        """BWT char at $-removed position x (bwt_B0)."""
        word = int(self.words[x >> 7][(x >> 4) & 7])
        return (word >> ((15 - (x & 15)) << 1)) & 3

    # ---- SA ----

    def inv_psi(self, k: int) -> int:
        x = k - (k > self.primary)
        c = self.B0(x)
        r = int(self.L2[c]) + self.occ(k, c)
        return 0 if k == self.primary else r

    def sa(self, k: int) -> int:
        sad = self.fm.sad
        if sad is not None:  # dense sidecar: sad[k] == the walk result
            return int(sad[k])
        return int(self.sa_many([k])[0])

    def sa_walk(self, k: int) -> int:
        """The pure-Python inverse-Psi walk (the executable spec; sa()
        routes through the native batch walker for speed)."""
        s, mask = 0, self.fm.sa_intv - 1
        while k & mask:
            s += 1
            k = self.inv_psi(k)
        return s + int(self.fm.ssa[k // self.fm.sa_intv])

    def sa_many(self, ks) -> "np.ndarray":
        sad = self.fm.sad
        if sad is not None:
            return np.asarray(sad[np.asarray(ks, dtype=np.int64)],
                              dtype=np.int64)
        from bwa_tpu_torch.sw2.core import Sw2Index

        if not hasattr(self, "_sw2idx"):
            self._sw2idx = Sw2Index(self.fm)
        return self._sw2idx.sa_batch(np.asarray(ks, dtype=np.int64))

    # ---- bidirectional extension ----

    def set_intv(self, c: int):
        """bwt_set_intv (bwt.h:82): initial interval of one base."""
        return (int(self.L2[c]) + 1,
                int(self.L2[3 - c]) + 1,
                int(self.L2[c + 1] - self.L2[c]))

    def extend(self, ik, is_back: int):
        """ik = (x0, x1, x2); returns list of 4 intervals ok[c]
        (bwt_extend, bwt.c:262-275)."""
        x0, x1, x2 = ik
        fwd = x0 if is_back else x1  # x[!is_back]
        tk = self.occ4(fwd - 1)
        tl = self.occ4(fwd - 1 + x2)
        ok_nb = [int(self.L2[i]) + 1 + int(tk[i]) for i in range(4)]
        ok_sz = [int(tl[i] - tk[i]) for i in range(4)]
        bk = x1 if is_back else x0  # x[is_back]
        span = int(fwd <= self.primary <= fwd + x2 - 1)
        b3 = bk + span
        b2 = b3 + ok_sz[3]
        b1 = b2 + ok_sz[2]
        b0 = b1 + ok_sz[1]
        bks = [b0, b1, b2, b3]
        out = []
        for c in range(4):
            if is_back:
                out.append((ok_nb[c], bks[c], ok_sz[c]))
            else:
                out.append((bks[c], ok_nb[c], ok_sz[c]))
        return out

    # ---- SMEM (bwt_smem1a) ----

    def smem1a(self, q: np.ndarray, x: int, min_intv: int, max_intv: int):
        """Returns (ret_x, mems) where mems = [(x0,x1,x2,info)], info =
        start<<32|end."""
        length = len(q)
        mems: list[tuple] = []
        if q[x] > 3:
            return x + 1, mems
        min_intv = max(min_intv, 1)
        ik = self.set_intv(int(q[x]))
        ik_info = x + 1
        curr: list[tuple] = []
        i = x + 1
        while i < length:
            if ik[2] < max_intv:  # small enough interval
                curr.append((ik, ik_info))
                break
            if q[i] < 4:
                c = 3 - int(q[i])
                ok = self.extend(ik, 0)
                if ok[c][2] != ik[2]:
                    curr.append((ik, ik_info))
                    if ok[c][2] < min_intv:
                        break
                ik = ok[c]
                ik_info = i + 1
            else:
                curr.append((ik, ik_info))
                break
            i += 1
        if i == length:
            curr.append((ik, ik_info))
        curr.reverse()
        ret = curr[0][1]
        prev = curr
        curr = []
        # ik carries across into the backward loop (reference reuses the var)
        ik_x2 = ik[2]

        i = x - 1
        while i >= -1:
            c = -1 if i < 0 or q[i] >= 4 else int(q[i])
            curr = []
            for (p, p_info) in prev:
                ok = None
                if c >= 0 and ik_x2 >= max_intv:
                    ok = self.extend(p, 1)
                if c < 0 or ik_x2 < max_intv or ok[c][2] < min_intv:
                    if len(curr) == 0:
                        if len(mems) == 0 or i + 1 < (mems[-1][3] >> 32):
                            ik = p
                            ik_x2 = p[2]
                            info = (p_info & 0xFFFFFFFF) | ((i + 1) << 32)
                            mems.append((p[0], p[1], p[2], info))
                elif len(curr) == 0 or ok[c][2] != curr[-1][0][2]:
                    curr.append((ok[c], p_info))
            if len(curr) == 0:
                break
            prev, curr = curr, prev
            i -= 1
        mems.reverse()
        return ret, mems

    def smem1(self, q, x, min_intv):
        return self.smem1a(q, x, min_intv, 0)

    def seed_strategy1(self, q: np.ndarray, x: int, min_len: int, max_intv: int):
        """LAST-like 3rd-round seeding (bwt.c:358-379).
        Returns (ret_x, mem or None)."""
        length = len(q)
        if q[x] > 3:
            return x + 1, None
        ik = self.set_intv(int(q[x]))
        for i in range(x + 1, length):
            if q[i] < 4:
                c = 3 - int(q[i])
                ok = self.extend(ik, 0)
                if ok[c][2] < max_intv and i - x >= min_len:
                    info = (x << 32) | (i + 1)
                    return i + 1, (ok[c][0], ok[c][1], ok[c][2], info)
                ik = ok[c]
            else:
                return i + 1, None
        return length, None
