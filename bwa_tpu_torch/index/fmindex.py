"""FM-index container: host (numpy) and device (torch) views.

Device layout follows the reference's single interleaved uint32 stream
(bwt.h:73-80) split into gather-friendly arrays

    ckpt   [n_ckpt, 4]     coord dtype (int32 when 2*l_pac+2 < 2^31 else int64)
    words  [n_blocks, 8]   uint32 bit patterns held as int32
    ssa    [n_sa]          coord dtype (sampled suffix array, interval 32)
    pac    [l_pac/4+1]     uint8 (packed forward reference)
    occtab [n_rows, 4+8R]  uint32 bit patterns held as int32: the occ
                           checkpoint of every R-th block followed by the
                           2-bit text words of R blocks

torch has no unsigned 32-bit shift, compare or popcount on the CPU, so
every uint32 array is stored as an int32 tensor with the same bits; the
FM primitives (ops/fm.py) widen to int64 and mask with 0xFFFFFFFF before
doing arithmetic on them, and the CUDA kernels read them as uint32.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from bwa_tpu_torch import tracing
from bwa_tpu_torch.index.build import read_bwt_file, read_sa_file, index_build
from bwa_tpu_torch.index.pack import Bnt, read_ann_amb, load_pac, unpack_pac


@dataclass
class FMIndex:
    primary: int
    L2: np.ndarray          # [5] int64 cumulative counts
    seq_len: int            # 2 * l_pac
    ckpt: np.ndarray        # [n_ckpt, 4] coord dtype
    words: np.ndarray       # [n_blocks, 8] uint32
    sa_intv: int
    ssa: np.ndarray         # [n_sa] coord dtype
    bnt: Bnt
    pac: np.ndarray         # packed forward ref, uint8
    prefix: str | None = None

    @property
    def l_pac(self) -> int:
        return self.bnt.l_pac

    @property
    def coord_dtype(self):
        return np.int32 if self.seq_len + 2 < 2**31 else np.int64

    @classmethod
    def load(cls, prefix) -> "FMIndex":
        """Attach from shared memory when staged (bwa shm analog,
        fastmap.c:362-366 probes shm first), else read the index files."""
        from bwa_tpu_torch import shm as shm_mod

        fm = shm_mod.shm_attach(str(prefix))
        if fm is not None:
            import sys

            print("[M::bwa_idx_load_from_shm] load the bwa index from "
                  "shared memory", file=sys.stderr)
            return fm
        return cls.load_from_disk(prefix)

    @classmethod
    def load_from_disk(cls, prefix) -> "FMIndex":
        import os

        prefix = str(prefix)
        # bwa_idx_infer_prefix (bwa.c:245-269): prefer the .64 variant
        if os.path.exists(prefix + ".64.bwt"):
            prefix = prefix + ".64"
        primary, L2, seq_len, ckpt, words = read_bwt_file(prefix + ".bwt")
        bnt = read_ann_amb(prefix)
        assert seq_len == 2 * bnt.l_pac
        cdt = np.int32 if seq_len + 2 < 2**31 else np.int64
        sa_intv, ssa = read_sa_file(prefix + ".sa", primary, seq_len, cdt)
        pac = load_pac(prefix, bnt.l_pac)
        return cls(primary=primary, L2=L2.astype(np.int64), seq_len=seq_len,
                   ckpt=ckpt.astype(cdt), words=words, sa_intv=sa_intv,
                   ssa=ssa, bnt=bnt, pac=pac, prefix=prefix)

    @classmethod
    def build(cls, fasta_path, prefix=None) -> "FMIndex":
        return cls.load(index_build(fasta_path, prefix))

    @classmethod
    def build_in_memory(cls, fwd_codes: np.ndarray,
                        name: str = "ref") -> "FMIndex":
        """A whole index of one contig from its forward 2-bit codes, with
        no file written (the dry run's and the tests' small genomes); the
        dense rank -> position SA rides along as `sad`."""
        from bwa_tpu_torch.index.build import (SA_INTV, bwt_from_sa,
                                               occ_checkpoints,
                                               pack_bwt_words)
        from bwa_tpu_torch.index.pack import Contig, pack_codes
        from bwa_tpu_torch.native.build import suffix_array

        fwd = np.ascontiguousarray(fwd_codes, dtype=np.uint8)
        code2 = np.concatenate([fwd, (3 - fwd)[::-1]])
        n = code2.shape[0]
        sa = suffix_array(code2)
        bwt_str, primary = bwt_from_sa(code2, sa)
        L2 = np.zeros(5, dtype=np.int64)
        np.cumsum(np.bincount(code2, minlength=4), out=L2[1:])
        words_flat = pack_bwt_words(bwt_str)
        words = np.zeros(((n + 127) // 128, 8), dtype=np.uint32)
        words.reshape(-1)[: words_flat.shape[0]] = words_flat
        rows_sa = np.empty(n + 1, dtype=np.int64)
        rows_sa[0] = n
        rows_sa[1:] = sa
        ssa = rows_sa[np.arange((n + SA_INTV) // SA_INTV,
                                dtype=np.int64) * SA_INTV].copy()
        ssa[0] = -1
        cdt = np.int32 if n + 2 < 2**31 else np.int64
        bnt = Bnt(l_pac=len(fwd), seed=11,
                  contigs=[Contig(name=name, anno="(null)", offset=0,
                                  length=len(fwd), n_ambs=0)],
                  holes=[])
        pac_full = pack_codes(fwd)
        pac = np.zeros(len(fwd) // 4 + 1, dtype=np.uint8)
        pac[: pac_full.shape[0]] = pac_full[: pac.shape[0]]
        fmi = cls(primary=primary, L2=L2, seq_len=n,
                  ckpt=occ_checkpoints(bwt_str).astype(cdt), words=words,
                  sa_intv=SA_INTV, ssa=ssa.astype(cdt), bnt=bnt, pac=pac)
        sad = rows_sa.astype(cdt, copy=True)
        sad[0] = -1
        fmi.__dict__["sad"] = sad
        return fmi

    @cached_property
    def sad(self):
        """Dense rank->position SA (the .sad.npy sidecar) or None."""
        if self.prefix:
            import os

            p = self.prefix + ".sad.npy"
            if os.path.exists(p):
                return np.load(p, mmap_mode="r")
        return None

    def sa_lookup(self, ranks: np.ndarray, card=None) -> np.ndarray:
        """Batched SA rank -> position (bwt_sa, bwt.c:86-96 semantics,
        incl. the rank-0 -1 poison) by one of three routes: the dense
        sidecar when present; else `card`, a walker on a device (ops/fm.py
        DeviceSA: K9 on a CUDA engine's index), when given; else the
        native inverse-Psi walker (bsw2.cpp fm_sa_batch).  Traced as the
        span sa_lookup, counting the ranks, the walk's steps (none on the
        sidecar) and the ranks walked on the device (device_ranks)."""
        with tracing.span("sa_lookup") as sp:
            ranks = np.ascontiguousarray(ranks, dtype=np.int64)
            n = ranks.shape[0]
            sp.count("ranks", n)
            sad = self.sad
            if sad is not None:
                sp.count("walk_steps", 0)
                sp.count("device_ranks", 0)
                return np.asarray(sad[ranks], dtype=np.int64)
            if card is not None:
                out, steps = card(ranks) if n else (
                    np.zeros(0, dtype=np.int64), 0)
                sp.count("walk_steps", steps)
                sp.count("device_ranks", n)
                return out
            import ctypes

            from bwa_tpu_torch.native.build import get_lib

            lib = get_lib()
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.fm_sa_batch.restype = ctypes.c_int64
            lib.fm_sa_batch.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                        i64p, i64p, ctypes.c_int32, i64p,
                                        ctypes.c_int64, i64p]
            if not hasattr(self, "_sa_args"):
                self._sa_args = (self.occ_inter,
                                 np.ascontiguousarray(self.L2, np.int64),
                                 np.ascontiguousarray(self.ssa, np.int64))
            inter, L2, ssa = self._sa_args
            out = np.empty(n, dtype=np.int64)
            steps = 0
            if n:
                steps = lib.fm_sa_batch(
                    inter.ctypes.data_as(u8p), self.seq_len, self.primary,
                    L2.ctypes.data_as(i64p), ssa.ctypes.data_as(i64p),
                    self.sa_intv, ranks.ctypes.data_as(i64p),
                    n, out.ctypes.data_as(i64p))
            sp.count("walk_steps", steps)
            sp.count("device_ranks", 0)
            return out

    @cached_property
    def occ_inter(self) -> np.ndarray:
        """64-byte-aligned interleaved occ blocks for the native search
        engines: per 128 bases, 4 int64 counts + 8 uint32 text words."""
        n_blocks = self.words.shape[0]
        raw = np.zeros(n_blocks * 64 + 64, np.uint8)
        off = (-raw.ctypes.data) % 64
        buf = raw[off:off + n_blocks * 64].reshape(n_blocks, 64)
        buf[:, :32] = np.ascontiguousarray(
            self.ckpt[:n_blocks].astype(np.int64)).view(np.uint8).reshape(
                n_blocks, 32)
        buf[:, 32:] = np.ascontiguousarray(self.words).view(
            np.uint8).reshape(n_blocks, 32)
        return buf

    @cached_property
    def pac_codes(self) -> np.ndarray:
        """Unpacked forward reference codes (uint8, 0..3)."""
        return unpack_pac(self.pac, self.l_pac)

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Reference subsequence on the doubled coordinate system, with
        on-the-fly reverse complement (bns_get_seq, bntseq.c:403-424)."""
        if end < beg:
            beg, end = end, beg
        end = min(end, self.seq_len)
        beg = max(beg, 0)
        if beg >= self.l_pac:  # reverse strand
            beg_f = self.seq_len - end
            end_f = self.seq_len - beg
            return (3 - self.pac_codes[beg_f:end_f])[::-1]
        if end <= self.l_pac:
            return self.pac_codes[beg:end]
        return np.zeros(0, dtype=np.uint8)  # bridges the fwd/rev boundary

    def fetch_seq(self, beg: int, mid: int, end: int):
        """bns_fetch_seq (bntseq.c:426-451): clamp [beg,end) to the contig
        containing mid; returns (seq, rb, re, rid)."""
        if end < beg:
            beg, end = end, beg
        pos_f, is_rev = self.bnt.depos(mid)
        rid = self.bnt.pos2rid(pos_f)
        c = self.bnt.contigs[rid]
        far_beg, far_end = c.offset, c.offset + c.length
        if is_rev:
            far_beg, far_end = (self.seq_len - (c.offset + c.length),
                                self.seq_len - c.offset)
        beg = max(beg, far_beg)
        end = min(end, far_end)
        seq = self.get_seq(beg, end)
        assert seq.shape[0] == end - beg
        return seq, beg, end, rid


def writable(a: np.ndarray, dtype) -> np.ndarray:
    """a as a contiguous array of dtype that torch.from_numpy may wrap: an
    index attached from shm (shm.py) holds read-only memmaps, which are
    copied, never wrapped."""
    a = np.ascontiguousarray(a, dtype)
    return a if a.flags.writeable else a.copy()


def _i32_bits(a: np.ndarray) -> np.ndarray:
    """uint32 array -> writable int32 array with the same bits."""
    return writable(a, np.uint32).view(np.int32)


def occ_retile(n_blocks: int) -> int:
    """Occ re-tile factor R (each occtab row covers R text blocks): 1 up
    to 2^16 blocks (~8 Mbp doubled text), 4 above."""
    return 1 if n_blocks <= (1 << 16) else 4


def build_occtab(fm: FMIndex, R: int) -> np.ndarray | None:
    """Fused [n_rows, 4 + 8R] uint32 table (counts || 2-bit text words),
    or None when a count does not fit 32 bits."""
    if int(fm.ckpt.max(initial=0)) >= 2**32:
        return None
    n_blocks = fm.words.shape[0]
    n_rows = (n_blocks + R - 1) // R
    words = np.zeros((n_rows * R, 8), np.uint32)
    words[:n_blocks] = fm.words
    words = words.reshape(n_rows, 8 * R)
    counts = fm.ckpt[: n_rows * R: R].astype(np.uint32)
    if counts.shape[0] < n_rows:  # ckpt has n_blocks+1 rows; pad safe
        counts = np.concatenate([counts, fm.ckpt[-1:].astype(np.uint32)])
    return np.concatenate([counts, words], axis=1)


class DeviceFMIndex:
    """torch view of an FMIndex on one device.

    light=True uploads what the seeding machine and K9's occtab form read
    (the fused occtab, the sampled SA, the scalars and a 1-row ckpt/words
    stub) and no packed reference: the SA walk runs on the card there
    (ops/fm.py::DeviceSA), the extension on the host."""

    def __init__(self, fm: FMIndex | None, light: bool = False,
                 device: str | torch.device = "cuda",
                 occ_r: int | None = None):
        self.fm = fm
        self.device = torch.device(device)
        if fm is None:  # filled by from_arrays
            return
        cdt = fm.coord_dtype
        n_ck = 1 if light else fm.ckpt.shape[0]
        n_w = 1 if light else fm.words.shape[0]
        R = occ_r if occ_r is not None else occ_retile(fm.words.shape[0])
        occ = build_occtab(fm, R)
        if occ is None and light:
            raise RuntimeError("light DeviceFMIndex requires the fused "
                               "occtab (counts exceed uint32)")
        self._set(int(fm.primary), int(fm.seq_len), int(fm.l_pac),
                  int(fm.sa_intv), fm.L2.astype(cdt), fm.ckpt[:n_ck],
                  fm.words[:n_w], fm.ssa, None if light else fm.pac, occ)

    def _set(self, primary, seq_len, l_pac, sa_intv, L2, ckpt, words, ssa,
             pac, occtab):
        dev = self.device
        self.primary = int(primary)
        self.seq_len = int(seq_len)
        self.l_pac = int(l_pac)
        self.sa_intv = int(sa_intv)
        self.coord_dtype = np.int32 if self.seq_len + 2 < 2**31 else np.int64
        cdt = self.coord_dtype
        self.L2 = torch.from_numpy(np.asarray(L2).astype(cdt)).to(dev)
        self.ckpt = torch.from_numpy(np.asarray(ckpt).astype(cdt)).to(dev)
        self.words = torch.from_numpy(_i32_bits(words)).to(dev)
        self.ssa = (None if ssa is None else
                    torch.from_numpy(np.asarray(ssa).astype(cdt)).to(dev))
        self.pac = (None if pac is None
                    else torch.from_numpy(writable(pac, np.uint8)).to(dev))
        self.occtab = (None if occtab is None
                       else torch.from_numpy(_i32_bits(occtab)).to(dev))

    @classmethod
    def from_arrays(cls, arrays: dict, device: str | torch.device = "cuda",
                    fm: FMIndex | None = None) -> "DeviceFMIndex":
        """Carry a device index across from numpy copies of another
        implementation's device arrays (keys: primary, seq_len, l_pac,
        sa_intv, L2, ckpt, words, and optionally ssa, pac, occtab; words
        and occtab as uint32).  Bit patterns are kept exactly."""
        self = cls(None, device=device)
        self.fm = fm
        self._set(arrays["primary"], arrays["seq_len"], arrays["l_pac"],
                  arrays["sa_intv"], arrays["L2"], arrays["ckpt"],
                  arrays["words"], arrays.get("ssa"), arrays.get("pac"),
                  arrays.get("occtab"))
        return self

    @property
    def cdt(self) -> torch.dtype:
        return torch.int32 if self.coord_dtype == np.int32 else torch.int64

    def tree(self) -> dict:
        """The arrays and scalars the FM primitives and kernels read."""
        t = dict(primary=self.primary, seq_len=self.seq_len,
                 l_pac=self.l_pac, sa_intv=self.sa_intv, cdt=self.cdt,
                 L2=self.L2, ckpt=self.ckpt, words=self.words)
        if self.ssa is not None:
            t["ssa"] = self.ssa
        if self.pac is not None:
            t["pac"] = self.pac
        if self.occtab is not None:
            t["occtab"] = self.occtab
        return t
