"""Python wrappers over the native scalar DP kernels (native/ksw.cpp)."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from bwa_tpu_torch.native.build import get_lib

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


# per-call scratch for the extend outputs (single-threaded pipeline);
# the five pointers are prebuilt once instead of five casts per call
_EXT_OUTS = np.zeros(5, dtype=np.int32)
_EXT_PTRS = [_EXT_OUTS[i:].ctypes.data_as(_i32p) for i in range(5)]
_MAT_CACHE: dict[bytes, np.ndarray] = {}


def _mat_i8(mat) -> np.ndarray:
    """Contiguous int8 copy of a score matrix, cached by content (the
    matrices are 25 bytes; hashing is cheaper than the per-call
    ascontiguousarray + reshape churn)."""
    key = np.asarray(mat, dtype=np.int8).tobytes()
    m = _MAT_CACHE.get(key)
    if m is None:
        m = np.frombuffer(key, dtype=np.int8)
        _MAT_CACHE[key] = m
    return m


def ksw_extend2(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                end_bonus, zdrop, h0):
    """Banded extension (ksw.c:416-515).
    Returns (score, qle, tle, gtle, gscore, max_off)."""
    q = _u8(query)
    t = _u8(target)
    m = _mat_i8(mat)
    lib = get_lib()
    score = lib.bt_ksw_extend2(
        len(q), q.ctypes.data_as(_u8p), len(t), t.ctypes.data_as(_u8p),
        5, m.ctypes.data_as(_i8p), o_del, e_del, o_ins, e_ins,
        w, end_bonus, zdrop, h0,
        _EXT_PTRS[0], _EXT_PTRS[1], _EXT_PTRS[2], _EXT_PTRS[3],
        _EXT_PTRS[4])
    o = _EXT_OUTS.tolist()
    return int(score), o[0], o[1], o[2], o[3], o[4]


def ksw_global2(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                want_cigar=True):
    """Banded global alignment (ksw.c:540-642).
    Returns (score, cigar list of (op,len)) — ops MIDSH=0..4."""
    q = _u8(query)
    t = _u8(target)
    m = np.ascontiguousarray(mat, dtype=np.int8).reshape(-1)
    lib = get_lib()
    if not want_cigar:
        score = lib.bt_ksw_global2(
            len(q), q.ctypes.data_as(_u8p), len(t), t.ctypes.data_as(_u8p),
            5, m.ctypes.data_as(_i8p), o_del, e_del, o_ins, e_ins, w,
            None, None, 0)
        return int(score), None
    cap = len(q) + len(t) + 4
    cig = np.zeros(cap, dtype=np.uint32)
    n = np.zeros(1, dtype=np.int32)
    score = lib.bt_ksw_global2(
        len(q), q.ctypes.data_as(_u8p), len(t), t.ctypes.data_as(_u8p),
        5, m.ctypes.data_as(_i8p), o_del, e_del, o_ins, e_ins, w,
        n.ctypes.data_as(_i32p), cig.ctypes.data_as(_u32p), cap)
    nc = int(n[0])
    assert nc <= cap
    cigar = [(int(c) & 0xF, int(c) >> 4) for c in cig[:nc]]
    return int(score), cigar


@dataclass
class KswR:
    score: int
    te: int
    qe: int
    score2: int
    te2: int
    tb: int
    qb: int


def ksw_align2(query, target, mat, o_del, e_del, o_ins, e_ins,
               use_byte=False, use_start=False, use_subo=False,
               use_stop=False, thres=0) -> KswR:
    """Striped local SW + optional start recovery (ksw_align2, ksw.c:379-401)."""
    q = _u8(query)
    t = _u8(target)
    m = np.ascontiguousarray(mat, dtype=np.int8).reshape(-1)
    out = np.zeros(7, dtype=np.int32)
    get_lib().bt_ksw_align2(
        len(q), q.ctypes.data_as(_u8p), len(t), t.ctypes.data_as(_u8p),
        5, m.ctypes.data_as(_i8p), o_del, e_del, o_ins, e_ins,
        int(use_byte), int(use_start), int(use_subo), int(use_stop), thres,
        out.ctypes.data_as(_i32p))
    return KswR(*[int(x) for x in out])
