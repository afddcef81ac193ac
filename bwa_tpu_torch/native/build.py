"""Compile-on-demand loader for the C++ native extension.

The native library provides the host-side hot paths that the reference
implements in C (kthread-free: the TPU framework's host side is
single-process): SA-IS suffix-array construction for index building and
scalar DP kernels for the low-volume host bookkeeping calls.

We build one shared library from all .cpp files in this directory with g++
-O3 and cache it keyed by a hash of the sources, loading through ctypes
(no pybind11 in this environment).  The library lands in the repository's
build/native directory (git-ignored), never in a per-user cache, so it
cannot collide with another package's build of the same sources.  The
native CLI front end (client.c, client_exe) is built beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent
_CACHE_DIR = _SRC_DIR.parents[1] / "build" / "native"

_lock = threading.Lock()
_lib = None


def _source_files():
    return sorted(_SRC_DIR.glob("*.cpp"))


def _hash_files():
    # headers participate in the content hash but are not compiled units
    return sorted(_SRC_DIR.glob("*.cpp")) + sorted(_SRC_DIR.glob("*.h"))


def _build_hash(files) -> str:
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(files, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-o", str(tmp),
    ] + [str(f) for f in files]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)


def _link(link: Path, target: Path) -> None:
    """Point link at target (a relative symlink in the same directory),
    replaced atomically so that a concurrent reader never misses it."""
    if link.is_symlink() and os.readlink(link) == target.name:
        return
    tmp = link.with_name(f"{link.name}.{os.getpid()}.tmp")
    tmp.unlink(missing_ok=True)
    tmp.symlink_to(target.name)
    os.replace(tmp, link)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        files = _source_files()
        so = _CACHE_DIR / f"bwa_tpu_torch_native_{_build_hash(_hash_files())}.so"
        if not so.exists():
            _compile(files, so)
        # stable name for the native CLI client's dlopen (client.c)
        _link(_CACHE_DIR / "bwa_tpu_torch_native.so", so)
        lib = ctypes.CDLL(str(so))

        lib.sais_u8_i32.restype = ctypes.c_int
        lib.sais_u8_i32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sais_u8_i64.restype = ctypes.c_int
        lib.sais_u8_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sais_u8_full_i32.restype = ctypes.c_int
        lib.sais_u8_full_i32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sais_u8_full_i64.restype = ctypes.c_int
        lib.sais_u8_full_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.revcomp_concat.restype = None
        lib.revcomp_concat.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.bwt_chars_i32.restype = ctypes.c_int64
        lib.bwt_chars_i32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.bwt_chars_i64.restype = ctypes.c_int64
        lib.bwt_chars_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        c_i = ctypes.c_int
        c_i64 = ctypes.c_int64
        cp = ctypes.c_char_p
        lib.bt_samse_batch.restype = c_i64
        lib.bt_samse_batch.argtypes = [
            u8p, c_i64, c_i64, i64p, i64p, ctypes.c_int32,          # FM
            u8p, c_i64, i64p, i32p, i32p, cp, ctypes.c_int32,       # ref
            i64p, i32p, ctypes.c_int32,                             # ambs
            ctypes.c_int32, u8p, i64p, i32p, i32p, i32p,            # reads
            u8p, i64p, cp, i64p, cp, i32p,                          # qual/names/bc
            u8p, c_i64,                                             # sai
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, cp, u64p,
            u8p, c_i64, i64p,
            ctypes.c_void_p, ctypes.c_int32]                        # dense SA
        lib.bt_ksw_extend2.restype = c_i
        lib.bt_ksw_extend2.argtypes = [c_i, u8p, c_i, u8p, c_i, i8p,
                                       c_i, c_i, c_i, c_i, c_i, c_i, c_i, c_i,
                                       i32p, i32p, i32p, i32p, i32p]
        lib.bt_ksw_global2.restype = c_i
        lib.bt_ksw_global2.argtypes = [c_i, u8p, c_i, u8p, c_i, i8p,
                                       c_i, c_i, c_i, c_i, c_i,
                                       i32p, u32p, c_i]
        lib.bwt_inc_build.restype = c_i64
        lib.bwt_inc_build.argtypes = [u8p, c_i64, c_i64, u8p, i64p]
        lib.bwt_sa_walk.restype = None
        lib.bwt_sa_walk.argtypes = [u8p, c_i64, c_i64, i64p,
                                    ctypes.c_int32, i64p, i64p]
        lib.bt_ksw_align2.restype = None
        lib.bt_ksw_align2.argtypes = [c_i, u8p, c_i, u8p, c_i, i8p,
                                      c_i, c_i, c_i, c_i,
                                      c_i, c_i, c_i, c_i, c_i, i32p]
        lib.bt_trace_begin.restype = None
        lib.bt_trace_begin.argtypes = []
        lib.bt_trace_take.restype = None
        lib.bt_trace_take.argtypes = [i64p]
        _lib = lib
        return lib


def client_exe() -> Path:
    """The native CLI front end (client.c), compiled on demand beside the
    library (content-hash named like it): it forwards one-shots to the
    resident daemon without starting Python, runs the host backtrack
    one-shots in the library, and execs the Python CLI otherwise.
    Returns the executable's path."""
    get_lib()  # the client dlopens the lib's stable name
    src = _SRC_DIR / "client.c"
    exe = _CACHE_DIR / f"bwa-tpu-torch-{_build_hash([src])}"
    with _lock:
        if not exe.exists():
            tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
            subprocess.run(["gcc", "-O2", "-o", str(tmp), str(src), "-ldl"],
                           check=True, capture_output=True)
            os.replace(tmp, exe)
        _link(_CACHE_DIR / "bwa-tpu-torch", exe)
    return exe


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a uint8 text (values < 255), implicit sentinel at end.

    Returns int32 when n < 2^31 else int64.
    """
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = text.shape[0]
    lib = get_lib()
    if n < 2**31:
        sa = np.empty(n, dtype=np.int32)
        rc = lib.sais_u8_i32(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int32(n),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    else:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.sais_u8_i64(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int64(n),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    if rc != 0:
        raise RuntimeError(f"sais failed with rc={rc}")
    return sa


def revcomp_concat(fwd: np.ndarray) -> np.ndarray:
    """Doubled text fwd + revcomp(fwd) (bntseq.c:306-312) at memory speed
    (numpy's negative-stride byte copy runs at a few MB/s)."""
    fwd = np.ascontiguousarray(fwd, dtype=np.uint8)
    n = fwd.shape[0]
    out = np.empty(2 * n, dtype=np.uint8)
    get_lib().revcomp_concat(
        fwd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), np.int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def bwt_chars(code2: np.ndarray, rows: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT string + primary from the (n+1)-row model (native gather; the
    numpy fancy-index runs ~4M random gathers/s, ~30 min at GRCh38)."""
    n = code2.shape[0]
    assert rows.shape[0] == n + 1
    out = np.empty(n, dtype=np.uint8)
    lib = get_lib()
    c2 = code2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    ob = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if rows.dtype == np.int32:
        primary = lib.bwt_chars_i32(
            c2, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int32(n), ob)
    else:
        primary = lib.bwt_chars_i64(
            c2, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            np.int64(n), ob)
    if primary < 0:
        raise RuntimeError("bwt_chars: inconsistent row model")
    return out, int(primary)


def suffix_array_rows(text: np.ndarray) -> np.ndarray:
    """Suffix array INCLUDING the sentinel row: returns sa_full of n+1
    entries with sa_full[0] == n (the empty suffix) and sa_full[1:] the
    plain suffix order.  This is exactly the (n+1)-row model the BWT
    derivation wants (index/build.py bwt_from_sa), constructed in place —
    no second 8n-byte buffer, which matters at GRCh38 scale (50 GB)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = text.shape[0]
    lib = get_lib()
    if n < 2**31:
        sa = np.empty(n + 1, dtype=np.int32)
        rc = lib.sais_u8_full_i32(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int32(n),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    else:
        sa = np.empty(n + 1, dtype=np.int64)
        rc = lib.sais_u8_full_i64(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int64(n),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    if rc != 0:
        raise RuntimeError(f"sais failed with rc={rc}")
    return sa


def bwt_incremental(pac2: np.ndarray, n: int, block: int = 1 << 22):
    """Bounded-memory BWT of the 2-bit packed doubled text (native
    bwtinc.cpp): returns (interleaved occ blocks uint8, primary, counts[4]).
    Peak memory ~= 2 * n/2 bytes of interleaved buffers + the packed
    input — the bwt_gen.c:1431 property without a suffix array."""
    pac2 = np.ascontiguousarray(pac2, np.uint8)
    lib = get_lib()
    inter = np.zeros(((n + 127) // 128) * 64, np.uint8)
    cnt = np.zeros(4, np.int64)
    primary = lib.bwt_inc_build(
        pac2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int64(n), np.int64(block),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return inter, int(primary), cnt


def bwt_sa_walk(inter: np.ndarray, n: int, primary: int, L2: np.ndarray,
                intv: int, want_sad: bool):
    """Sampled .sa values (and the dense sidecar when want_sad) from the
    finished BWT via the inverse-Psi chain (bwt_cal_sa, bwt.c:70-84)."""
    lib = get_lib()
    i64p = ctypes.POINTER(ctypes.c_int64)
    samples = np.zeros((n + intv) // intv + 1, np.int64)
    sad = np.zeros(n + 1, np.int64) if want_sad else None
    L2c = np.ascontiguousarray(L2.astype(np.int64))
    lib.bwt_sa_walk(
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int64(n), np.int64(primary), L2c.ctypes.data_as(i64p),
        np.int32(intv), samples.ctypes.data_as(i64p),
        sad.ctypes.data_as(i64p) if sad is not None else None)
    return samples, sad
