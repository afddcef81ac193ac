"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into its own shared library
with a plain C interface, at first use, into the repository's
build/kernels directory (git-ignored), keyed by a hash of the source and
the shared headers (csrc/*.cuh); all sources compile in parallel.  The
libraries are loaded with ctypes; pointers and the stream are passed as
Python ints.  Every entry point launches on the current stream of its
tensors' device, under that device (_call: the C side sets kernel
attributes and reads SM counts and occupancy on the thread's current
device), allocates nothing, and raises if the launch is refused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("seed_machine.cu", "ksw_band.cu", "ksw_full.cu", "gap_machine.cu",
           "smem_batch.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _so_path(src: str) -> Path:
    h = hashlib.sha256()
    for f in [_CSRC / src, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"{Path(src).stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing kernel library (one nvcc per source, all
    started together) and load them all."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in SOURCES:
            so = _so_path(src)
            if so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, so)
        for src, (p, tmp, so) in procs.items():
            out, _ = p.communicate()
            build_log[src] = out
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            os.replace(tmp, so)
        for src in SOURCES:
            _libs[src] = ctypes.CDLL(str(_so_path(src)))
        _bind(_libs)
        return _libs


def _bind(libs) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f = libs["seed_machine.cu"].bwa_seed_machine
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, i32,
                  vp, vp, vp, vp, vp, i32, i32, i64, i64, i32, i32, i32,
                  i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, vp]
    f = libs["seed_machine.cu"].bwa_seed_state
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, vp, vp, i32, i32,
                  i64, i64, i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp,
                  i64, vp]
    f = libs["smem_batch.cu"].bwa_sa_batch
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, vp, vp, vp, i64, i64, vp, vp, i32, vp, vp]
    f = libs["smem_batch.cu"].bwa_smem1a
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, vp, vp, vp, i64,
                  vp, i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i64, vp, i64,
                  vp, vp]
    f = libs["smem_batch.cu"].bwa_strategy1
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, vp, vp, i32, i64,
                  vp, vp, vp, vp, vp, vp, vp, vp]
    f = libs["smem_batch.cu"].bwa_collect_intv
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, vp, i32, i32, i64,
                  i64, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i32,
                  i64, vp, i64, vp, vp]
    f = libs["seed_machine.cu"].bwa_probe_breaks
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, vp, vp]
    f = libs["seed_machine.cu"].bwa_seed_kernel_attrs
    f.restype = ctypes.c_int
    f.argtypes = [i32, i32, i32, i32, i32, vp]
    f = libs["seed_machine.cu"].bwa_seed_noop
    f.restype = ctypes.c_int
    f.argtypes = [vp]
    f = libs["ksw_band.cu"].bwa_ksw_band
    f.restype = ctypes.c_int
    f.argtypes = [vp, i64, vp, i64, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                  i32, i32, i32, i32, i32, i32, i32, vp, i64, vp, vp]
    f = libs["ksw_band.cu"].bwa_ksw_band_arrays
    f.restype = ctypes.c_int
    f.argtypes = [vp, i64, vp, i64, vp, vp, vp, vp, vp,
                  i32, i32, i32, i32, i32, i32, i32, vp, i64, vp, vp]
    f = libs["ksw_full.cu"].bwa_ksw_full
    f.restype = ctypes.c_int
    f.argtypes = [vp, i32, vp, i64, vp, vp, vp, vp, vp,
                  i32, i32, i32, i32, i32, i32, vp, vp, vp, i32, vp, i64,
                  vp, vp]
    f = libs["gap_machine.cu"].bwa_cal_width
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, vp, vp]
    f = libs["gap_machine.cu"].bwa_gap_machine
    f.restype = ctypes.c_int
    f.argtypes = [i32, vp, i32, vp, i64, i64, vp, i32, i32, vp, vp, vp, vp,
                  vp, i32, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp, vp,
                  vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _call(fn, name: str, device, *args) -> None:
    """fn(*args) with `device` the thread's current device, so that the
    launch setup and the launch itself happen on the device whose stream
    the arguments name; raises if the launch was refused."""
    with torch.cuda.device(device):
        rc = fn(*args)
    _check(rc, name)


def seed_machine(occtab, L2, primary, seq_len, q, qlen, nv, job_lo, hi1,
                 hi3, min_seed_len, split_len, split_width, max_intv3, cap,
                 cap_s, use_p3, tagged, seeds, seed_n, ovf, done_step, steps,
                 qmask, lanes=None, cap_r=0, qctr=None, group=False) -> None:
    """Launch K1 (csrc/seed_machine.cu) on the current stream: one lane a
    row of q, or with qctr (an int32 [1] cursor) the refill mode, `lanes`
    lanes drawing q's rows, a warp a lane or with group its group form
    (2R threads a lane; nv may be None: it finds each read's next base in
    its codes)."""
    lib = build_all()["seed_machine.cu"]
    N, L = q.shape
    _call(
        lib.bwa_seed_machine, "seed_machine", q.device,
        int(seeds.dtype == torch.int64), _ptr(occtab), occtab.shape[1] - 4,
        _ptr(L2), int(primary), int(seq_len), _ptr(q),
        N if lanes is None else int(lanes), N, L, _ptr(qlen),
        None if nv is None else _ptr(nv), _ptr(job_lo), _ptr(hi1),
        _ptr(hi3), int(min_seed_len),
        int(split_len), int(split_width), int(max_intv3), int(cap),
        int(cap_s), int(use_p3), int(tagged), int(cap_r), _ptr(seeds),
        _ptr(seed_n), _ptr(ovf), _ptr(done_step), _ptr(steps), _ptr(qmask),
        None if qctr is None else _ptr(qctr), int(group), _stream(q))


def seed_state(occtab, L2, primary, seq_len, coord64, q, qlen, nv,
               min_seed_len, split_len, split_width, max_intv3, cap, cap_s,
               use_p3, last_stage, jobs, lanes, stk, seeds, qmask, steps_in,
               steps_out, max_steps) -> None:
    """Launch K1's state mode (csrc/seed_machine.cu, bwa_seed_state: K12,
    K13) on the current stream: the B lanes of q resumed from lanes
    [23, B], stk [B, 2, cap, 4], seeds [B, cap_s, 5] (int64) and qmask,
    updated in place, for at most max_steps steps past steps_in; each lane
    ends with last_stage, pass 2 reading jobs (or None: the seed store)."""
    lib = build_all()["seed_machine.cu"]
    B, L = q.shape
    _call(lib.bwa_seed_state, "seed_state", q.device, int(coord64),
          _ptr(occtab), occtab.shape[1] - 4, _ptr(L2), int(primary),
          int(seq_len), _ptr(q), B, L, _ptr(qlen), _ptr(nv),
          int(min_seed_len), int(split_len), int(split_width),
          int(max_intv3), int(cap), int(cap_s), int(use_p3),
          int(last_stage), None if jobs is None else _ptr(jobs),
          _ptr(lanes), _ptr(stk), _ptr(seeds), _ptr(qmask), _ptr(steps_in),
          _ptr(steps_out), int(max_steps), _stream(q))


def _opt(t):
    return None if t is None else _ptr(t)


def sa_batch(ckpt, words, ssa, L2, primary, seq_len, coord64, k, out,
             work=None) -> None:
    """Launch K9 (csrc/smem_batch.cu, bwa_sa_batch: bwt_sa a thread a row
    of k) on the current stream; work: an int64 [1] tensor that the walk
    steps are added to, or None."""
    lib = build_all()["smem_batch.cu"]
    _call(lib.bwa_sa_batch, "sa_batch", k.device, int(coord64), _ptr(ckpt),
          _ptr(words), _ptr(ssa), _ptr(L2), int(primary), int(seq_len),
          _ptr(k), _ptr(out), k.shape[0], _opt(work), _stream(k))


def smem1a(occtab, L2, primary, seq_len, coord64, q, qlen, x, min_intv,
           max_intv, active, cap, ret, m0, m1, m2, ms, me, mem_n, plan,
           work=None) -> None:
    """Launch K10a (bwa_smem1a: bwt_smem1a a warp a read) on the current
    stream; plan: (warps a block, blocks, shared bytes a block, scratch or
    None, bytes a warp's lists) from ops/fm.py::_lists_plan."""
    lib = build_all()["smem_batch.cu"]
    B, L = q.shape
    warps, blocks, smem, scratch, per_warp = plan
    _call(lib.bwa_smem1a, "smem1a", q.device, int(coord64), _ptr(occtab),
          occtab.shape[1] - 4, _ptr(L2), int(primary), int(seq_len), _ptr(q),
          B, L, _ptr(qlen), _ptr(x), _ptr(min_intv), int(max_intv),
          _ptr(active), int(cap), _ptr(ret), _ptr(m0), _ptr(m1), _ptr(m2),
          _ptr(ms), _ptr(me), _ptr(mem_n), int(warps), int(blocks),
          int(smem), _opt(scratch), int(per_warp), _opt(work), _stream(q))


def strategy1(occtab, L2, primary, seq_len, coord64, q, qlen, x, min_len,
              max_intv, active, ret, found, r0, r1, r2, work=None) -> None:
    """Launch K10b (bwa_strategy1: bwt_seed_strategy1 a warp a read) on the
    current stream."""
    lib = build_all()["smem_batch.cu"]
    B, L = q.shape
    _call(lib.bwa_strategy1, "strategy1", q.device, int(coord64),
          _ptr(occtab), occtab.shape[1] - 4, _ptr(L2), int(primary),
          int(seq_len), _ptr(q), B, L, _ptr(qlen), _ptr(x), int(min_len),
          int(max_intv), _ptr(active), _ptr(ret), _ptr(found), _ptr(r0),
          _ptr(r1), _ptr(r2), _opt(work), _stream(q))


def collect_intv(occtab, L2, primary, seq_len, coord64, q, qlen,
                 min_seed_len, split_len, split_width, max_mem_intv, cap,
                 cap_s, key64, raw, s0, s1, s2, ss, se, seed_n, plan,
                 work=None) -> None:
    """Launch K11 (bwa_collect_intv: mem_collect_intv's three passes a warp
    a read, then the sort) on the current stream; raw: the zeroed [B,
    cap_s, 5] seed store; plan as smem1a's."""
    lib = build_all()["smem_batch.cu"]
    B, L = q.shape
    warps, blocks, smem, scratch, per_warp = plan
    _call(lib.bwa_collect_intv, "collect_intv", q.device, int(coord64),
          _ptr(occtab), occtab.shape[1] - 4, _ptr(L2), int(primary),
          int(seq_len), _ptr(q), B, L, _ptr(qlen), int(min_seed_len),
          int(split_len), int(split_width), int(max_mem_intv), int(cap),
          int(cap_s), int(key64), _ptr(raw), _ptr(s0), _ptr(s1), _ptr(s2),
          _ptr(ss), _ptr(se), _ptr(seed_n), int(warps), int(blocks),
          int(smem), _opt(scratch), int(per_warp), _opt(work), _stream(q))


def probe_breaks(occtab, L2, primary, seq_len, coord64, q, out) -> None:
    """Launch K8 (csrc/seed_machine.cu, q [B, L] uint8 codes, out [B]
    int32) on the current stream."""
    lib = build_all()["seed_machine.cu"]
    B, L = q.shape
    _call(lib.bwa_probe_breaks, "probe_breaks", q.device,
          int(coord64), _ptr(occtab), occtab.shape[1] - 4, _ptr(L2),
          int(primary), int(seq_len), _ptr(q), B, L, _ptr(out), _stream(q))


SEED_KERNELS = ("K1", "K1 refill", "K8", "empty")


def seed_kernel_attrs(kernel: str, coord64: bool, nw: int, cap: int,
                      L: int, device=None) -> dict:
    """Registers a thread, static and local bytes, and occupancy (resident
    blocks and warps an SM at the launch's block and dynamic shared memory)
    of a kernel of csrc/seed_machine.cu (SEED_KERNELS) at nw text words a
    row, stack cap `cap` and reads of L codes, on `device` (the current
    one by default)."""
    lib = build_all()["seed_machine.cu"]
    out = (ctypes.c_int32 * 7)()
    _call(lib.bwa_seed_kernel_attrs, "seed_kernel_attrs", device,
          SEED_KERNELS.index(kernel), int(coord64), int(nw), int(cap),
          int(L), ctypes.cast(out, ctypes.c_void_p))
    return dict(zip(("registers", "static_shared_bytes", "local_bytes",
                     "block_threads", "dynamic_shared_bytes",
                     "blocks_per_sm", "warps_per_sm"), list(out)))


def seed_noop(device=None) -> None:
    """One launch of csrc/seed_machine.cu's empty kernel on the current
    stream of `device` (the current device by default)."""
    lib = build_all()["seed_machine.cu"]
    _call(lib.bwa_seed_noop, "seed_noop", device,
          torch.cuda.current_stream(device).cuda_stream)


def _mat(mat) -> ctypes.c_void_p:
    return ctypes.cast((ctypes.c_int32 * 25)(*mat), ctypes.c_void_p)


def _scratch(scratch) -> tuple[int | None, int]:
    """The wide path's global ring band: (pointer, bytes a problem), or
    (None, 0) for the ring in shared memory."""
    if scratch is None:
        return None, 0
    buf, stride = scratch
    return _ptr(buf), int(stride)


def ksw_band(pac, l_pac, qflat, qbase, qdir, qlen, tbase, tdir, tlen, w,
             h0, mat, o_del, e_del, o_ins, e_ins, zdrop, P, out,
             scratch=None) -> None:
    """Launch K2 (csrc/ksw_band.cu) on the current stream; scratch: the
    wide path's (buffer, bytes a problem), or None."""
    lib = build_all()["ksw_band.cu"]
    n = qbase.shape[0]
    _call(
        lib.bwa_ksw_band, "ksw_band", qbase.device,
        _ptr(pac), int(l_pac), _ptr(qflat), qflat.shape[0], _ptr(qbase),
        _ptr(qdir), _ptr(qlen), _ptr(tbase), _ptr(tdir), _ptr(tlen), _ptr(w),
        _ptr(h0), _mat(mat), int(o_del), int(e_del), int(o_ins), int(e_ins),
        int(zdrop), int(P), n, *_scratch(scratch), _ptr(out), _stream(qbase))


def ksw_band_arrays(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del, o_ins,
                    e_ins, zdrop, P, out, scratch=None) -> None:
    """Launch K2 in host-array mode (qs [n, Q], ts [n, T] code rows) on the
    current stream."""
    lib = build_all()["ksw_band.cu"]
    n, Q = qs.shape
    _call(
        lib.bwa_ksw_band_arrays, "ksw_band_arrays", qs.device,
        _ptr(qs), Q, _ptr(ts), ts.shape[1], _ptr(qlen), _ptr(tlen), _ptr(w),
        _ptr(h0), _mat(mat), int(o_del), int(e_del), int(o_ins), int(e_ins),
        int(zdrop), int(P), n, *_scratch(scratch), _ptr(out), _stream(qs))


def ksw_full(qs, ts, qlen, tlen, w, h0, mat, o_del, e_del, o_ins, e_ins,
             zdrop, perm, pw, counts, p_wide, out, scratch=None) -> None:
    """Launch K5 (csrc/ksw_full.cu, qs [n, QP], ts [n, T]) on the current
    stream: perm [n] the problems in window-class order, pw [n] their
    windows, counts the problems of each class (host ints)."""
    lib = build_all()["ksw_full.cu"]
    n, QP = qs.shape
    cnt = (ctypes.c_int * len(counts))(*counts)
    _call(
        lib.bwa_ksw_full, "ksw_full", qs.device,
        _ptr(qs), QP, _ptr(ts), ts.shape[1], _ptr(qlen), _ptr(tlen), _ptr(w),
        _ptr(h0), _mat(mat), int(o_del), int(e_del), int(o_ins), int(e_ins),
        int(zdrop), n, _ptr(perm), _ptr(pw), ctypes.cast(cnt, ctypes.c_void_p),
        int(p_wide), *_scratch(scratch), _ptr(out), _stream(qs))


def cal_width(occtab, L2, primary, seq_len, q, out) -> None:
    """Launch K7w (csrc/gap_machine.cu, q [B, L] uint8 codes, out [B, L, 2]
    coordinates) on the current stream."""
    lib = build_all()["gap_machine.cu"]
    B, L = q.shape
    _call(lib.bwa_cal_width, "cal_width", q.device,
          int(out.dtype == torch.int64), _ptr(occtab), occtab.shape[1] - 4,
          _ptr(L2), int(primary), int(seq_len), _ptr(q), B, L, _ptr(out),
          _stream(q))


def gap_machine(occtab, L2, primary, seq_len, q, qlen, md, mg, seed_en, sb,
                wb, active, scal, max_steps, cap, cap_a, use_seed, f_gape,
                f_nonstop, f_loggap, wide, n_lists, heads, bits, pool, aln_m,
                aln_kl, n_aln, n_stk, done_step, n_occ, n_walk, ovf,
                steps) -> None:
    """Launch K7 (csrc/gap_machine.cu) on the current stream; scal: the
    ten integer options (host ints); n_lists score lists; the stack
    scratch: pool [B, cap, 8] int32 (a 32-byte record a slot), or with
    wide the wide-record variant's pool [B, cap, 12 or 16] with heads
    [B, n_lists] and bits [B, ceil(n_lists / 32)] int32; steps [2] zeroed
    (the longest lane's steps and the persistent grid's lane counter)."""
    lib = build_all()["gap_machine.cu"]
    B, L = q.shape
    sc = (ctypes.c_int32 * 10)(*scal)
    flags = int(f_gape) | int(f_nonstop) << 1 | int(f_loggap) << 2 \
        | int(use_seed) << 3
    _call(
        lib.bwa_gap_machine, "gap_machine", q.device,
        int(wb.dtype == torch.int64), _ptr(occtab), occtab.shape[1] - 4,
        _ptr(L2), int(primary), int(seq_len), _ptr(q), B, L, _ptr(qlen),
        _ptr(md), _ptr(mg), _ptr(seed_en), _ptr(sb), sb.shape[1], _ptr(wb),
        _ptr(active), ctypes.cast(sc, ctypes.c_void_p), int(max_steps),
        int(cap), int(cap_a), int(n_lists), flags, int(wide), _ptr(heads),
        _ptr(bits), _ptr(pool), _ptr(aln_m), _ptr(aln_kl), _ptr(n_aln),
        _ptr(n_stk), _ptr(done_step), _ptr(n_occ), _ptr(n_walk), _ptr(ovf),
        _ptr(steps), _stream(q))
