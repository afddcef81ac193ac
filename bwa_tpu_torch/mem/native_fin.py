"""Glue for the C++ SE and PE finalize (native/memfin.cpp).

Packs the per-batch inputs (read codes, device-produced seeds + occurrence
positions, reference view) into flat arrays and gets back the SAM text for
the whole batch in one native call.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from bwa_tpu_torch import tracing
from bwa_tpu_torch.native.build import get_lib

_configured = False


def _lib():
    global _configured
    lib = get_lib()
    if not _configured:
        c = ctypes.c_int32
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.memfin_opt_size.restype = ctypes.c_int
        lib.mem_finalize_se_batch.restype = ctypes.c_int64
        lib.mem_finalize_se_batch.argtypes = [
            ctypes.c_void_p,
            u8p, ctypes.c_int64, i64p, i32p, u8p, ctypes.c_char_p, i32p, c,
            c, u8p, i64p, ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p, ctypes.c_int64, i64p, ctypes.c_char_p,
            i32p, i64p, i32p, i32p, i64p, i32p,
            ctypes.c_char_p, ctypes.c_int64, i64p,
        ]
        lib.mem_finalize_pe_batch.restype = ctypes.c_int64
        lib.mem_finalize_pe_batch.argtypes = [
            ctypes.c_void_p,
            u8p, ctypes.c_int64, i64p, i32p, u8p, ctypes.c_char_p, i32p, c,
            c, u8p, i64p, ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_char_p,
            i32p, i64p, i32p, i32p, i64p, i32p,
            ctypes.POINTER(ctypes.c_double), c,
            ctypes.c_char_p, ctypes.c_int64, i64p,
        ]
        _configured = True
    return lib


def pack_opt(opt) -> bytes:
    """Must match struct MemOpt in memfin.cpp (17 ints, pad, 6 doubles,
    5 ints, 25 int8, tail padding)."""
    blob = struct.pack(
        "<17i4x6d5i25b",
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.pen_clip5, opt.pen_clip3, opt.w, opt.zdrop,
        opt.T, opt.flag, opt.min_seed_len, opt.min_chain_weight,
        opt.max_chain_extend if opt.max_chain_extend < 2**31 else 2**31 - 1,
        opt.max_occ, opt.max_chain_gap,
        float(opt.mask_level), float(opt.drop_ratio),
        float(opt.XA_drop_ratio), float(opt.mask_level_redun),
        float(opt.mapQ_coef_len), float(opt.mapQ_coef_fac),
        opt.max_XA_hits, opt.max_XA_hits_alt,
        opt.pen_unpaired, opt.max_matesw, opt.max_ins,
        *[int(v) for v in np.asarray(opt.mat, dtype=np.int8).reshape(-1)])
    want = _lib().memfin_opt_size()
    if len(blob) < want:
        blob += b"\x00" * (want - len(blob))
    assert len(blob) == want, (len(blob), want)
    return blob


class RefBlob:
    """Reference view arrays shared across calls."""

    def __init__(self, fm):
        self.pac = np.ascontiguousarray(fm.pac, dtype=np.uint8)
        self.l_pac = fm.l_pac
        bns = fm.bnt
        self.offsets = np.array([c.offset for c in bns.contigs], np.int64)
        self.lens = np.array([c.length for c in bns.contigs], np.int32)
        self.is_alt = np.array([1 if c.is_alt else 0 for c in bns.contigs],
                               np.uint8)
        names = []
        name_off = []
        pos = 0
        for c in bns.contigs:
            name_off.append(pos)
            nb = c.name.encode() + b"\x00"
            names.append(nb)
            pos += len(nb)
        self.names = b"".join(names)
        self.name_off = np.array(name_off, np.int32)
        self.n = len(bns.contigs)


def flatten_tuple_seeds(opt, mems_list, caches):
    """Per-read seed tuples (x0, x1, x2, start << 32 | end) and their
    occurrence caches -> the flat arrays the C++ finalize consumes:
    (iv_off per read, x2, start, end, rbegs, rb_off per seed), with the
    occurrences sampled in reference order (bwamem.c:304-305)."""
    n = len(mems_list)
    iv_off = np.zeros(n + 1, np.int32)
    iv_x2, iv_start, iv_end, rbegs, rb_off = [], [], [], [], [0]
    for i, mems in enumerate(mems_list):
        iv_off[i + 1] = iv_off[i] + len(mems)
        for iv in mems:
            iv_x2.append(iv[2])
            iv_start.append(iv[3] >> 32)
            iv_end.append(iv[3] & 0xFFFFFFFF)
            step = iv[2] // opt.max_occ if iv[2] > opt.max_occ else 1
            k = 0
            count = 0
            cache = caches[i]
            while k < iv[2] and count < opt.max_occ:
                rbegs.append(cache[iv[0] + k])
                k += step
                count += 1
            rb_off.append(len(rbegs))
    return (iv_off, np.array(iv_x2, np.int64), np.array(iv_start, np.int32),
            np.array(iv_end, np.int32), np.array(rbegs, np.int64),
            np.array(rb_off, np.int32))


def _finalize(entry, opt, fm, ref_blob: RefBlob, reads, codes_list, mid,
              seeds, tail, device_ext) -> list[str]:
    """One native finalize call over the batch: entry(opt blob, reference,
    reads, *mid, seed arrays, *tail, out, cap, out_off).  device_ext (a
    torch device, or None/False) routes the chain2aln seed extensions
    through the band kernel (mem/ext_device.py) instead of the scalar C++
    DP.  Returns the SAM text of each read.  Traced as the span finalize:
    finalize.pack, finalize.native (the call, with its phases, counts and
    spans; reruns, the second call an undersized buffer takes) and
    finalize.unpack."""
    with tracing.span("finalize"):
        with tracing.span("finalize.pack"):
            n = len(reads)
            blob = pack_opt(opt)

            l_off = np.zeros(n + 1, np.int64)
            for i, c in enumerate(codes_list):
                l_off[i + 1] = l_off[i] + len(c)
            codes_flat = (np.concatenate(codes_list) if n
                          else np.zeros(0, np.uint8))
            codes_flat = np.ascontiguousarray(codes_flat, np.uint8)

            def blobify(items):
                out = []
                offs = np.full(n, -1, np.int64)
                pos = 0
                for i, s in enumerate(items):
                    if s is None:
                        continue
                    b = s if isinstance(s, bytes) else s.encode()
                    offs[i] = pos
                    out.append(b + b"\x00")
                    pos += len(b) + 1
                return b"".join(out), offs

            names_b, name_off = blobify([r.name for r in reads])
            quals_b, qual_off = blobify([r.qual for r in reads])
            comm_b, comm_off = blobify([r.comment for r in reads])
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            seeds = [np.ascontiguousarray(a, dt) for a, dt in zip(
                seeds, (np.int32, np.int64, np.int32, np.int32, np.int64,
                        np.int32))]
            seed_args = [a.ctypes.data_as(i64p if a.dtype == np.int64
                                          else i32p) for a in seeds]

            out_off = np.zeros(n + 1, np.int64)
            # initial output-buffer guess: a SAM record carries SEQ+QUAL
            # (~2x qlen) plus name/tags; long reads also emit supplementary
            # records.  An undersized guess is CORRECT but costs a full
            # second finalize run (the C++ side computes everything, then
            # reports the needed size — that silent 2x was the entire
            # pacbio finalize overhead once), so scale with total query
            # bytes, not just read count.
            cap = max(1 << 20, 1024 * n + 6 * int(l_off[-1]))

        def run(cap):
            out = ctypes.create_string_buffer(cap)
            rc = entry(
                blob,
                ref_blob.pac.ctypes.data_as(u8p), ref_blob.l_pac,
                ref_blob.offsets.ctypes.data_as(i64p),
                ref_blob.lens.ctypes.data_as(i32p),
                ref_blob.is_alt.ctypes.data_as(u8p),
                ref_blob.names, ref_blob.name_off.ctypes.data_as(i32p),
                ref_blob.n,
                n, codes_flat.ctypes.data_as(u8p),
                l_off.ctypes.data_as(i64p),
                names_b, name_off.ctypes.data_as(i64p),
                quals_b, qual_off.ctypes.data_as(i64p),
                comm_b, comm_off.ctypes.data_as(i64p),
                *mid, *seed_args, *tail, out, cap,
                out_off.ctypes.data_as(i64p))
            return rc, out

        with tracing.span("finalize.native") as sp, tracing.native(sp):
            def run_sized():
                rc, out = run(cap)
                if rc < 0:  # the buffer was short: -rc is the size needed
                    sp.count("reruns")
                    rc, out = run(-rc)
                return rc, out

            if device_ext:
                from bwa_tpu_torch.mem.ext_device import DeviceExtContext

                with DeviceExtContext(opt, fm, codes_flat, device_ext):
                    rc, out = run_sized()
            else:
                rc, out = run_sized()
        assert rc >= 0
        with tracing.span("finalize.unpack"):
            raw = out.raw[:rc].decode()
            return [raw[out_off[i]:out_off[i + 1]] for i in range(n)]


def finalize_se_arrays(opt, fm, ref_blob: RefBlob, reads, codes_list,
                       iv_off, iv_x2, iv_start, iv_end, rbegs_a, rb_off_a,
                       n_processed: int, rg_id: str | None,
                       device_ext=None, ids=None) -> list[str]:
    """The SE finalize (mem_finalize_se_batch) over pre-flattened
    seed/occurrence arrays (from flatten_tuple_seeds or se_flat_buckets).

    ids: optional per-read int64 hash_64 seeds (the ORIGINAL
    n_processed + read index) for callers that feed reads in a permuted
    order; None = id0 + i."""
    if ids is not None:
        ids = np.ascontiguousarray(ids, np.int64)
    mid = (n_processed,
           ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
           if ids is not None else None,
           (rg_id or "").encode())
    return _finalize(_lib().mem_finalize_se_batch, opt, fm, ref_blob, reads,
                     codes_list, mid, (iv_off, iv_x2, iv_start, iv_end,
                                       rbegs_a, rb_off_a), (), device_ext)


def finalize_pe_arrays(opt, fm, ref_blob: RefBlob, reads, codes_list,
                       iv_off, iv_x2, iv_start, iv_end, rbegs_a, rb_off_a,
                       n_processed: int, pes0, rg_id: str | None,
                       device_ext=None) -> list[str]:
    """The PE finalize (mem_finalize_pe_batch: insert-size estimate, mate
    rescue, pairing, SAM) over the whole batch's flat seed arrays, reads
    interleaved r1, r2.  n_processed is passed as is: the C++ halves it
    for the pair ids of hash_64 (memfin.cpp:2125).  pes0: the -I
    insert-size statistics (four PEStat, one per orientation), or None to
    estimate them from the batch."""
    pes_arr = np.zeros(20, np.float64)
    if pes0 is not None:
        for d in range(4):
            p = pes0[d]
            pes_arr[d * 5:d * 5 + 5] = (p.failed, p.low, p.high, p.avg, p.std)
    tail = (pes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(pes0 is not None))
    return _finalize(_lib().mem_finalize_pe_batch, opt, fm, ref_blob, reads,
                     codes_list, (n_processed, (rg_id or "").encode()),
                     (iv_off, iv_x2, iv_start, iv_end, rbegs_a, rb_off_a),
                     tail, device_ext)
