"""Drivers for aln/samse (bwtaln.c:159-228, bwase.c:507-577)."""

from __future__ import annotations

import sys

import numpy as np

from bwa_tpu_torch.aln import samse as se
from bwa_tpu_torch.aln.opts import BWA_AVG_ERR, GapOpt, cal_maxdiff
from bwa_tpu_torch.aln.sai import SaiReader, SaiWriter
from bwa_tpu_torch.aln.search import Aln1, cal_width, match_gap
from bwa_tpu_torch.aln.seqio import (PackedReads, open_reads, read_bt_packed,
                               read_bt_seqs)
from bwa_tpu_torch.index.fmindex import FMIndex
from bwa_tpu_torch.ops.fm_host import HostFM
from bwa_tpu_torch.utils.rand48 import Rand48

CHUNK = 0x40000


def _aln_batch_native(fm, pk: PackedReads, opt: GapOpt):
    """Batch bt_aln_batch (native/btgap.cpp) call; returns per-read
    list[Aln1] — same results as the Python spec below."""
    import ctypes

    import numpy as np

    from bwa_tpu_torch.native.build import get_lib
    from bwa_tpu_torch.sw2.core import Sw2Index

    lib = get_lib()
    if not getattr(lib, "_btgap_sig", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        c = ctypes.c_int32
        lib.bt_aln_batch.restype = ctypes.c_int64
        lib.bt_aln_batch.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i64p,
            u8p, i64p, c, i32p, i32p, i32p,
            c, c, c, c, c, c, c, c, c, c,
            i32p, i64p, ctypes.c_int64]
        lib._btgap_sig = True
    if not hasattr(fm, "_sw2idx"):
        fm._sw2idx = Sw2Index(fm)
    idx = fm._sw2idx
    inter = fm.occ_inter
    n = pk.n
    lens64 = pk.lens.astype(np.int64)
    seq_off = np.zeros(n + 1, np.int64)
    np.cumsum(lens64, out=seq_off[1:])
    # bwtaln.c:116-117 searches the REVERSED read: gather each trimmed
    # segment of codes_flat back-to-front in one fancy index
    total = int(seq_off[-1])
    ends = pk.codes_off[:-1] + lens64 - 1
    idx_rev = (np.repeat(ends, lens64)
               - (np.arange(total, dtype=np.int64)
                  - np.repeat(seq_off[:-1], lens64)))
    flat = np.ascontiguousarray(pk.codes_flat[idx_rev]) if total \
        else np.zeros(0, np.uint8)
    if opt.fnr > 0.0:
        uniq, inv = np.unique(pk.lens, return_inverse=True)
        md = np.array([cal_maxdiff(int(l), BWA_AVG_ERR, opt.fnr)
                       for l in uniq], np.int32)[inv]
    else:
        md = np.full(n, opt.max_diff, np.int32)
    md = np.ascontiguousarray(md, np.int32)
    # local_opt lives OUTSIDE the read loop in the reference
    # (bwtaln.c:88-101), so the max_gapo clamp is sticky across the batch
    mg = np.minimum(np.minimum.accumulate(md) if n else md,
                    np.int32(opt.max_gapo)).astype(np.int32)
    sl = np.where(pk.lens > opt.seed_len, np.int32(opt.seed_len),
                  np.int32(0x7FFFFFFF)).astype(np.int32)
    out_n = np.zeros(n, np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = max(1 << 16, 64 * n)
    while True:
        rec = np.zeros(cap, np.int64)
        tot = lib.bt_aln_batch(
            inter.ctypes.data_as(u8p),
            ctypes.c_int64(fm.seq_len), ctypes.c_int64(fm.primary),
            idx.L2.ctypes.data_as(i64p),
            flat.ctypes.data_as(u8p), seq_off.ctypes.data_as(i64p), n,
            md.ctypes.data_as(i32p), mg.ctypes.data_as(i32p),
            sl.ctypes.data_as(i32p),
            opt.s_mm, opt.s_gapo, opt.s_gape, opt.max_gape,
            opt.max_seed_diff, opt.max_entries, opt.max_del_occ,
            opt.indel_end_skip, opt.max_top2, opt.mode,
            out_n.ctypes.data_as(i32p), rec.ctypes.data_as(i64p), cap)
        if tot <= cap:
            break
        cap = int(tot)
    tot_rec = int(out_n.sum())
    return out_n, rec[: tot_rec * 8].reshape(tot_rec, 8)


def aln_core(prefix, fn_fa, opt: GapOpt, out_fp, fm=None, engine=None,
             device: str = "cuda") -> None:
    """bwa aln: compute SA intervals, write .sai.  BWA_TPU_ALN picks the
    search: "native" (the default, native/btgap.cpp), "device" (the gap
    machine on `device`: kernel K7 on a CUDA card, its plain version on
    the CPU; `engine`, when given, is a warm engine of fm on that device)
    or anything else (the Python spec, aln/search.py)."""
    import os

    if fm is None:
        fm = FMIndex.load(prefix)
    mode = os.environ.get("BWA_TPU_ALN", "native")
    use_native = mode == "native"
    use_device = mode == "device"
    if use_device:
        if engine is None:
            from bwa_tpu_torch.engine import make_engine

            engine = make_engine(fm, device)
    else:
        engine = HostFM(fm)
    reader = open_reads(opt.mode, fn_fa)
    writer = SaiWriter(out_fp, opt)
    tot = 0
    while True:
        if use_device:
            from bwa_tpu_torch.aln.batch_search import aln_batch_device

            pk = read_bt_packed(reader, CHUNK, opt.mode, opt.trim_qual)
            if pk.n == 0:
                break
            out_n, rows = aln_batch_device(fm, engine, pk, opt)
            writer.write_batch_raw(out_n, rows)
            tot += pk.n
            print(f"[bwa_aln_core] {tot} sequences have been processed.",
                  file=sys.stderr)
            continue
        if use_native:
            pk = read_bt_packed(reader, CHUNK, opt.mode, opt.trim_qual)
            if pk.n == 0:
                break
            out_n, rows = _aln_batch_native(fm, pk, opt)
            writer.write_batch_raw(out_n, rows)
            tot += pk.n
            print(f"[bwa_aln_core] {tot} sequences have been processed.",
                  file=sys.stderr)
            continue
        seqs = read_bt_seqs(reader, CHUNK, opt.mode, opt.trim_qual)
        if not seqs:
            break
        local = GapOpt(**{k: getattr(opt, k) for k in opt.__dataclass_fields__})
        for p in seqs:
            if opt.fnr > 0.0:
                local.max_diff = cal_maxdiff(p.len, BWA_AVG_ERR, opt.fnr)
            if local.max_diff < local.max_gapo:
                local.max_gapo = local.max_diff
            local.seed_len = opt.seed_len if opt.seed_len < p.len else 0x7FFFFFFF
            w = cal_width(engine, p.seq)
            seed_w = None
            if p.len > opt.seed_len:
                seed_w = cal_width(engine, p.seq[p.len - opt.seed_len:])
            # complement in place (bwtaln.c:116-117): seq becomes revcomp
            q = np.where(p.seq > 3, 4, 3 - p.seq).astype(np.uint8)
            alns = match_gap(engine, q, w,
                             None if p.len <= opt.seed_len else seed_w, local)
            writer.write_read(alns)
        tot += len(seqs)
        print(f"[bwa_aln_core] {tot} sequences have been processed.",
              file=sys.stderr)


def _bt_ref(fm):
    """Cached flat contig/hole tables for the native finalizers."""
    if not hasattr(fm, "_bt_ref_v"):
        bns = fm.bnt
        amb_off = np.array([h.offset for h in bns.holes], np.int64)
        amb_len = np.array([h.length for h in bns.holes], np.int32)
        ctg_off = np.array([c.offset for c in bns.contigs], np.int64)
        ctg_len = np.array([c.length for c in bns.contigs], np.int32)
        name_parts = []
        name_off = np.zeros(len(bns.contigs), np.int32)
        pos = 0
        for i, c in enumerate(bns.contigs):
            name_off[i] = pos
            nb = c.name.encode() + b"\x00"
            name_parts.append(nb)
            pos += len(nb)
        fm._bt_ref_v = (np.ascontiguousarray(fm.pac, np.uint8), ctg_off,
                        ctg_len, name_off, b"".join(name_parts), amb_off,
                        amb_len)
    return fm._bt_ref_v


def _sad_args(fm):
    """(pointer, is64) for the dense .sad.npy sidecar, or (None, 0):
    sad[k] == the inverse-Psi walk's bwt_sa(k) byte-for-byte, so the
    native finalizers skip ~sa_intv/2 occ lookups per SA resolve."""
    import ctypes

    sad = fm.sad
    if sad is None:
        return None, np.int32(0)
    return (ctypes.c_void_p(sad.ctypes.data),
            np.int32(1 if sad.dtype.itemsize == 8 else 0))


def _samse_batch_native(fm, pk: PackedReads, sai_rest: memoryview, opt,
                        n_occ, rg_id, rng: Rand48) -> tuple[str, int]:
    """Whole samse finalize for one batch in C++ (native/btsam.cpp):
    drand48 sampling, SA walks, ksw_global refinement, MD/NM, SAM text.
    Returns (sam_text, sai_bytes_consumed); the shared drand48 state
    advances exactly as the Python spec would."""
    import ctypes

    from bwa_tpu_torch.native.build import get_lib
    from bwa_tpu_torch.sw2.core import Sw2Index

    lib = get_lib()
    if not hasattr(fm, "_sw2idx"):
        fm._sw2idx = Sw2Index(fm)
    idx = fm._sw2idx
    pac, ctg_off, ctg_len, name_off, names_blob, amb_off, amb_len = \
        _bt_ref(fm)

    n = pk.n
    (codes_flat, codes_off, lens, full_lens, clip_lens, qual_off,
     rnames, rname_off, bc_blob, bc_off) = (
        pk.codes_flat, pk.codes_off, pk.lens, pk.full_lens, pk.clip_lens,
        pk.qual_off, pk.names_blob, pk.name_off, pk.bc_blob, pk.bc_off)
    has_qual = qual_off is not None
    qual_flat = pk.qual_flat if has_qual else np.zeros(0, np.uint8)
    sai_arr = np.frombuffer(sai_rest, np.uint8)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rng_state = np.array([rng.x], np.uint64)
    used = np.zeros(1, np.int64)
    cap = max(1 << 20, 300 * n)
    sad_ptr, sad_is64 = _sad_args(fm)
    while True:
        out_buf = np.zeros(cap, np.uint8)
        rng_state[0] = rng.x  # restore on retry: the call mutates it
        r = lib.bt_samse_batch(
            fm.occ_inter.ctypes.data_as(u8p),
            ctypes.c_int64(fm.seq_len), ctypes.c_int64(fm.primary),
            idx.L2.ctypes.data_as(i64p), idx.ssa64.ctypes.data_as(i64p),
            np.int32(fm.sa_intv),
            pac.ctypes.data_as(u8p), ctypes.c_int64(fm.l_pac),
            ctg_off.ctypes.data_as(i64p), ctg_len.ctypes.data_as(i32p),
            name_off.ctypes.data_as(i32p), names_blob, np.int32(len(ctg_off)),
            amb_off.ctypes.data_as(i64p), amb_len.ctypes.data_as(i32p),
            np.int32(len(amb_off)),
            np.int32(n), codes_flat.ctypes.data_as(u8p),
            codes_off.ctypes.data_as(i64p), lens.ctypes.data_as(i32p),
            full_lens.ctypes.data_as(i32p), clip_lens.ctypes.data_as(i32p),
            qual_flat.ctypes.data_as(u8p),
            qual_off.ctypes.data_as(i64p) if has_qual else None,
            rnames, rname_off.ctypes.data_as(i64p), bc_blob,
            bc_off.ctypes.data_as(i32p),
            sai_arr.ctypes.data_as(u8p), ctypes.c_int64(sai_arr.shape[0]),
            np.int32(opt.mode), np.int32(opt.max_top2), np.int32(n_occ),
            np.int32(opt.max_diff), ctypes.c_double(opt.fnr),
            rg_id.encode() if rg_id else None,
            rng_state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out_buf.ctypes.data_as(u8p), ctypes.c_int64(cap),
            used.ctypes.data_as(i64p), sad_ptr, sad_is64)
        if r >= 0:
            break
        if r == -1:
            raise RuntimeError("bt_samse_batch: truncated .sai")
        cap = int(-r)
    rng.x = int(rng_state[0])
    return out_buf[: int(r)].tobytes().decode(), int(used[0])


def _sampe_batch_native(fm, pk0: PackedReads, pk1: PackedReads, sai_rest0,
                        sai_rest1, opt0, opt, popt, ii_state: np.ndarray,
                        rg_id, rng: Rand48) -> tuple[str, int, int]:
    """Whole sampe finalize for one batch in C++ (bt_sampe_batch,
    native/btsam.cpp): the SE phase, insert-size inference, pairing, SW
    mate rescue, refinement and paired SAM.  aln/sampe.py is the spec.
    Returns (sam_text, sai0_used, sai1_used); rng and ii_state advance
    exactly like the spec's."""
    import ctypes

    from bwa_tpu_torch.native.build import get_lib
    from bwa_tpu_torch.sw2.core import Sw2Index

    lib = get_lib()
    if not getattr(lib, "_sampe_sig", False):
        lib.bt_sampe_batch.restype = ctypes.c_int64
        lib._sampe_sig = True
    if not hasattr(fm, "_sw2idx"):
        fm._sw2idx = Sw2Index(fm)
    idx = fm._sw2idx
    pac, ctg_off, ctg_len, name_off, names_blob, amb_off, amb_len = \
        _bt_ref(fm)
    n = pk0.n
    sai0 = np.frombuffer(sai_rest0, np.uint8)
    sai1 = np.frombuffer(sai_rest1, np.uint8)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def read_args(pk):
        qual_flat = pk.qual_flat if pk.qual_flat is not None \
            else np.zeros(0, np.uint8)
        return [pk.codes_flat.ctypes.data_as(u8p),
                pk.codes_off.ctypes.data_as(i64p),
                pk.lens.ctypes.data_as(i32p),
                pk.full_lens.ctypes.data_as(i32p),
                pk.clip_lens.ctypes.data_as(i32p),
                qual_flat.ctypes.data_as(u8p),
                pk.qual_off.ctypes.data_as(i64p)
                if pk.qual_off is not None else None,
                pk.names_blob, pk.name_off.ctypes.data_as(i64p),
                pk.bc_blob, pk.bc_off.ctypes.data_as(i32p)]

    rng_state = np.array([rng.x], np.uint64)
    ii_snap = ii_state.copy()
    used = np.zeros(2, np.int64)
    cap = max(1 << 20, 600 * n)
    quiet = 0
    sad_ptr, sad_is64 = _sad_args(fm)
    while True:
        out_buf = np.zeros(cap, np.uint8)
        rng_state[0] = rng.x  # restore on retry: the call mutates them
        ii_state[:] = ii_snap
        r = lib.bt_sampe_batch(
            fm.occ_inter.ctypes.data_as(u8p),
            ctypes.c_int64(fm.seq_len), ctypes.c_int64(fm.primary),
            idx.L2.ctypes.data_as(i64p), idx.ssa64.ctypes.data_as(i64p),
            ctypes.c_int32(fm.sa_intv),
            pac.ctypes.data_as(u8p), ctypes.c_int64(fm.l_pac),
            ctg_off.ctypes.data_as(i64p), ctg_len.ctypes.data_as(i32p),
            name_off.ctypes.data_as(i32p), names_blob,
            ctypes.c_int32(len(ctg_off)),
            amb_off.ctypes.data_as(i64p), amb_len.ctypes.data_as(i32p),
            ctypes.c_int32(len(amb_off)), ctypes.c_int32(n),
            *read_args(pk0), *read_args(pk1),
            sai0.ctypes.data_as(u8p), ctypes.c_int64(sai0.shape[0]),
            sai1.ctypes.data_as(u8p), ctypes.c_int64(sai1.shape[0]),
            ctypes.c_int32(opt0.mode), ctypes.c_int32(opt.mode),
            ctypes.c_int32(opt.max_top2), ctypes.c_int32(opt.s_mm),
            ctypes.c_int32(opt.max_diff), ctypes.c_double(opt.fnr),
            ctypes.c_int32(popt.max_isize), ctypes.c_int32(popt.force_isize),
            ctypes.c_int32(popt.max_occ), ctypes.c_int32(popt.n_multi),
            ctypes.c_int32(popt.N_multi), ctypes.c_int32(popt.is_sw),
            ctypes.c_double(popt.ap_prior), ctypes.c_int32(quiet),
            ii_state.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            rg_id.encode() if rg_id else None,
            rng_state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out_buf.ctypes.data_as(u8p), ctypes.c_int64(cap),
            used.ctypes.data_as(i64p), sad_ptr,
            ctypes.c_int32(int(sad_is64)))
        if r >= 0:
            break
        if r == -1:
            raise RuntimeError("bt_sampe_batch: truncated .sai")
        if r == -2:
            raise RuntimeError("paired reads have different names")
        cap = int(-r)
        quiet = 1  # don't repeat the isize stderr report on retry
    rng.x = int(rng_state[0])
    return (out_buf[: int(r)].tobytes().decode(), int(used[0]),
            int(used[1]))


def samse_core(prefix, fn_sa, fn_fa, n_occ, rg_id, rg_line, out,
               fm=None) -> None:
    """bwa samse (bwase.c:507-577)."""
    import os

    from bwa_tpu_torch import __version__
    from bwa_tpu_torch.cli import _hdr_lines

    se.initialize()
    if fm is None:
        fm = FMIndex.load(prefix)
    rng = Rand48(fm.bnt.seed)
    use_native = os.environ.get("BWA_TPU_SAMSE", "native") == "native"
    with open(fn_sa, "rb") as fp_sa:
        sai = SaiReader(fp_sa)
        opt = sai.opt
        pg = (f"@PG\tID:bwa\tPN:bwa-tpu-torch\tVN:{__version__}"
              "\tCL:bwa-tpu-torch samse")
        out.write(_hdr_lines(fm.bnt, rg_line, pg))
        reader = open_reads(opt.mode, fn_fa)
        if use_native:
            sai_rest = memoryview(fp_sa.read())
            while True:
                pk = read_bt_packed(reader, CHUNK, opt.mode, opt.trim_qual)
                if pk.n == 0:
                    break
                sam, used = _samse_batch_native(fm, pk, sai_rest, opt,
                                                n_occ, rg_id, rng)
                sai_rest = sai_rest[used:]
                out.write(sam)
            return
        engine = HostFM(fm)
        while True:
            seqs = read_bt_seqs(reader, CHUNK, opt.mode, opt.trim_qual)
            if not seqs:
                break
            for p in seqs:
                alns = sai.read_read()
                se.aln2seq_core(alns, p, rng, True, n_occ)
            se.cal_pac_pos(fm, engine, seqs, opt.max_diff, opt.fnr)
            se.refine_gapped(fm, seqs)
            for p in seqs:
                se.print_sam1(fm, p, None, opt.mode, opt.max_top2, rg_id, out)
