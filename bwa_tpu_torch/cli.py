"""Command-line interface, flag-compatible with the reference bwa.

    python -m bwa_tpu_torch.cli index [-p prefix] <in.fasta>
    python -m bwa_tpu_torch.cli mem [options] [--device cuda|cpu] <idx> <in.fq> [in2.fq]
    python -m bwa_tpu_torch.cli fastmap [-w -l -p -i -I] [--device cuda|cpu] <idx> <in.fq>
    python -m bwa_tpu_torch.cli aln [options] [--device cuda|cpu] <idx> <in.fq>
    python -m bwa_tpu_torch.cli samse [options] <idx> <in.sai> <in.fq>
    python -m bwa_tpu_torch.cli sampe [options] <idx> <1.sai> <2.sai>
                                      <1.fq> <2.fq>
    python -m bwa_tpu_torch.cli bwasw [options] <idx> <in.fq> [in2.fq]
    python -m bwa_tpu_torch.cli daemon start [--device cuda|cpu]|stop|status <idx>
    python -m bwa_tpu_torch.cli shm [-d|-l] [idx]
    python -m bwa_tpu_torch.cli fa2pac|pac2bwt|pac2bwtgen|bwtupdate|bwt2sa|
                                maxk|pemerge|xa2multi|qualfa2fq ...

mem runs single-end reads, paired-end reads from two files, or (-p)
interleaved pairs; the device defaults to the CUDA card.  mem -5 and
BWA_TPU_FINALIZE=python run the Python finalize after the device seeding;
fastmap seeds on the device too.  aln searches with the native C++ search
by default; BWA_TPU_ALN=device runs the gap machine on the device (kernel
K7 on the card, its plain version under --device cpu).  bwasw and the
index tools run on the host.

While a daemon (server.py) serves the index, mem, fastmap, aln, samse and
sampe forward to it, unless BWA_TPU_NO_DAEMON=1, an input is stdin or not
a regular file, or the output goes to a file (-o/-f); the forward runs
before torch is imported.
"""

from __future__ import annotations

import sys

from bwa_tpu_torch import __version__


def _hdr_lines(bnt, hdr_line: str | None, pg: str) -> str:
    """bwa_print_sam_hdr (bwa.c:407-441)."""
    out = []
    n_hd = n_sq = 0
    if hdr_line:
        for ln in hdr_line.split("\n"):
            if ln.startswith("@HD\t"):
                n_hd += 1
            if ln.startswith("@SQ\t"):
                n_sq += 1
    if n_hd == 0:
        out.append("@HD\tVN:1.5\tSO:unsorted\tGO:query")
    if n_sq == 0:
        for c in bnt.contigs:
            line = f"@SQ\tSN:{c.name}\tLN:{c.length}"
            if c.is_alt:
                line += "\tAH:*"
            out.append(line)
    if hdr_line:
        out.append(hdr_line)
    out.append(pg)
    return "\n".join(out) + "\n"


def _escape(s: str) -> str:
    return (s.replace("\\t", "\t").replace("\\n", "\n")
            .replace("\\r", "\r").replace("\\\\", "\\"))


# resident-engine cache (filled by the daemon, server.py): the warm
# (FMIndex, engine, device) per index (by real path), so that a command in
# the serving process skips the index load and the upload
_ENGINE_CACHE: dict = {}


def _engine(prefix, device=None, build=True, ignore_alt=False):
    """(fm, engine) for prefix: the daemon's warm index and, on its
    device, its engine; else a fresh load and, with build and a device, a
    fresh engine.  The engine is None for a host command (device None) or
    without build when none is warm.  ignore_alt (mem -j) changes the
    index, so it always loads afresh."""
    import os

    c = None if ignore_alt else _ENGINE_CACHE.get(os.path.realpath(prefix))
    if c is not None:
        fm = c[0]
        if c[2] == device:
            return fm, c[1]
    else:
        from bwa_tpu_torch.index.fmindex import FMIndex

        fm = FMIndex.load(prefix)
        if ignore_alt:
            for c0 in fm.bnt.contigs:
                c0.is_alt = False
    if device is None or not build:
        return fm, None
    from bwa_tpu_torch.engine import make_engine

    return fm, make_engine(fm, device)


def _daemon_forward(cmd: str, argv: list[str], args: list[str],
                    device: str | None, local: bool, tag: str, out_fp):
    """The resident-engine forward shared by mem/fastmap/aln/samse/sampe:
    the exit code when the daemon ran the command, None when the caller
    runs it itself.  argv: the command's arguments without --device
    (device: its value, None for a host command), args: the positional
    tail (prefix first), local: an output file or other local state.
    Never forwards inside the daemon (whose _ENGINE_CACHE is filled).
    Imports no torch."""
    import os

    if (_ENGINE_CACHE or local
            or os.environ.get("BWA_TPU_NO_DAEMON") == "1"
            # stdin ("-"), /dev/stdin, process substitution and other
            # non-regular files cannot be reopened by the daemon
            or not all(os.path.isfile(a) for a in args[1:])):
        return None
    from bwa_tpu_torch import server

    if not server.daemon_available(args[0]):
        return None
    # the daemon runs in its own cwd: the positional paths go absolute
    flags = argv[:len(argv) - len(args)]
    dev = [] if device is None else ["--device", device]
    return server.client_run(
        args[0], [cmd, *flags, *dev, *(os.path.abspath(a) for a in args)],
        out_fp, tag)


def _pop_device(argv: list[str]) -> tuple[list[str], str]:
    """Strip --device DEV / --device=DEV from argv."""
    out, device = [], "cuda"
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            out.append(a)
    return out, device


def main_mem(argv: list[str], out_fp=None, chunk_done_hook=None) -> int:
    """mem (fastmap.c main_mem).  chunk_done_hook(n_reads), if given, is
    called after each chunk is aligned (a streaming benchmark's clock)."""
    import getopt as getopt_mod
    import math

    from bwa_tpu_torch.io.fastq import SeqReader, read_batch
    from bwa_tpu_torch.mem.pairing import PEStat
    from bwa_tpu_torch.options import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ,
                                       MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
                                       MEM_F_NOPAIRING, MEM_F_PE,
                                       MEM_F_PRIMARY5, MEM_F_REF_HDR,
                                       MEM_F_SMARTPE, MEM_F_SOFTCLIP,
                                       MEM_F_XB, MemOptions)

    import queue
    import threading

    argv, device = _pop_device(argv)
    opt = MemOptions()
    mode = None
    fixed_chunk_size = -1
    rg_line = rg_id = hdr_line = pes0 = None
    ignore_alt = copy_comment = hdr_file = False
    out_fp = out_fp if out_fp is not None else sys.stdout
    opened_out = False
    try:
        opts, args = getopt_mod.getopt(
            argv, "51qpaMCSPVYjuk:c:v:s:r:t:R:A:B:O:E:U:w:L:d:T:Q:D:m:I:N:o:f:W:x:G:h:y:K:X:H:F:z:")
    except getopt_mod.GetoptError as e:
        print(f"[E::main_mem] {e}", file=sys.stderr)
        return 1
    for c, a in opts:
        c = c[1:]
        if c == "k": opt.set("min_seed_len", int(a))
        elif c == "1": pass
        elif c == "x": mode = a
        elif c == "w": opt.set("w", int(a))
        elif c == "A": opt.set("a", int(a))
        elif c == "B": opt.set("b", int(a))
        elif c == "T": opt.set("T", int(a))
        elif c == "U": opt.set("pen_unpaired", int(a))
        elif c == "t": opt.n_threads = max(int(a), 1)
        elif c == "P": opt.flag |= MEM_F_NOPAIRING
        elif c == "a": opt.flag |= MEM_F_ALL
        elif c == "p": opt.flag |= MEM_F_PE | MEM_F_SMARTPE
        elif c == "M": opt.flag |= MEM_F_NO_MULTI
        elif c == "S": opt.flag |= MEM_F_NO_RESCUE
        elif c == "Y": opt.flag |= MEM_F_SOFTCLIP
        elif c == "V": opt.flag |= MEM_F_REF_HDR
        elif c == "5": opt.flag |= MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ
        elif c == "q": opt.flag |= MEM_F_KEEP_SUPP_MAPQ
        elif c == "u": opt.flag |= MEM_F_XB
        elif c == "c": opt.set("max_occ", int(a))
        elif c == "d": opt.set("zdrop", int(a))
        elif c == "v": pass
        elif c == "j": ignore_alt = True
        elif c == "r": opt.set("split_factor", float(a))
        elif c == "D": opt.set("drop_ratio", float(a))
        elif c == "m": opt.set("max_matesw", int(a))
        elif c == "s": opt.set("split_width", int(a))
        elif c == "G": opt.set("max_chain_gap", int(a))
        elif c == "N": opt.set("max_chain_extend", int(a))
        elif c in ("o", "f"): out_fp = open(a, "w"); opened_out = True
        elif c == "W": opt.set("min_chain_weight", int(a))
        elif c == "y": opt.set("max_mem_intv", int(a))
        elif c == "C": copy_comment = True
        elif c == "K": fixed_chunk_size = int(a)
        elif c == "X": opt.mask_level = float(a)
        elif c == "F": pass
        elif c == "h":
            opt.set("max_XA_hits", None)
            parts = a.replace(",", " ").split()
            opt.max_XA_hits = opt.max_XA_hits_alt = int(parts[0])
            if len(parts) > 1:
                opt.max_XA_hits_alt = int(parts[1])
        elif c == "z": opt.XA_drop_ratio = float(a)
        elif c == "Q":
            opt.set("mapQ_coef_len", int(a))
            # int field in the reference (bwamem.h:79): log() truncates
            opt.mapQ_coef_fac = (int(math.log(opt.mapQ_coef_len))
                                 if opt.mapQ_coef_len > 0 else 0)
        elif c == "O":
            parts = a.replace(",", " ").split()
            opt.set("o_del", int(parts[0]))
            opt.set("o_ins", int(parts[-1]))
        elif c == "E":
            parts = a.replace(",", " ").split()
            opt.set("e_del", int(parts[0]))
            opt.set("e_ins", int(parts[-1]))
        elif c == "L":
            parts = a.replace(",", " ").split()
            opt.set("pen_clip5", int(parts[0]))
            opt.set("pen_clip3", int(parts[-1]))
        elif c == "R":
            rg_line = _escape(a)
            if not rg_line.startswith("@RG") or "\tID:" not in rg_line:
                print("[E::main_mem] malformed @RG line", file=sys.stderr)
                return 1
            rg_id = rg_line.split("\tID:")[1].split("\t")[0].split("\n")[0]
        elif c == "H":
            hdr_file = hdr_file or not a.startswith("@")
            ln = _escape(a) if a.startswith("@") else open(a).read().rstrip("\n")
            hdr_line = (hdr_line + "\n" + ln) if hdr_line else ln
        elif c == "I":
            parts = a.replace(",", " ").split()
            pes0 = [PEStat(failed=1) for _ in range(4)]
            p = PEStat(failed=0)
            p.avg = float(parts[0])
            p.std = float(parts[1]) if len(parts) > 1 else p.avg * 0.1
            p.high = (int(parts[2]) if len(parts) > 2
                      else int(p.avg + 4.0 * p.std + 0.499))
            p.low = (int(parts[3]) if len(parts) > 3
                     else max(int(p.avg - 4.0 * p.std + 0.499), 1))
            pes0[1] = p
    if rg_line:
        hdr_line = (hdr_line + "\n" + rg_line) if hdr_line else rg_line
    if len(args) not in (2, 3):
        print("Usage: python -m bwa_tpu_torch.cli mem [options] "
              "[--device cuda|cpu] <idxbase> <in1.fq> [in2.fq]",
              file=sys.stderr)
        return 1
    opt.apply_mode(mode)
    rc = _daemon_forward("mem", argv, args, device, opened_out or hdr_file,
                         "main_mem", out_fp)
    if rc is not None:
        return rc

    from bwa_tpu_torch.mem.pipeline import process_seqs, process_seqs_smart

    fm, engine = _engine(args[0], device, ignore_alt=ignore_alt)
    ks1 = SeqReader(args[1])
    ks2 = None
    if len(args) > 2:
        if opt.flag & MEM_F_PE:
            print("[W::main_mem] when '-p' is in use, the second query file "
                  "is ignored.", file=sys.stderr)
        else:
            ks2 = SeqReader(args[2])
            opt.flag |= MEM_F_PE
    pg = ("@PG\tID:bwa\tPN:bwa-tpu-torch\tVN:" + __version__
          + "\tCL:bwa-tpu-torch mem " + " ".join(argv))
    out_fp.write(_hdr_lines(fm.bnt, hdr_line, pg))
    chunk = (fixed_chunk_size if fixed_chunk_size > 0
             else opt.chunk_size * opt.n_threads)
    run = process_seqs_smart if opt.flag & MEM_F_SMARTPE else process_seqs
    n_processed = 0
    # the kt_pipeline analog (kthread.c:119-147, fastmap.c:64-123): a reader
    # thread parses chunk k+1 and a writer thread writes chunk k-1's SAM
    # while chunk k aligns; only this thread touches torch and the card.
    # The chunks are the same, so the bytes are too.
    rq: queue.Queue = queue.Queue(maxsize=2)
    wq: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()
    # an exception in either thread is raised here, never a hang on the
    # bounded queues
    pipe_err: list = []

    def _put(batch):  # gives up once the command has ended
        while not stop.is_set():
            try:
                return rq.put(batch, timeout=0.1)
            except queue.Full:
                pass

    def _reader():
        try:
            while not stop.is_set():
                batch = read_batch(ks1, ks2, chunk, copy_comment)
                _put(batch)
                if not batch:
                    return
        except BaseException as e:  # a malformed or truncated FASTQ, IO
            pipe_err.append(e)
            _put([])  # the sentinel: unblocks rq.get below

    def _writer():
        try:
            while True:
                batch = wq.get()
                if batch is None:
                    return
                for r in batch:
                    out_fp.write(r.sam)
        except BaseException as e:  # ENOSPC, EPIPE on out_fp
            pipe_err.append(e)
            while wq.get() is not None:  # drain: wq.put never blocks
                pass

    rt = threading.Thread(target=_reader, daemon=True)
    wt = threading.Thread(target=_writer, daemon=True)
    rt.start()
    wt.start()
    try:
        while True:
            reads = rq.get()
            if pipe_err:
                raise pipe_err[0]
            if not reads:
                break
            run(opt, engine, fm, reads, n_processed, pes0, rg_id)
            n_processed += len(reads)
            wq.put(reads)
            if chunk_done_hook is not None:
                chunk_done_hook(len(reads))
            if pipe_err:
                raise pipe_err[0]
    finally:
        # both threads end with the command (a daemon serves on after it):
        # the writer once it has drained, the reader at its next chunk
        wq.put(None)
        wt.join()
        stop.set()
        rt.join()
    if pipe_err:
        raise pipe_err[0]
    if opened_out:
        out_fp.close()
    return 0


def main_index(argv: list[str]) -> int:
    import getopt as getopt_mod

    from bwa_tpu_torch.index.build import index_build

    prefix = None
    is_64 = False
    algo = "auto"
    block_size = None
    opts, args = getopt_mod.getopt(argv, "6a:p:b:")
    for c, a in opts:
        if c == "-p":
            prefix = a
        elif c == "-6":
            is_64 = True
        elif c == "-a":
            algo = a
        elif c == "-b":
            block_size = int(a)
    if not args:
        print("Usage: python -m bwa_tpu_torch.cli index [-a is|bwtsw|rb2] "
              "[-b blockLen] [-p prefix] <in.fasta>", file=sys.stderr)
        return 1
    if prefix is None:
        prefix = args[0] + (".64" if is_64 else "")
    index_build(args[0], prefix, algo=algo, block_size=block_size)
    return 0


def main_fastmap(argv: list[str], out_fp=None) -> int:
    """main_fastmap (fastmap.c:408-483): SMEMs of every read with their
    positions; reads in chunks of 10 Mbp, as the reference's bseq_read
    loop."""
    import getopt as getopt_mod

    argv, device = _pop_device(argv)
    out_fp = out_fp if out_fp is not None else sys.stdout
    min_iwidth, min_len, print_seq, min_intv, max_intv = 20, 17, False, 1, 0
    opts, args = getopt_mod.getopt(argv, "w:l:pi:I:L:")
    for c, a in opts:
        if c == "-p": print_seq = True
        elif c == "-w": min_iwidth = int(a)
        elif c == "-l": min_len = int(a)
        elif c == "-i": min_intv = int(a)
        elif c == "-I": max_intv = int(a)
    if len(args) < 2:
        print("Usage: python -m bwa_tpu_torch.cli fastmap [options] "
              "[--device cuda|cpu] <idxbase> <in.fq>", file=sys.stderr)
        return 1
    rc = _daemon_forward("fastmap", argv, args, device, False,
                         "main_fastmap", out_fp)
    if rc is not None:
        return rc
    from bwa_tpu_torch.io.fastq import SeqReader, read_batch
    from bwa_tpu_torch.mem.fastmap import fastmap_batch

    fm, engine = _engine(args[0], device)
    ks = SeqReader(args[1])
    while True:
        reads = read_batch(ks, None, 10_000_000)
        if not reads:
            break
        for line in fastmap_batch(fm, engine, reads, min_iwidth, min_len,
                                  print_seq, min_intv, max_intv):
            out_fp.write(line + "\n")
    return 0


def main_aln(argv: list[str], out_fp_override=None) -> int:
    import getopt as getopt_mod

    from bwa_tpu_torch.aln.opts import (BWA_MODE_BAM, BWA_MODE_BAM_READ1,
                                        BWA_MODE_BAM_READ2, BWA_MODE_BAM_SE,
                                        BWA_MODE_CFY, BWA_MODE_GAPE,
                                        BWA_MODE_IL13, BWA_MODE_LOGGAP,
                                        BWA_MODE_NONSTOP, GapOpt)

    argv, device = _pop_device(argv)
    opt = GapOpt()
    opte = -1
    out_fp = sys.stdout.buffer
    opts, args = getopt_mod.getopt(argv, "n:o:e:i:d:l:k:LR:m:t:NM:O:E:q:f:b012IYB:")
    for c, a in opts:
        c = c[1:]
        if c == "n":
            if "." in a:
                opt.fnr = float(a)
                opt.max_diff = -1
            else:
                opt.max_diff = int(a)
                opt.fnr = -1.0
        elif c == "o": opt.max_gapo = int(a)
        elif c == "e": opte = int(a)
        elif c == "M": opt.s_mm = int(a)
        elif c == "O": opt.s_gapo = int(a)
        elif c == "E": opt.s_gape = int(a)
        elif c == "d": opt.max_del_occ = int(a)
        elif c == "i": opt.indel_end_skip = int(a)
        elif c == "l": opt.seed_len = int(a)
        elif c == "k": opt.max_seed_diff = int(a)
        elif c == "m": opt.max_entries = int(a)
        elif c == "t": opt.n_threads = int(a)
        elif c == "L": opt.mode |= BWA_MODE_LOGGAP
        elif c == "R": opt.max_top2 = int(a)
        elif c == "q": opt.trim_qual = int(a)
        elif c == "N":
            opt.mode |= BWA_MODE_NONSTOP
            opt.max_top2 = 0x7FFFFFFF
        elif c == "f": out_fp = open(a, "wb")
        elif c == "b": opt.mode |= BWA_MODE_BAM
        elif c == "0": opt.mode |= BWA_MODE_BAM_SE
        elif c == "1": opt.mode |= BWA_MODE_BAM_READ1
        elif c == "2": opt.mode |= BWA_MODE_BAM_READ2
        elif c == "I": opt.mode |= BWA_MODE_IL13
        elif c == "Y": opt.mode |= BWA_MODE_CFY
        elif c == "B": opt.mode |= int(a) << 24
    if opte > 0:
        opt.max_gape = opte
        opt.mode &= ~BWA_MODE_GAPE
    if len(args) < 2:
        print("Usage: python -m bwa_tpu_torch.cli aln [options] "
              "[--device cuda|cpu] <prefix> <in.fq>", file=sys.stderr)
        return 1
    opened_out = out_fp is not sys.stdout.buffer
    if out_fp_override is not None and not opened_out:
        out_fp = getattr(out_fp_override, "buffer", out_fp_override)
    rc = _daemon_forward("aln", argv, args, device, opened_out, "main_aln",
                         out_fp)
    if rc is not None:
        return rc
    from bwa_tpu_torch.aln.driver import aln_core

    fm, engine = _engine(args[0], device, build=False)
    aln_core(args[0], args[1], opt, out_fp, fm=fm, engine=engine,
             device=device)
    if opened_out:
        out_fp.close()
    return 0


def main_samse(argv: list[str], out_fp_override=None) -> int:
    import getopt as getopt_mod

    n_occ = 3
    rg_id = rg_line = None
    out = sys.stdout
    opts, args = getopt_mod.getopt(argv, "hn:f:r:")
    for c, a in opts:
        if c == "-n": n_occ = int(a)
        elif c == "-f": out = open(a, "w")
        elif c == "-r":
            rg_line = _escape(a)
            rg_id = rg_line.split("\tID:")[1].split("\t")[0].split("\n")[0]
    if len(args) < 3:
        print("Usage: python -m bwa_tpu_torch.cli samse [-n max_occ] "
              "<prefix> <in.sai> <in.fq>", file=sys.stderr)
        return 1
    opened_out = out is not sys.stdout
    if out_fp_override is not None and not opened_out:
        out = out_fp_override
    rc = _daemon_forward("samse", argv, args, None, opened_out,
                         "main_samse", out)
    if rc is not None:
        return rc
    from bwa_tpu_torch.aln.driver import samse_core

    samse_core(args[0], args[1], args[2], n_occ, rg_id, rg_line, out,
               fm=_engine(args[0])[0])
    if opened_out:
        out.close()
    return 0


def main_sampe(argv: list[str], out_fp_override=None) -> int:
    import getopt as getopt_mod

    from bwa_tpu_torch.aln.opts import PEOpt

    popt = PEOpt()
    rg_id = rg_line = None
    out = sys.stdout
    opts, args = getopt_mod.getopt(argv, "a:o:sPn:N:c:f:Ar:")
    for c, a in opts:
        if c == "-a": popt.max_isize = int(a)
        elif c == "-o": popt.max_occ = int(a)
        elif c == "-s": popt.is_sw = 0
        elif c == "-P": popt.is_preload = 1
        elif c == "-n": popt.n_multi = int(a)
        elif c == "-N": popt.N_multi = int(a)
        elif c == "-c": popt.ap_prior = float(a)
        elif c == "-f": out = open(a, "w")
        elif c == "-A": popt.force_isize = 1
        elif c == "-r":
            rg_line = _escape(a)
            rg_id = rg_line.split("\tID:")[1].split("\t")[0].split("\n")[0]
    if len(args) < 5:
        print("Usage: python -m bwa_tpu_torch.cli sampe [options] <prefix> "
              "<in1.sai> <in2.sai> <in1.fq> <in2.fq>", file=sys.stderr)
        return 1
    opened_out = out is not sys.stdout
    if out_fp_override is not None and not opened_out:
        out = out_fp_override
    rc = _daemon_forward("sampe", argv, args, None, opened_out,
                         "main_sampe", out)
    if rc is not None:
        return rc
    from bwa_tpu_torch.aln.sampe import sampe_core

    sampe_core(args[0], args[1:3], args[3:5], popt, rg_id, rg_line, out,
               fm=_engine(args[0])[0])
    if opened_out:
        out.close()
    return 0


def main_bwasw(argv: list[str]) -> int:
    """bwa bwasw (bwa_bwtsw2, bwtsw2_main.c:11-89)."""
    import getopt as getopt_mod

    import numpy as np

    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.sw2.aln import bsw2_aln
    from bwa_tpu_torch.sw2.types import Bsw2Opt
    from bwa_tpu_torch.utils.rand48 import Rand48

    opt = Bsw2Opt()
    rng = Rand48()
    rng.srand48(11)
    out = sys.stdout
    try:
        opts, args = getopt_mod.getopt(argv, "q:r:a:b:t:T:w:d:z:m:s:c:N:Hf:MI:SG:C")
    except getopt_mod.GetoptError as e:
        print(f"[main_bwasw] {e}", file=sys.stderr)
        return 1
    for c, v in opts:
        c = c[1:]
        if c == "q": opt.q = int(v)
        elif c == "r": opt.r = int(v)
        elif c == "a": opt.a = int(v)
        elif c == "b": opt.b = int(v)
        elif c == "w": opt.bw = int(v)
        elif c == "T": opt.t = int(v)
        elif c == "t": opt.n_threads = int(v)
        elif c == "z": opt.z = int(v)
        elif c == "s": opt.is_ = int(v)
        elif c == "m": opt.mask_level = float(np.float32(v))
        elif c == "c": opt.coef = float(np.float32(v))
        elif c == "N": opt.t_seeds = int(v)
        elif c == "M": opt.multi_2nd = 1
        elif c == "H": opt.hard_clip = 1
        elif c == "f": out = open(v, "w")
        elif c == "I": opt.max_ins = int(v)
        elif c == "S": opt.skip_sw = 1
        elif c == "C": opt.cpy_cmt = 1
        elif c == "G": opt.max_chain_gap = int(v)
        else:  # -d is accepted by the option string but unhandled
            return 1
    opt.qr = opt.q + opt.r
    if len(args) < 2:
        print(f"""
Usage:   python -m bwa_tpu_torch.cli bwasw [options] <target.prefix> <query.fa> [query2.fa]

Options: -a INT   score for a match [{opt.a}]
         -b INT   mismatch penalty [{opt.b}]
         -q INT   gap open penalty [{opt.q}]
         -r INT   gap extension penalty [{opt.r}]
         -w INT   band width [{opt.bw}]
         -m FLOAT mask level [{opt.mask_level:.2f}]

         -t INT   number of threads [{opt.n_threads}]
         -f FILE  file to output results to instead of stdout
         -H       in SAM output, use hard clipping instead of soft clipping
         -C       copy FASTA/Q comment to SAM output
         -M       mark multi-part alignments as secondary
         -S       skip Smith-Waterman read pairing
         -I INT   ignore pairs with insert >=INT for inferring the size distr [{opt.max_ins}]

         -T INT   score threshold divided by a [{opt.t}]
         -c FLOAT coefficient of length-threshold adjustment [{opt.coef:.1f}]
         -z INT   Z-best [{opt.z}]
         -s INT   maximum seeding interval size [{opt.is_}]
         -N INT   # seeds to trigger rev aln; 2*INT is also the chaining threshold [{opt.t_seeds}]
         -G INT   maximum gap size during chaining [{opt.max_chain_gap}]

Note: For long Illumina, 454 and Sanger reads, assembly contigs, fosmids and
      BACs, the default setting usually works well. For the current PacBio
      reads (end of 2010), '-b5 -q2 -r1 -z10' is recommended. One may also
      increase '-z' for better sensitivity.
""", file=sys.stderr)
        return 1
    # adjust for the match score (bwtsw2_main.c:80-81)
    opt.t *= opt.a
    opt.coef = float(np.float32(np.float32(opt.coef) * opt.a))
    fm = FMIndex.load(args[0])
    bsw2_aln(opt, fm, args[1], args[2] if len(args) > 2 else None, out, rng)
    if out is not sys.stdout:
        out.close()
    return 0


def main(argv=None, out_fp=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(f"Program: bwa-tpu-torch (BWA-compatible read aligner on "
              f"PyTorch/CUDA)\nVersion: {__version__}\n"
              f"Usage:   python -m bwa_tpu_torch.cli <command> [options]\n\n"
              f"Command: index     index sequences in the FASTA format\n"
              f"         mem       BWA-MEM algorithm (single-end, "
              f"paired-end, -p interleaved)\n"
              f"         fastmap   identify super-maximal exact matches\n"
              f"         aln       gapped/ungapped alignment\n"
              f"         samse     generate alignment (single ended)\n"
              f"         sampe     generate alignment (paired ended)\n"
              f"         bwasw     BWA-SW for long queries\n"
              f"         daemon    keep the index and the engine warm on "
              f"the card\n"
              f"         shm       manage indices in shared memory\n\n"
              f"         fa2pac    convert FASTA to PAC format\n"
              f"         pac2bwt   generate BWT from PAC\n"
              f"         pac2bwtgen alternative algorithm for generating "
              f"BWT\n"
              f"         bwtupdate update .bwt to the new format\n"
              f"         bwt2sa    generate SA from BWT and Occ\n"
              f"         maxk      histogram of the longest exact match a "
              f"base\n"
              f"         pemerge   merge overlapping paired ends\n"
              f"         xa2multi  split XA tags into records\n"
              f"         qualfa2fq FASTA + QUAL to FASTQ\n",
              file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "mem":
        return main_mem(rest, out_fp=out_fp)
    if cmd == "daemon":
        from bwa_tpu_torch.server import main_daemon

        return main_daemon(rest)
    if cmd == "index":
        return main_index(rest)
    if cmd == "fastmap":
        return main_fastmap(rest, out_fp=out_fp)
    if cmd == "aln":
        return main_aln(rest, out_fp_override=out_fp)
    if cmd == "samse":
        return main_samse(rest, out_fp_override=out_fp)
    if cmd == "sampe":
        return main_sampe(rest, out_fp_override=out_fp)
    if cmd in ("fa2pac", "pac2bwt", "pac2bwtgen", "bwtupdate", "bwt2sa",
               "maxk", "pemerge", "xa2multi", "qualfa2fq"):
        from bwa_tpu_torch import tools

        return getattr(tools, "main_" + cmd)(rest)
    if cmd in ("bwasw", "bwtsw2", "dbwtsw"):  # aliases per main.c:107-109
        return main_bwasw(rest)
    if cmd == "shm":
        from bwa_tpu_torch.shm import main_shm

        return main_shm(rest)
    print(f"[main] unrecognized command '{cmd}'", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
