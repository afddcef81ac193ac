#!/usr/bin/env python3
"""Quickest proof that bwa_tpu_torch runs on a CUDA card.

    python3 chip_smoke.py [--log DIR]
    python3 chip_smoke.py --aln-chunk
    python3 chip_smoke.py --k7-bench
    python3 chip_smoke.py --big-genome

Run from the repository root on a machine with one CUDA card.  With
--aln-chunk it only runs one whole `aln` chunk on the card (aln_chunk_main);
with --k7-bench only K7 and K7w at aln_se_100bp's first launches, alone,
on fewer lanes and on both occtab layouts (k7_bench_main); with
--big-genome only a 210 Mbp genome from the seed, indexed by the port's
index_build into build/big_genome, and 24,576 x 150 bp SE reads through
`mem` with BWA_TPU_TRIP_SORT unset, whose auto gate must launch K8 once
(big_genome_main; prints the index build's seconds and the phase wall).
Without, in order:
  1. builds the hand-written kernels (csrc/*.cu, nvcc sm_90a, in parallel)
     and the native library;
  2. makes a 4,641,652 bp genome (the size of E. coli K-12 MG1655) from a
     seed and indexes it with the port's index_build (cached in build/);
  3. holds each kernel to its plain PyTorch version on the card: K1 (the
     seeding machine) on pack_k=2 lanes and tagged long-read shards, with
     default and tiny caps; K2 (the band DP) at P=256 and P=512, with
     z-drop and h0 > 0, through ExtGatherEngine.run_fused and .run (the
     warp path, a warp per problem), and at P=1280 and P=3072 (the wide
     path, a block per problem); K5 (each problem in a window of its own
     band width) and K2's host-array mode through the kernel entry point
     (ops/ksw_pallas.py) at tests/test_ksw_pallas.py's shapes plus two wide
     ones (Q = 1500 and 3000);
  4. drives `mem` through the CLI on 4,096 x 150 bp SE reads (default
     options), on 512 x 2 kb + 32 x 10 kb reads with -x pacbio and on
     12,288 pairs of 150 bp reads from two FASTQs (insert 350 +- 40),
     counting kernel launches and recording every kernel call; checks the
     SAM of the first 64 reads of each SE phase (four of them 10 kb reads in
     the pacbio phase) against the port's CPU run of the same reads, and
     the SAM of the first 256 pairs, run alone on the card, against the CPU
     run of those pairs and against the card's run of them with the seed
     extensions on K2 (the PE finalize's callback); the CPU runs go in
     subprocesses from step 2 on; then 64 x 2 kb + 4 x 10 kb reads and two
     2.2 kb reads with an 860-base deletion (their extensions take the
     band-doubling retry) with -x pacbio -w 1100 (K2's wide path, P = 2304
     and 4480), whose SAM must equal the same reads' SAM with host
     extension on the card;
  4a. runs the Python mem route and fastmap through the CLI, K1's calls
     recorded apart: the 4,096 x 150 bp reads with -5 (the first 64 reads'
     SAM against the port's CPU run), and through BWA_TPU_FINALIZE=python
     (SAM equal to the C++ route's, read for read); the first 256 pairs
     through BWA_TPU_FINALIZE=python (SAM equal to the C++ route's run of
     them); 64 x 2 kb reads with -x pacbio -5, printing the reads the host
     spec re-seeds; the 4,096 x 150 bp reads through fastmap (the first 64
     reads' output against fastmap_lines through HostFM, and the reads on
     the per-read route); K1 launched in each; K1's first launch of the -5
     and of the fastmap phase timed and held to the plain version on the
     card on 257 of its lanes, the longest among them;
  4b. makes 65,536 x 100 bp SE reads (2% substitutions, 0.1% indels) and
     16,384 pairs of 100 bp reads (insert 350 +- 40) and runs `aln` on
     each FASTQ through the CLI with the default native search and with
     BWA_TPU_ALN=device (K7w and K7 on the card; the two .sai files must
     be equal byte for byte), then samse (90% of the reads mapped) and
     sampe (90% of the pairs properly paired) on the device .sai files;
     meanwhile a subprocess runs 256 of the SE reads with caps 8, 16,
     cap_a 2 and 120 steps (every rung and the host-spec fallback), whose
     .sai must equal the native search's;
  4c. starts the resident daemon (`daemon start --device cuda`) in a fresh
     process with a socket directory of its own, waits for its ping (fails
     if it exits first) and prints the seconds to the ping and each warm
     stage's (SE, PE, fastmap, pacbio, aln); forwards the smoke's own
     inputs through the Python client (mem SE, mem SE with
     BWA_TPU_TRIP_SORT=force, which must launch K8 in the daemon, mem PE
     from the two FASTQs, mem -x pacbio, fastmap, aln with
     BWA_TPU_ALN=device, samse on that .sai), each output equal to the main
     process's local one, the daemon's kernel launches, wall and card
     memory printed for each; the cold one-shot of the same mem SE command
     (BWA_TPU_NO_DAEMON=1); mem SE and aln again through the native client
     (client_exe()); mem SE with BWA_TPU_SEED_COMPACT=1 (the daemon
     serves it on the tail-compaction route: K13 launched in the daemon,
     SAM equal to the main process's default-route run); a bogus request
     through each client (non-zero exits, the daemon serving on);
     `daemon stop` (exit 0,
     the socket gone); then stages the index with `shm` under
     build/smoke/shm (the BWA_TPU_SHM_DIR of the whole run, so that no
     staging elsewhere on the host stands in for the index), runs mem SE
     on the attached index (the [M::bwa_idx_load_from_shm] line, SAM equal
     to the disk-loaded run's), times the index load and upload both ways
     and destroys the staging;
  4d. (run right after 4a) trip-sorted packing, K1's refill mode and
     main_mem's threads, on the same genome: 24,576 x 150 bp SE reads
     (bench.py's headline set) with BWA_TPU_TRIP_SORT off, force, force and
     off, and the 12,288 pairs off and force (SAM equal to the first off
     run's, K8 launched once under force and never under off); the SE
     reads with BWA_TPU_SEED_REFILL=1, then also BWA_TPU_REFILL_LANES=1024
     (SAM equal to the unsorted static run's, K1 launched only in its
     refill mode); prints each K1 launch's longest lane's steps with and
     without the sort and each refill launch's form (from the group
     form's own count), reads drawn and event ms; holds K8's launch to its
     plain version on all 24,576 rows, every refill launch of the main
     path on its own arguments (12,288 and 1,024 lanes), in its form, at
     int32 and int64, with every read drawn, and 257 of the reads drawn by
     128 lanes in both forms, to the plain version, each timed beside its
     bound; both forms must have run on the main path;
     then main_mem with -K in four chunks or more (SE against
     mem_se_150bp's SAM; PE with -I 350,40 against the one-chunk run with
     -I), printing each chunk's chunk_done_hook time;
  4f. (run right after 4d) the seeding routes off the default path:
     `mem` with BWA_TPU_SEED_MACHINE=split (K12: K1's state mode, pass 1,
     pass 2, pass 3 a launch each) and with BWA_TPU_SEED_COMPACT=1 (K13:
     the machine in segments, the lanes still running compacted between
     them) on step 4d's 24,576 SE reads and 12,288 pairs, step 4a's
     4,096 reads with -5 and its -x pacbio -5 reads, SAM equal to the
     unified route's runs of them, K1 never launched; the -x pacbio reads
     under each route (their lane shards need the provenance column these
     routes' seed store lacks: refused with a ValueError that names the
     route, as bwa_tpu's demux fails on them); each run's launches, K12 and
     K13 event ms, segments and the lanes at each compaction level; then the
     cross-check programs on the 4,096 SE reads, collect_seeds(fused=True)
     (K11) and collect_intv_batch_unfused (K10a, K10b), seeds equal to the
     unified route's read for read; sa_batch (K9) on 65,536 SA rows
     against fm.sa_lookup; sharded_seed_step on two shards of the card and
     the dry run's entry() on the 20 kb genome, each equal to its CPU run;
     each new kernel's first launch (K12a's pass-2 launch too, and K10a's,
     the warp form's; K13's first segment and one more) held to its plain
     version on the card on 256
     of its lanes and its longest (the whole machine state for K12 and
     K13), timed beside its bound;
  4e. (run right after 4b) the mesh, every visible card or, with one,
     two shards on cuda:0 (the log says which), as the CLI's engine
     (cli._ENGINE_CACHE, where the daemon keeps its own): mem on step 4d's
     24,576 SE reads and 12,288 pairs (SAM equal to the single-device
     engine's runs of them in step 4d) and aln with the device search on
     step 4b's 65,536 reads (.sai equal to step 4b's); each phase's wall,
     each kernel's launches and event ms a shard; each shard's first K1
     launch held to the plain version on a lane subset, its first K7
     launch on 32 lanes and its longest in a host subprocess that step 6
     waits for; dryrun_multichip on the mesh's size; two
     `python -m bwa_tpu_torch.parallel.multihost --device cuda` processes
     over gloo on 127.0.0.1 (rank r on cuda:(r mod cards)) on the SE reads
     in four --chunk-size batches, host 0's merged SAM equal to one
     process's (step 4d's), each host's wall;
  5. drives the kernel entry point through bwa_tpu_torch.bench_kernel at
     its three shapes (K2 host-array mode and K5, launches counted), and
     past the widths the first kernels refused (K5 at QP = 6016 with
     w = 100 and 3000, K2 host-array at P = 4480 and 8192) against the
     plain versions, each time beside its bound;
  6. holds every recorded kernel call to the plain version: the first call
     of each kernel, and K1's widest pacbio rung (as wide as the lane), on
     all their rows (and times both; K1 on seeds, seed_n, ovf, done_step and
     steps), every other call on a subset of its lanes or jobs (rows are
     independent, so the subset keeps the call's width, caps and band), and
     K5 and K2's host-array mode at each of bench_kernel's shapes; holds
     K7's first launch (on 256 of its lanes and its longest) and every K7w
     launch (256 lanes and the last) to the plain versions on the card,
     and the first launch of K7's second rung (cap 8192; 32 of its lanes
     and its longest) to the plain version on the host meanwhile;
     prints each K7 launch's event ms (the wrapper's, and the kernel's
     alone, without the scratch allocation), cap, lanes, longest lane's
     steps, ns a step and why its lanes overflowed (the stack cap, cap_a,
     max_steps), the device and native search seconds, the kernels'
     share of the device search's wall and the reads that fell back to
     the host spec; prints each K1 launch's event time with its longest
     lane's steps and ns a step, each K2 launch's event time with its P,
     n, the longest problem's rows and ns a row (and the same for K2's
     host-array mode at bench_kernel's shapes), the kernel table, the
     card's name and power limit, and finally {"ok": true, "device":
     {...}}.
Any failure exits non-zero before the last line.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# reads of the aln_ladder phase: each falls back to the Python spec (about
# 27 ms a read); 256 drive both rungs and the fallback
LADDER_READS = 256
GENOME_LEN = 4_641_652
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 memory rate (data sheet)
# H100 SXM INT32 issue rate: 64 INT32 lanes per SM (Hopper whitepaper) x 132
# SMs x 1.98 GHz, the boost clock behind the data sheet's 67 TFLOP/s FP32
INT_OPS_PER_S = 64 * 132 * 1.98e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


# --------------------------------------------------------------------------
# data made from the seed
# --------------------------------------------------------------------------

def make_genome(d: Path):
    import numpy as np

    fa = d / "mg1655_size.fa"
    stamp = d / "genome.seed"
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    if stamp.exists() and stamp.read_text() == str(SEED) \
            and (d / "mg1655_size.fa.sad.npy").exists():
        return fa, codes
    seq = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()
    with open(fa, "wb") as f:
        f.write(b">synthetic_k12_size\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + b"\n")
    from bwa_tpu_torch.index.build import index_build

    index_build(str(fa))
    stamp.write_text(str(SEED))
    return fa, codes


def simulate(codes, n, length, seed, err, indel_rate, prefix):
    """Reads cut from either strand: substitutions at rate err and, with
    probability indel_rate * length, one single-base indel (the shape of
    tests/datagen.py simulate_reads).  Returns (reads, origins) with
    origins = doubled-genome start of each read."""
    import numpy as np

    rng = np.random.default_rng(seed)
    glen = len(codes)
    reads, origins = [], []
    for i in range(n):
        s = int(rng.integers(0, glen - length))
        r = codes[s:s + length].copy()
        m = rng.random(length) < err
        r[m] = rng.integers(0, 4, int(m.sum()))
        if rng.random() < indel_rate * length:
            pos = int(rng.integers(1, length - 1))
            if rng.random() < 0.5:
                r = np.append(np.delete(r, pos), rng.integers(0, 4))
            else:
                r = np.insert(r, pos, rng.integers(0, 4))[:-1]
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
            origins.append(2 * glen - (s + length))
        else:
            origins.append(s)
        reads.append((f"{prefix}{i}", r.astype(np.uint8)))
    return reads, origins


def deletion_reads(codes, n, seed, prefix, pre=1100, gap=860, post=1100,
                   err=0.02):
    """Reads of `pre` bases and then the `post` bases that start `gap`
    bases further on (a deletion of `gap` bases), substitutions at rate
    err: a seed extension that crosses the deletion ends about `gap`
    columns off its diagonal, past -w 1100's retry threshold (825), so it
    takes the band-doubling retry (P = 4480)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        s = int(rng.integers(0, len(codes) - pre - gap - post))
        r = np.concatenate([codes[s:s + pre],
                            codes[s + pre + gap:s + pre + gap + post]])
        m = rng.random(len(r)) < err
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append((f"{prefix}{i}", r.astype(np.uint8)))
    return reads


def simulate_pairs(codes, n, length, seed, err, prefix, isize_mean=350,
                   isize_std=40):
    """Read pairs from fragments of insert size N(isize_mean, isize_std)
    (at least length + 10): the fragment's left end forwards and its right
    end reverse-complemented, substitutions at rate err, mates swapped half
    the time (the shape of tests/datagen.py simulate_reads(paired=True)).
    Returns (reads1, reads2), mates sharing a name."""
    import numpy as np

    rng = np.random.default_rng(seed)
    glen = len(codes)
    r1, r2 = [], []
    for i in range(n):
        isize = max(length + 10, int(rng.normal(isize_mean, isize_std)))
        s = int(rng.integers(0, glen - isize))
        mates = [codes[s:s + length].copy(),
                 (3 - codes[s + isize - length:s + isize])[::-1].copy()]
        for m in mates:
            sub = rng.random(length) < err
            m[sub] = rng.integers(0, 4, int(sub.sum()))
        if rng.random() < 0.5:
            mates.reverse()
        r1.append((f"{prefix}{i}", mates[0].astype(np.uint8)))
        r2.append((f"{prefix}{i}", mates[1].astype(np.uint8)))
    return r1, r2


def write_fastq(path: Path, reads) -> None:
    import numpy as np

    acgt = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for name, r in reads:
            f.write(b"@" + name.encode() + b"\n" + acgt[r].tobytes()
                    + b"\n+\n" + b"I" * len(r) + b"\n")


# --------------------------------------------------------------------------
# parity of each kernel with its plain version
# --------------------------------------------------------------------------

def k1_parity(fm, reads150, reads2k):
    import numpy as np
    import torch

    from bwa_tpu_torch.index.fmindex import DeviceFMIndex
    from bwa_tpu_torch.mem.batch_seed import _pack_bucket
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _next_valid_device
    from bwa_tpu_torch.options import MemOptions

    tt = DeviceFMIndex(fm, device="cuda").tree()
    # pack_k=2 lanes: read i | N | read B2+i | N
    B2, L = 256, 192
    q = np.full((B2, 2 * (L + 1)), 4, np.uint8)
    ql = np.zeros(B2, np.int32)
    for k in range(2):
        for i in range(B2):
            r = reads150[k * B2 + i][1]
            q[i, k * (L + 1):k * (L + 1) + len(r)] = r
            ql[i] = k * (L + 1) + len(r)
    opt = MemOptions()
    opt.apply_mode("pacbio")
    qs, qls, _, _, _, _, shard, ns = _pack_bucket(
        opt, [r for _, r in reads2k[:16]], 64)
    n = 16 * ns
    lanes = [("pack2", q, ql, None, (19, 28, 10, 20)),
             ("shard", qs[:n], qls[:n], tuple(a[:n] for a in shard),
              (17, 170, 10, 20))]
    results = []
    for name, q, ql, sh, consts in lanes:
        for cap, cap_s in ((16, 64), (2, 6)):
            qd = torch.from_numpy(q).cuda()
            qld = torch.from_numpy(ql).cuda()
            nv = _next_valid_device(qd, qld)
            outs = [k1_outputs(fn(tt, qd, qld, nv, *consts, cap=cap,
                                  cap_s=cap_s, use_p3=True, shard=sh))
                    for fn in (fmm.seed_machine, fmm.seed_machine_plain)]
            ok = all(torch.equal(a, b) for a, b in zip(*outs))
            res = dict(case=f"{name} cap={cap} cap_s={cap_s}",
                       lanes=int(q.shape[0]), equal=bool(ok),
                       overflow_lanes=int(outs[0][2].sum()),
                       seeds=int(outs[0][1].sum()),
                       steps=int(outs[0][4][0]))
            log(f"K1 parity {res}")
            results.append(res)
            if not ok:
                fail(f"K1 disagrees with its plain version: {res}")
            if cap == 2 and not res["overflow_lanes"]:
                fail("K1 parity: the tiny caps did not overflow")
    return results


def k2_parity(fm, reads2k, origins):
    import numpy as np

    from bwa_tpu_torch.ops.ext_gather import ExtGatherEngine, band_clamp
    from bwa_tpu_torch.options import MemOptions

    rng = np.random.default_rng(SEED + 2)
    sel = list(range(24))
    qflat = np.concatenate([reads2k[i][1] for i in sel])
    meta, pos = [], 0
    two_l = 2 * fm.l_pac
    for i in sel:
        ln = len(reads2k[i][1])
        s = origins[i]
        lo, hi = (0, fm.l_pac) if s < fm.l_pac else (fm.l_pac, two_l)
        for k in range(3):
            qbeg = int(rng.integers(1, ln - 80)) if k else 0
            slen = int(rng.integers(20, 60))
            # k == 2: the seed sits 90 bases off the read's diagonal, so
            # the best path runs far from it and the band-doubling retry
            # (P = 512) is taken
            rbeg = min(s + qbeg + (90 if k == 2 else 0), hi - slen - 1)
            meta.append([pos, ln, qbeg, slen, rbeg,
                         max(lo, rbeg - qbeg - 200),
                         min(hi, rbeg + (ln - qbeg) + 200),
                         int(rng.integers(slen, 3 * slen))])
        pos += ln
    meta = np.array(meta, np.int64)
    from bwa_tpu_torch.ops import ksw_band

    class PlainEngine(ExtGatherEngine):
        """The same fused extension over the plain band DP."""

        def _side(self, P, *a):
            o = a[-1]
            return ksw_band.ksw_band_side_plain(
                self.pac, self.l_pac, self._qflat, *a[:-1], o["mat"],
                o["o_del"], o["e_del"], o["o_ins"], o["e_ins"], o["zdrop"],
                P)[:, :6]

    cuda = ExtGatherEngine(fm.pac, fm.l_pac, fm.coord_dtype, device="cuda")
    plain = PlainEngine(fm.pac, fm.l_pac, fm.coord_dtype, device="cuda")
    cuda.set_reads(qflat)
    plain.set_reads(qflat)

    results = []
    for zdrop in (100, 20):
        opt = MemOptions()
        opt.apply_mode("pacbio")
        opt.zdrop = zdrop
        got = cuda.run_fused(meta, opt)
        want = plain.run_fused(meta, opt)
        res = dict(case=f"run_fused pacbio zdrop={zdrop} P=256/512",
                   jobs=int(len(meta)), equal=bool(np.array_equal(got, want)),
                   retries=int((got[:, 5] > opt.w).sum()
                               + (got[:, 11] > opt.w).sum()))
        log(f"K2 parity {res}")
        results.append(res)
        if not res["equal"]:
            fail(f"K2 disagrees with its plain version: {res}")
        if not res["retries"]:
            fail("K2 parity: no job took the band-doubling retry")
    import torch

    n = len(meta)
    qe = meta[:, 2] + meta[:, 3]
    qlen = meta[:, 1] - qe
    for w in (100, 200, 600, 1500):  # P = 256, 512, 1280 and 3072
        opt = MemOptions()
        opt.apply_mode("pacbio")
        ws = band_clamp(qlen, np.full(n, w), 1, 1, 1, 1, 1, opt.pen_clip3)
        args = (meta[:, 0] + qe, np.ones(n), qlen, meta[:, 4] + meta[:, 3],
                np.ones(n), meta[:, 6] - (meta[:, 4] + meta[:, 3]), ws,
                meta[:, 7])
        rest = (opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                opt.zdrop)
        got = cuda.run(*args, *rest)
        t = [torch.as_tensor(np.asarray(a, np.int64), device="cuda")
             for a in args]
        want = ksw_band.ksw_band_side_plain(
            cuda.pac, cuda.l_pac, cuda._qflat, *t, opt.mat, opt.o_del,
            opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
            ksw_band._band_for(int(ws.max())))[:, :6].cpu().numpy()
        res = dict(case=f"run w={w} P={ksw_band._band_for(int(ws.max()))}",
                   jobs=n, equal=bool(np.array_equal(got, want)))
        log(f"K2 parity {res}")
        results.append(res)
        if not res["equal"]:
            fail(f"K2 disagrees with its plain version: {res}")
    return results


def entry_parity():
    """K5 and K2's host-array mode against their plain versions on the
    same device tensors, and the two entry points against each other."""
    import numpy as np
    import torch

    from bwa_tpu_torch.bench_kernel import entry_args, ragged_problems
    from bwa_tpu_torch.ops import ksw_band, ksw_full, ksw_pallas

    results = []
    # tests/test_ksw_pallas.py's shapes, then wide queries (K5: QP = 1536
    # and 3072; K2: P = 1408 and 2432, the wide path)
    for seed, n, q, t, zdrop, w_hi in (
            (1, 37, 80, 150, 100, 120), (2, 64, 128, 128, -1, 120),
            (3, 16, 33, 300, 20, 120), (4, 8, 700, 900, 100, 120),
            (5, 6, 1500, 1200, 100, 700), (6, 3, 3000, 1600, 100, 1200)):
        a = entry_args(ragged_problems(seed, n, q, t, w_hi), zdrop)
        rest = (a[4], 6, 1, 6, 1, zdrop)
        QP = -(-(q + 1) // 128) * 128
        res = dict(case=f"n={n} Q={q} T={t} zdrop={zdrop}", QP=QP)
        for name, width, kern, plain in (
                ("K5", QP, ksw_full.ksw_full, ksw_full.full_rows),
                ("K2 host-array", q, ksw_band.ksw_band_arrays,
                 ksw_band.ksw_band_arrays_plain)):
            d = ksw_pallas.device_rows(*a[:11], a[12], width, "cuda")
            args = (*d, *rest)
            if name != "K5":
                res["P"] = ksw_band._band_for(int(d[4].max()))
                args = (*args, res["P"])
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            res[name] = int((got.to(torch.int64) - want.to(torch.int64))
                            .abs().max())
        full = ksw_pallas.extend_batch_pallas(*a)
        band = ksw_pallas.extend_band_pallas(*a)
        res["entry_points_equal"] = all(np.array_equal(x, y)
                                        for x, y in zip(full, band))
        log(f"K5/K2 host-array parity {res}")
        results.append(res)
        if res["K5"] or res["K2 host-array"] or not res["entry_points_equal"]:
            fail(f"kernel entry point disagrees with a plain version: {res}")
    return results


def band_cells(rows, w, qlen) -> int:
    """Cells the band DP evaluates at most, summed over problems, with
    ~20 integer operations each (ksw.c:460-478 inner loop).  Row i of a
    problem covers query columns max(0, i - w) .. min(i + w + 1, qlen)
    (ksw.c:454-458; the adaptive beg/end only narrows that); rows is each
    problem's rows swept.  rows, w, qlen: [n] integer tensors."""
    import torch

    rows, w, q = (a.to(torch.int64) for a in (rows, w, qlen))
    r = torch.minimum(rows, q + w)  # a row past qlen + w has no band
    # sum of min(i + w + 1, q): i + w + 1 for the first k rows, q after
    k = torch.minimum((q - w - 1).clamp(min=0), r)
    hi = k * (w + 1) + k * (k - 1) // 2 + (r - k) * q
    m = (r - w - 1).clamp(min=0)  # rows i > w: the band starts at i - w
    return int((hi - m * (m + 1) // 2).sum())


def per_unit(ms, units):
    """ns a step or row of the longest chain; None when it swept none."""
    return ms * 1e6 / units if units else None


def time_entry(kind, bench):
    """K5 or K2's host-array mode at every bench_kernel shape: the kernel
    against its plain version on the same device tensors (error, plain
    time); the times at the first shape, and the work a bound counts from
    that shape's rows.  bench maps (kind, shape) to run_shape's line."""
    import torch

    from bwa_tpu_torch import bench_kernel

    kern, plain, _ = bench_kernel.KERNELS[kind]
    checked = []
    for shape in bench_kernel.SHAPES:
        args = bench_kernel.device_args(kind, *shape)
        out = kern(*args)
        want, plain_ms = timed_once(lambda: plain(*args))
        err = int((out.to(torch.int64) - want.to(torch.int64)).abs().max())
        ms = bench[kind, shape]["kernel_s"] * 1e3
        top = int(out[:, 6].max())
        checked.append(dict(shape=bench[kind, shape]["shape"], err=err,
                            ms=ms, plain_ms=plain_ms, longest_rows=top,
                            ns_per_row=per_unit(ms, top)))
        log(f"{kind} entry {checked[-1]}")
        if err:
            fail(f"{kind} entry disagrees with its plain version at "
                 f"{checked[-1]}")
        if shape == bench_kernel.SHAPES[0]:
            first = args, out
    (q, t, qlen, _, w, *_), out = first
    n, width = q.shape
    rows = out[:, 6].to(torch.int64)
    # K5 sweeps all QP columns of a row (full_width_cells), but those
    # outside the band are masked and reach no output.
    cells = band_cells(rows, w, qlen)
    nbytes = q.numel() + t.numel() + n * 4 * 4 + n * 7 * 4
    res = dict(ms=checked[0]["ms"], plain_ms=checked[0]["plain_ms"],
               equal=True, err=0, shape=checked[0]["shape"],
               rows=int(rows.sum()), cells=cells, bytes=int(nbytes),
               ops=float(cells * 20), shapes=checked,
               longest_rows=checked[0]["longest_rows"],
               ns_per_row=checked[0]["ns_per_row"])
    if kind == "full":
        res["full_width_cells"] = int(rows.sum()) * width
    return res


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------

class Recorder:
    """Stands in for a kernel wrapper that the main path calls: keeps every
    call's arguments (tensors cloned) under the phase that made it, so the
    kernel can be held to its plain version at each shape the path gave
    it, brackets every call with CUDA events and keeps keep(output) of
    each call."""

    def __init__(self, mod, name, keep=None):
        self.mod, self.name, self.real = mod, name, getattr(mod, name)
        self.keep = keep
        self.phase = None
        self.calls = []  # (phase, args, kw)
        self.kept = []
        self.events = []  # (call index, start, end)
        self.call_ms = {}
        setattr(mod, name, self)

    def __call__(self, *args, **kw):
        import torch

        self.calls.append((self.phase, [a.clone() if torch.is_tensor(a)
                                        else a for a in args], dict(kw)))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.real(*args, **kw)
        b.record()
        self.events.append((len(self.calls) - 1, a, b))
        self.kept.append(self.keep(out) if self.keep else None)
        return out

    def take_ms(self) -> float:
        """Summed event time of the calls since the last take (after a
        synchronize); each call's time goes to call_ms."""
        for i, a, b in self.events:
            self.call_ms[i] = a.elapsed_time(b)
        ms = sum(self.call_ms[i] for i, _, _ in self.events)
        self.events = []
        return ms

    def restore(self):
        setattr(self.mod, self.name, self.real)


def start_cpu_run(d, prefix, name, fqs, extra):
    """The port's CPU run of `mem` on the FASTQs fqs, in a subprocess that
    sees no card; returns (process, log file, SAM path, and a dict that a
    waiter thread fills with the run's seconds)."""
    sam = d / f"{name}_cpu.sam"
    err = open(d / f"{name}_cpu.log", "w")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bwa_tpu_torch.cli", "mem", *extra,
         "--device", "cpu", "-o", str(sam), str(prefix), *map(str, fqs)],
        cwd=REPO, env=env, stdout=err, stderr=subprocess.STDOUT)
    took = {}
    threading.Thread(target=lambda: took.setdefault(
        "s", (proc.wait(), time.perf_counter() - t0)[1]), daemon=True).start()
    return proc, err, sam, took


def wait_cpu_run(cpu, what) -> tuple[str, float]:
    """The CPU run's SAM text and seconds, once it has ended."""
    proc, err, sam_path, took = cpu
    if proc.wait() != 0:
        fail(f"{what}: the CPU run exited {proc.returncode} (see {err.name})")
    while "s" not in took:
        time.sleep(0.01)
    return sam_path.read_text(), took["s"]


def run_mem(prefix, fqs, extra, cmd="mem"):
    """`cmd` (mem or fastmap) through the CLI on the card: (text, seconds)."""
    from bwa_tpu_torch.cli import main as cli_main
    import torch

    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli_main([cmd, *extra, "--device", "cuda", str(prefix),
                   *map(str, fqs)], out_fp=out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        fail(f"{cmd} {' '.join(extra)} exited {rc}")
    return out.getvalue(), dt


@contextlib.contextmanager
def finalize_python():
    """BWA_TPU_FINALIZE=python for the calls made inside."""
    os.environ["BWA_TPU_FINALIZE"] = "python"
    try:
        yield
    finally:
        os.environ.pop("BWA_TPU_FINALIZE", None)


def records_of(sam: str, names: set | None = None) -> str:
    """The SAM's records (of the reads named in names, or all)."""
    return "".join(ln + "\n" for ln in sam.split("\n")
                   if ln and not ln.startswith("@")
                   and (names is None or ln.split("\t", 1)[0] in names))


def check_sam(sam: str, n_reads: int) -> None:
    recs = [ln for ln in sam.split("\n") if ln and not ln.startswith("@")]
    names = {ln.split("\t", 1)[0] for ln in recs}
    if len(names) != n_reads:
        fail(f"SAM covers {len(names)} reads, expected {n_reads}")
    mapped = sum(1 for ln in recs if not int(ln.split("\t")[1]) & 4)
    if mapped < 0.9 * n_reads:
        fail(f"only {mapped} of {n_reads} reads mapped")


def check_pe_sam(sam: str, n_pairs: int) -> float:
    """Every pair has its two primary records; returns the share of pairs
    whose primaries are both flagged properly paired (0x2)."""
    prim = {}
    for ln in sam.split("\n"):
        if not ln or ln.startswith("@"):
            continue
        name, flag = ln.split("\t", 2)[:2]
        flag = int(flag)
        if not flag & 0x900:
            prim.setdefault(name, []).append(flag)
    if len(prim) != n_pairs or any(len(f) != 2 for f in prim.values()):
        fail(f"PE SAM: {len(prim)} pairs with primary records, expected "
             f"{n_pairs} pairs of two")
    proper = sum(all(f & 2 for f in fl) for fl in prim.values()) / n_pairs
    if proper < 0.9:
        fail(f"PE SAM: only {proper:.1%} of pairs properly paired")
    return proper


def check_fastmap(out: str, n_reads: int) -> None:
    """One SQ line and one // a read, and SMEMs with positions."""
    lines = out.split("\n")
    n_sq = sum(ln.startswith("SQ\t") for ln in lines)
    if n_sq != n_reads or lines.count("//") != n_reads:
        fail(f"fastmap printed {n_sq} reads, expected {n_reads}")
    if sum(ln.startswith("EM\t") and not ln.endswith("\t*")
           for ln in lines) < n_reads:
        fail("fastmap printed fewer placed SMEMs than reads")


def records_differ(sam_a: str, sam_b: str):
    """A read whose SAM records differ between two runs, with both
    runs' records of it, or None."""
    by = []
    for sam in (sam_a, sam_b):
        recs = {}
        for ln in sam.split("\n"):
            if ln and not ln.startswith("@"):
                recs.setdefault(ln.split("\t", 1)[0], []).append(ln)
        by.append(recs)
    for name in by[0].keys() | by[1].keys():
        if by[0].get(name) != by[1].get(name):
            return dict(read=name, a=by[0].get(name), b=by[1].get(name))
    return None


def zero_launches():
    from bwa_tpu_torch.ops import (fm, fm_machine, gap_machine, ksw_band,
                                   ksw_full)

    fm_machine.launches = fm_machine.refill_launches = fm.probe_launches = 0
    fm_machine.refill_group_launches = 0
    fm_machine.smem_launches = fm_machine.seed3_launches = 0
    fm_machine.segment_launches = 0
    fm.sa_launches = fm.smem1a_launches = fm.strategy1_launches = 0
    fm.collect_launches = 0
    ksw_band.launches = ksw_band.wide_launches = 0
    ksw_band.array_launches = ksw_full.launches = 0
    gap_machine.launches = gap_machine.width_launches = 0


def read_launches() -> dict:
    """Each wrapper's count, as the daemon logs them ("K2": K2's gather
    mode on both paths, "K2 wide": those at P > 1024)."""
    from bwa_tpu_torch.server import launch_counts

    return launch_counts()


def main_path(d, prefix, phase, reads, extra, recs, reads2=None,
              cmd="mem", host_spec=None):
    """One phase of the main path through the CLI on the card, kernel
    launches counted and each recorded wrapper's event time summed;
    host_spec: a Counter of batch_seed.host_reseed, whose calls in the
    phase are the reads re-seeded by the host spec."""
    fqs = [d / f"{phase}.fq"]
    write_fastq(fqs[0], reads)
    if reads2 is not None:
        fqs.append(d / f"{phase}_2.fq")
        write_fastq(fqs[1], reads2)
    for r in recs.values():
        r.events = []
        r.phase = phase
    n0 = host_spec.n if host_spec else 0
    zero_launches()
    sam, dt = run_mem(prefix, fqs, extra, cmd)
    launches = read_launches()
    (d / f"{phase}.out").write_text(sam)  # step 4c's local output
    kernel_ms = {k: r.take_ms() for k, r in recs.items()}
    n = len(reads) * len(fqs)
    info = dict(phase=phase, reads=n,
                bases=int(sum(len(r) for _, r in reads)) * len(fqs),
                seconds=dt, reads_per_s=n / dt, launches=launches,
                kernel_event_ms=kernel_ms)
    if host_spec:
        info["host_spec_reads"] = host_spec.n - n0
    if cmd == "fastmap":
        check_fastmap(sam, len(reads))
    elif reads2 is None:
        check_sam(sam, len(reads))
    else:
        info["proper_pair_share"] = check_pe_sam(sam, len(reads))
    return info, sam


def check_first64(info, sam, cpu, names):
    """The phase's first SAM records (of the reads in names, 64 but for
    mem_pacbio_primary5's 8) against the CPU run's."""
    cpu_sam, secs = wait_cpu_run(cpu, info["phase"])
    same = records_of(sam, names) == records_of(cpu_sam, names)
    n = len(names)
    if not same:
        fail(f"{info['phase']}: SAM of the first {n} reads differs from the "
             f"CPU run")
    info.update({f"first{n}_equal_cpu": same, f"cpu_first{n}_seconds": secs})
    print(json.dumps(info), flush=True)


def check_pe256(d, prefix, fm, fqs, cpu):
    """The first 256 pairs alone: the card's SAM against the CPU run's,
    then the card's run with the seed extensions on K2 (the PE finalize's
    callback) against the card's host-extension run."""
    import torch

    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.io.fastq import SeqReader, read_batch
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.ops import ksw_band
    from bwa_tpu_torch.options import MEM_F_PE, MemOptions

    card_sam, card_s = run_mem(prefix, fqs, [])
    opt = MemOptions()
    opt.flag |= MEM_F_PE
    reads = read_batch(SeqReader(str(fqs[0])), SeqReader(str(fqs[1])),
                       1 << 62)
    k2_0 = ksw_band.launches
    t0 = time.perf_counter()
    process_seqs(opt, make_engine(fm, "cuda"), fm, reads, 0, None, None,
                 device_ext=True)
    torch.cuda.synchronize()
    ext_s = time.perf_counter() - t0
    k2 = ksw_band.launches - k2_0
    ext_sam = "".join(r.sam for r in reads)
    if not k2:
        fail("PE with device_ext=True launched no K2")
    if ext_sam != records_of(card_sam):
        fail("PE: the SAM with extension on K2 differs from the host "
             "extension's")
    cpu_sam, cpu_s = wait_cpu_run(cpu, "mem_pe_first256")
    if records_of(card_sam) != records_of(cpu_sam):
        fail("PE: SAM of the first 256 pairs differs from the CPU run")
    info = dict(phase="mem_pe_first256", pairs=len(reads) // 2,
                card_seconds=card_s, equal_cpu=True, cpu_seconds=cpu_s,
                device_ext_k2_launches=k2, device_ext_seconds=ext_s,
                device_ext_equal_host=True)
    print(json.dumps(info), flush=True)
    return info, card_sam


def check_w1100(prefix, fm, fq, info, sam):
    """mem -x pacbio -w 1100: the SAM with the seed extensions on K2 (bands
    of 2304 slots and 4480 for the retry, K2's wide path) against the same
    reads' SAM with host extension (the native ksw), both on the card."""
    import torch

    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.io.fastq import SeqReader, read_batch
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.options import MemOptions

    opt = MemOptions()
    opt.apply_mode("pacbio")
    opt.w = 1100
    reads = read_batch(SeqReader(str(fq)), None, 1 << 62)
    t0 = time.perf_counter()
    process_seqs(opt, make_engine(fm, "cuda"), fm, reads, 0, None, None,
                 device_ext=False)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if records_of(sam) != "".join(r.sam for r in reads):
        fail("mem_pacbio_w1100: the SAM with extension on K2 differs from "
             "the host extension's")
    info.update(host_ext_seconds=host_s, device_ext_equal_host=True)


def entry_wide():
    """The kernel entry point past the widths the first kernels refused:
    K5 at Q = 6,000 (QP = 6,016) with w = 100 and w = 3,000 (windows of 256
    and 6,016 slots) and K2's host-array mode at P = 4480 and 8192, each
    against its plain version on the card, with its time and bound."""
    import torch

    from bwa_tpu_torch import bench_kernel

    out = []
    for kind, shape in (("full", (64, 6000, 1024, 100)),
                        ("full", (64, 6000, 1024, 3000)),
                        ("band", (64, 6000, 1024, 2200)),
                        ("band", (64, 6000, 1024, 4090))):
        kern, plain, _ = bench_kernel.KERNELS[kind]
        args = bench_kernel.device_args(kind, *shape)
        got = kern(*args)
        want, plain_ms = timed_once(lambda: plain(*args))
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ms = cuda_time(lambda: kern(*args), 3)
        q, t, qlen, _, w = args[:5]
        rows = got[:, 6].to(torch.int64)
        cells = band_cells(rows, w, qlen)
        nbytes = q.numel() + t.numel() + q.shape[0] * (4 * 4 + 7 * 4)
        b_ms, b_by = bound(nbytes, cells * 20)
        res = dict(kernel="K5" if kind == "full" else "K2 host-array",
                   shape="{}x{}x{}/w{}".format(*shape), width=q.shape[1],
                   P=args[-1] if kind == "band" else None, err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   longest_rows=int(rows.max()),
                   ns_per_row=per_unit(ms, int(rows.max())))
        log(f"entry past 4096 {res}")
        out.append(res)
        if err:
            fail(f"kernel entry past 4096 disagrees with its plain version: "
                 f"{res}")
    if [r["P"] for r in out[2:]] != [4480, 8192]:
        fail(f"kernel entry past 4096: bands {[r['P'] for r in out]}")
    return out


# --------------------------------------------------------------------------
# aln (BWA-backtrack)
# --------------------------------------------------------------------------

class Counter:
    """Stands in for a function the aln path calls and counts the calls."""

    def __init__(self, mod, name):
        self.mod, self.name, self.real = mod, name, getattr(mod, name)
        self.n = 0
        setattr(mod, name, self)

    def __call__(self, *args, **kw):
        self.n += 1
        return self.real(*args, **kw)

    def restore(self):
        setattr(self.mod, self.name, self.real)


def run_aln(prefix, fq, device: bool):
    """`aln` through the CLI on the card: the default native search, or
    with device=True the device search (BWA_TPU_ALN=device: K7w and K7).
    Returns (.sai bytes, seconds)."""
    import torch

    from bwa_tpu_torch.cli import main as cli_main

    os.environ.pop("BWA_TPU_ALN", None)
    if device:
        os.environ["BWA_TPU_ALN"] = "device"
    out = io.BytesIO()
    try:
        t0 = time.perf_counter()
        rc = cli_main(["aln", "--device", "cuda", str(prefix), str(fq)],
                      out_fp=out)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        os.environ.pop("BWA_TPU_ALN", None)
    if rc != 0:
        fail(f"aln {'device' if device else 'native'} exited {rc}")
    return out.getvalue(), dt


def run_sam(args) -> tuple[str, float]:
    """samse or sampe through the CLI: (SAM text, seconds)."""
    from bwa_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli_main([str(a) for a in args], out_fp=out)
    if rc != 0:
        fail(f"{args[0]} exited {rc}")
    return out.getvalue(), time.perf_counter() - t0


def aln_phase(d, prefix, phase, fqs, recs, fallback):
    """Each FASTQ through `aln` with the native search and with the device
    search (kernel launches counted and timed; .sai bytes must be equal),
    then samse (one FASTQ: 90% of the reads mapped) or sampe (two: 90% of
    the pairs properly paired) on the device .sai files."""
    n_reads = 0
    info = dict(phase=phase, native_s=0.0, device_s=0.0, fallback_reads=0,
                launches={}, kernel_event_ms={})
    from bwa_tpu_torch.ops import gap_machine

    for r in recs.values():
        r.events = []
        r.phase = phase
    gap_machine.kernel_events = []  # K7's kernel alone, launch by launch
    sais = []
    for fq in fqs:
        n_reads += sum(1 for _ in open(fq)) // 4
        nat, t_nat = run_aln(prefix, fq, False)
        zero_launches()
        fb0 = fallback.n
        dev, t_dev = run_aln(prefix, fq, True)
        for k, v in read_launches().items():
            info["launches"][k] = info["launches"].get(k, 0) + v
        info["fallback_reads"] += fallback.n - fb0
        info["native_s"] += t_nat
        info["device_s"] += t_dev
        if dev != nat:
            fail(f"{phase}: the device search's .sai of {fq.name} differs "
                 f"from the native search's")
        sai = d / f"{fq.stem}.sai"
        sai.write_bytes(dev)
        sais.append(sai)
    info["kernel_event_ms"] = {k: r.take_ms() for k, r in recs.items()}
    alone = [a.elapsed_time(b) for a, b in gap_machine.kernel_events]
    gap_machine.kernel_events = None
    K7_ALONE_MS.extend(alone)
    info["k7_kernel_only_ms"] = sum(alone)
    info["kernel_share_of_device_wall"] = (
        sum(info["kernel_event_ms"].values()) / 1e3 / info["device_s"])
    info.update(reads=n_reads, sai_equal_native=True,
                device_reads_per_s=n_reads / info["device_s"],
                native_reads_per_s=n_reads / info["native_s"])
    if len(fqs) == 1:
        sam, info["samse_s"] = run_sam(["samse", prefix, sais[0], fqs[0]])
        check_sam(sam, n_reads)
        (d / f"{phase}.sam").write_text(sam)  # step 4c's local output
    else:
        sam, info["sampe_s"] = run_sam(["sampe", prefix, *sais, *fqs])
        info["proper_pair_share"] = check_pe_sam(sam, n_reads // 2)
    for name in ("K7", "K7w"):
        if info["launches"].get(name, 0) < 1:
            fail(f"{phase}: kernel {name} was not launched")
    log(f"aln phase {info}")
    return info


def start_aln_ladder(d: Path, prefix, reads):
    """The ladder phase in a subprocess (its host-spec fallback is Python,
    about 27 ms a read): `aln` with BWA_TPU_ALN=device and caps 8, 16, cap_a
    2 and 120 steps, so that every rung and the fallback run.  Returns the
    job for wait_aln_ladder."""
    fq = d / "aln_ladder.fq"
    write_fastq(fq, reads)
    out = d / "aln_ladder.json"
    err = open(d / "aln_ladder.log", "w")
    env = dict(os.environ, OMP_NUM_THREADS="1", BWA_TPU_ALN="device",
               BWA_TPU_ALN_CAPS="8,16", BWA_TPU_ALN_CAPA="2",
               BWA_TPU_ALN_MAX_STEPS="120")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--aln-ladder",
         str(prefix), str(fq), str(out)], cwd=REPO, env=env, stdout=err,
        stderr=subprocess.STDOUT)
    took = {}
    threading.Thread(target=lambda: took.setdefault(
        "s", (proc.wait(), time.perf_counter() - t0)[1]), daemon=True).start()
    return proc, err, fq, out, took


def aln_ladder_main(prefix: str, fq: str, out: str) -> int:
    """Subprocess of start_aln_ladder: the device search with each rung's
    lanes and overflows and the fallback counted; writes the .sai and the
    counts."""
    import torch

    from bwa_tpu_torch.aln import batch_search
    from bwa_tpu_torch.ops import gap_machine

    rungs = []
    real = batch_search._run_lanes

    def run_lanes(*a, **k):
        res = real(*a, **k)
        rungs.append(dict(cap=a[7], cap_a=a[8], lanes=len(a[2]),
                          overflow=int(res[2].sum())))
        return res

    batch_search._run_lanes = run_lanes
    fallback = Counter(batch_search, "_host_fallback")
    sai, secs = run_aln(prefix, fq, True)
    Path(out).with_suffix(".sai").write_bytes(sai)
    Path(out).write_text(json.dumps(dict(
        rungs=rungs, fallback_reads=fallback.n, seconds=secs,
        k7_launches=gap_machine.launches,
        k7w_launches=gap_machine.width_launches,
        device=torch.cuda.get_device_name(0))))
    return 0


def wait_aln_ladder(job, prefix):
    """The ladder subprocess's counts, its .sai held to the native search's
    of the same reads."""
    proc, err, fq, out, took = job
    if proc.wait() != 0:
        fail(f"aln_ladder exited {proc.returncode} (see {err.name})")
    while "s" not in took:
        time.sleep(0.01)
    res = json.loads(out.read_text())
    nat, _ = run_aln(prefix, fq, False)
    if out.with_suffix(".sai").read_bytes() != nat:
        fail("aln_ladder: the .sai differs from the native search's")
    if len(res["rungs"]) != 2 or not res["fallback_reads"] \
            or not res["rungs"][1]["overflow"]:
        fail(f"aln_ladder did not drive both rungs and the fallback: {res}")
    res.update(phase="aln_ladder", sai_equal_native=True,
               wall_s=took["s"])
    log(f"aln phase {res}")
    return res


def aln_chunk_main() -> int:
    """One whole `aln` chunk (0x40000 = 262,144 reads of 100 bp, made as
    aln_se_100bp's) through the CLI with the device search and then the
    native one: the .sai files must be equal.  Prints one JSON line: both
    walls, each K7 launch's cap, lanes, event ms and longest lane's steps,
    and the peak of the card's memory that PyTorch's allocator held
    during the device run (allocated and reserved), beside the card's
    name and power limit."""
    import torch

    from bwa_tpu_torch.native.build import get_lib
    from bwa_tpu_torch.ops import cuda_kernels, gap_machine

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    get_lib()
    cuda_kernels.build_all()
    d = REPO / "build" / "smoke"
    d.mkdir(parents=True, exist_ok=True)
    fa, codes = make_genome(d)
    reads, _ = simulate(codes, 0x40000, 100, SEED + 12, 0.02, 0.001, "c")
    fq = d / "aln_chunk.fq"
    write_fastq(fq, reads)
    real, calls = gap_machine.gap_machine, []

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*a, **k)
        e1.record()
        calls.append((k["cap"], int(a[1].shape[0]), e0, e1, out["steps"]))
        return out

    gap_machine.gap_machine = timed
    torch.cuda.reset_peak_memory_stats()
    dev, t_dev = run_aln(str(fa), fq, True)
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    gap_machine.gap_machine = real
    nat, t_nat = run_aln(str(fa), fq, False)
    if dev != nat:
        fail("aln_chunk: the device search's .sai differs from the native "
             "search's")
    print(json.dumps(dict(
        phase="aln_chunk", reads=len(reads), device_s=t_dev, native_s=t_nat,
        sai_equal_native=True, peak_allocated_bytes=peak[0],
        peak_reserved_bytes=peak[1],
        k7_launches=[dict(cap=c, lanes=n, event_ms=e0.elapsed_time(e1),
                          longest_lane_steps=int(st))
                     for c, n, e0, e1, st in calls],
        card=card.strip())), flush=True)
    return 0


# each main-path K7 launch's time without its wrapper's allocations, in
# call order (aln_phase)
K7_ALONE_MS: list = []


def k7_keep(out):
    """What the K7 recorder keeps of a launch: the longest lane's steps and
    the outputs overflow_causes reads."""
    return {k: out[k] for k in ("steps", "ovf", "done_step", "n_aln",
                                "n_stk")}


def k7_bench_main() -> int:
    """K7 and K7w at aln_se_100bp's first launches: `aln` with the device
    search through the CLI, each wrapper's first call recorded, then
    timed alone with CUDA events (a warm launch, then 3 or 5); K7's first
    launch also on its longest lane alone (a lone lane's step latency)
    and with 1,023 and 16,383 other lanes, and both kernels on R = 1 and
    R = 4 occtab rows of the same genome.  Prints one JSON line."""
    import torch

    from bwa_tpu_torch.index.fmindex import DeviceFMIndex, FMIndex
    from bwa_tpu_torch.native.build import get_lib
    from bwa_tpu_torch.ops import cuda_kernels
    from bwa_tpu_torch.ops import gap_machine as gm

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    get_lib()
    cuda_kernels.build_all()
    d = REPO / "build" / "smoke"
    d.mkdir(parents=True, exist_ok=True)
    fa, codes = make_genome(d)
    reads, _ = simulate(codes, 65536, 100, SEED + 10, 0.02, 0.001, "a")
    fq = d / "aln_se_100bp.fq"
    write_fastq(fq, reads)
    recs = {"K7": Recorder(gm, "gap_machine"),
            "K7w": Recorder(gm, "cal_width")}
    run_aln(str(fa), fq, True)
    for r in recs.values():
        r.restore()
    (_, a, k), (_, aw, _) = recs["K7"].calls[0], recs["K7w"].calls[0]
    res = dict(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(),
        occtab_words=int(a[0]["occtab"].shape[1] - 4))
    full = gm.gap_machine(*a, **k)
    top = int(k7_steps(full, k["max_steps"]).argmax())
    longest = int(full["steps"][0])
    for n in (1, 1024, 16384, a[1].shape[0]):
        r = torch.arange(n, device=a[1].device)
        r[-1] = top
        sub = a if n == a[1].shape[0] else \
            [a[0]] + [x[r] for x in a[1:9]] + [a[9]]
        ms = cuda_time(lambda: gm.gap_machine(*sub, **k), 3)
        res[f"k7_{n}_lanes"] = dict(ms=ms, ns_per_step=per_unit(ms, longest))
    fmi = FMIndex.load(str(fa))
    for R in (1, 4):
        t = DeviceFMIndex(fmi, device="cuda", occ_r=R).tree()
        out = gm.gap_machine(t, *a[1:], **k)
        res[f"r{R}"] = dict(
            k7_ms=cuda_time(lambda: gm.gap_machine(t, *a[1:], **k), 3),
            k7w_ms=cuda_time(lambda: gm.cal_width(t, aw[1]), 5),
            k7_equal=all(torch.equal(out[x], full[x]) for x in full))
    print(json.dumps(res), flush=True)
    return 0


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k7_lanes(n, longest, count=256):
    """count lanes spread over a launch of n, and the longest lane."""
    import numpy as np

    return sorted(set(np.linspace(0, n - 1, min(n, count)).astype(int)
                      .tolist()) | {int(longest)})


def k7_steps(out, max_steps):
    """Per-lane steps of a K7 launch (a lane not done ran max_steps)."""
    import torch

    ds = out["done_step"].to(torch.int64)
    return torch.where(ds > 0, ds, torch.full_like(ds, max_steps))


K7_KEYS = ("aln_m", "aln_kl", "n_aln", "n_stk", "ovf", "done_step", "n_occ",
           "n_walk", "steps")


def plain_kw(kw):
    """A recorded K7 call's keywords less the kernel's own (n_lists)."""
    return {k: v for k, v in kw.items() if k != "n_lists"}


def k7_subset(args, kw, count):
    """Recorded K7 call (args, kw) on the card on all its lanes, and on
    count lanes spread over it plus its longest: (full outputs, lanes,
    the subset's arguments, the kernel's outputs on the subset alone)."""
    import torch

    from bwa_tpu_torch.ops import gap_machine as gm

    full = gm.gap_machine(*args, **kw)
    steps = k7_steps(full, kw["max_steps"])
    rows = k7_lanes(steps.numel(), int(steps.argmax()), count)
    r = torch.as_tensor(rows, device=args[1].device)
    sub = [args[0]] + [a[r] for a in args[1:9]] + [args[9]]
    return full, r, sub, gm.gap_machine(*sub, **kw)


def k7_equal(got, want, full, r):
    """Every K7 output of the subset launch equal to the plain version's
    and (per lane) to the full launch's: (equal, max abs difference)."""
    import torch

    equal = all(torch.equal(got[k].cpu(), want[k].cpu()) for k in K7_KEYS) \
        and all(torch.equal(got[k], full[k][r]) for k in K7_KEYS[:-1])
    err = max(int((got[k].cpu().to(torch.int64)
                   - want[k].cpu().to(torch.int64)).abs().max())
              for k in K7_KEYS)
    return equal, err


def start_k7_host_plain(d: Path, rec, i=None, tag="k7_host"):
    """Recorded K7 call i (by default the first launch of the second rung,
    the lanes that overflowed cap 1024, at cap 8192) on 32 of its lanes
    plus its longest, held to the plain version on the host in a
    subprocess that sees no card (it takes as many steps as that lane)
    while the other checks run.  Returns the job for wait_k7_host_plain."""
    import torch

    if i is None:
        i = next((i for i, (_, _, k) in enumerate(rec.calls)
                  if k["cap"] != rec.calls[0][2]["cap"]), None)
    if i is None:
        fail("no K7 launch of the second rung on the main path")
    ph, args, kw = rec.calls[i]
    full, r, sub, got = k7_subset(args, kw, 32)
    idx = {k: (v.cpu() if torch.is_tensor(v) else v)
           for k, v in args[0].items()}
    inp, out = d / f"{tag}.pt", d / f"{tag}_plain.pt"
    torch.save(dict(idx=idx, args=[a.cpu() for a in sub[1:9]],
                    scal=sub[9], kw=plain_kw(kw)), inp)
    err = open(d / f"{tag}.log", "w")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--k7-plain",
         str(inp), str(out)], cwd=REPO, env=env, stdout=err,
        stderr=subprocess.STDOUT)
    took = {}
    threading.Thread(target=lambda: took.setdefault(
        "s", (proc.wait(), time.perf_counter() - t0)[1]), daemon=True).start()
    info = dict(phase=ph, call=i, cap=kw["cap"], cap_a=kw["cap_a"],
                launch_lanes=int(args[1].shape[0]), lanes=len(r),
                longest_lane_steps=int(full["steps"][0]),
                checked_lanes_steps=int(got["steps"][0]))
    return proc, err, out, took, (got, full, r), info


def k7_plain_host(inp: str, out: str) -> int:
    """Subprocess of start_k7_host_plain: the plain version on the host."""
    import torch

    from bwa_tpu_torch.ops import gap_machine as gm

    torch.set_num_threads(1)
    a = torch.load(inp, weights_only=False)
    res = gm.gap_machine_plain(a["idx"], *a["args"], a["scal"], **a["kw"])
    torch.save(res, out)
    return 0


def wait_k7_host_plain(job):
    """The host plain version's outputs held to the kernel's."""
    import torch

    proc, err, out, took, (got, full, r), info = job
    if proc.wait() != 0:
        fail(f"K7 host plain version exited {proc.returncode} (see "
             f"{err.name})")
    while "s" not in took:
        time.sleep(0.01)
    want = torch.load(out)
    equal, e = k7_equal(got, want, full, r)
    info.update(equal=equal, err=e, plain_host_s=took["s"])
    log(f"K7 call {info}")
    if not equal:
        fail(f"K7 disagrees with its plain version: {info}")
    return info


def time_k7(rec, reps=3):
    """K7 at the main path's first launch (aln_se_100bp, the first rung):
    its time over reps launches on all lanes, and 256 lanes plus the
    longest held to the plain version (on the card) with the launch's
    caps and flags, and to the full launch's own outputs on those lanes;
    with the work a bound counts; and every launch's event ms."""
    from bwa_tpu_torch.ops import gap_machine as gm

    ph, args, kw = rec.calls[0]
    full, r, sub, got = k7_subset(args, kw, 256)
    ms = cuda_time(lambda: gm.gap_machine(*args, **kw), reps)
    want, plain_ms = timed_once(
        lambda: gm.gap_machine_plain(*sub, **plain_kw(kw)))
    equal, err = k7_equal(got, want, full, r)
    occ = args[0]["occtab"]
    nw = occ.shape[1] - 4
    lane_steps = int(k7_steps(full, kw["max_steps"]).sum())
    occ_pairs = int(full["n_occ"].sum())
    walks = int(full["n_walk"].sum())
    longest = int(full["steps"][0])
    # each input read once (the occtab whole) and each output written
    # once; a step pops and tests an entry (about 40 integer ops); an
    # expansion step (n_occ - n_walk) also needs every base's count at both
    # ends, bwt_2occ4 (the four counts of a word from the hi and lo bit
    # planes: mask, shift, two ands, three popcounts, three adds, about 12
    # ops a text word over nw/2 + 1 words each), a walk step (n_walk) one
    # base's, bwt_2occ in bwt_match_exact_alt (5 ops a word); either then
    # pushes or walks (about 80 more)
    nbytes = tensor_bytes(occ, *args[1:9], *full.values())
    ops = lane_steps * 40 + (occ_pairs - walks) * (2 * 12 * (nw / 2 + 1)
                                                   + 80) \
        + walks * (2 * 5 * (nw / 2 + 1) + 80)
    res = dict(phase=ph, ms=ms, plain_ms=plain_ms, equal=bool(equal),
               err=err, shape=f"B={args[1].shape[0]} L={args[1].shape[1]} "
                              f"cap={kw['cap']} cap_a={kw['cap_a']}",
               plain_shape=f"{len(r)} of the launch's lanes",
               lane_steps=lane_steps, occ_pair_steps=occ_pairs,
               walk_steps=walks, longest_lane_steps=longest,
               checked_lanes_steps=int(got["steps"][0]),
               ns_per_step=per_unit(ms, longest), bytes=int(nbytes),
               ops=float(ops),
               overflow_lanes=int(full["ovf"].sum()))
    launches = []
    for i, (ph_i, a, k) in enumerate(rec.calls):
        ms_i, top = rec.call_ms[i], int(rec.kept[i]["steps"])
        alone = K7_ALONE_MS[i]
        launches.append(dict(
            phase=ph_i, call=i, cap=k["cap"], cap_a=k["cap_a"],
            lanes=int(a[1].shape[0]), event_ms=ms_i, kernel_only_ms=alone,
            longest_lane_steps=top, ns_per_step=per_unit(alone, top),
            overflow=gm.overflow_causes(rec.kept[i], k["cap"], k["cap_a"])))
        log(f"K7 launch {launches[-1]}")
    res["launches_on_main_path"] = launches
    log(f"K7 timed {res}")
    if not equal:
        fail(f"K7 disagrees with its plain version: {res['shape']}")
    return res


K7_DESIGN = (
    "redesigned for Hopper: a group of 2R threads a lane (2 on the "
    "R = 1 occtab the aln path passes), one cooperative occ4 pair a step "
    "whatever its phase, its loads issued together with those of the codes "
    "and width tables; the next pop (the exact-match child) in registers, "
    "a register bitmap of the non-empty score lists, list heads and 16 "
    "freed slots in shared memory, further freed slots in chunks of 7 in "
    "the pool, 32-byte packed records; a persistent grid taking lanes from "
    "a counter; a wide-record variant for fields past the packed widths")
K7W_DESIGN = (
    "redesigned for Hopper: a group of 2R threads a read (2 on the "
    "R = 1 occtab the aln path passes), one cooperative occ4 pair a base "
    "(half the group counts B[0..k-1], half B[0..l], every load issued "
    "together, packed 10-bit sums by shuffles), the next code loaded a "
    "step ahead")


def time_k7w(rec, reps=5):
    """K7w: every recorded launch on 256 of its lanes plus its last held
    to the plain version; the first launch timed on all its lanes."""
    import torch

    from bwa_tpu_torch.ops import gap_machine as gm

    checked, err = [], 0
    for i, (ph, args, kw) in enumerate(rec.calls):
        idx, q = args
        r = torch.as_tensor(k7_lanes(q.shape[0], q.shape[0] - 1),
                            device=q.device)
        got = gm.cal_width(idx, q[r])
        want = gm.cal_width_plain(idx, q[r])
        ok = torch.equal(got, want)
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64))
                           .abs().max()))
        checked.append(dict(phase=ph, call=i, lanes=len(r), equal=ok,
                            event_ms=rec.call_ms[i]))
        if not ok:
            fail(f"K7w disagrees with its plain version at call {i}")
    _, args, _ = rec.calls[0]
    idx, q = args
    ms = cuda_time(lambda: gm.cal_width(idx, q), reps)
    _, plain_ms = timed_once(lambda: gm.cal_width_plain(idx, q))
    occ = idx["occtab"]
    nw = occ.shape[1] - 4
    pos = q.numel()
    good = int((q < 4).sum())
    # the occtab, the codes and the table, each once; a position: about
    # 12 ops, and a base (code < 4; padding and N reset the interval) the
    # count of that one base at k - 1 and at l as well, bwt_2occ (5 ops a
    # text word over nw/2 + 1 words each)
    nbytes = tensor_bytes(occ, q) + pos * 2 * \
        (8 if idx["cdt"] == torch.int64 else 4)
    ops = pos * 12 + good * 2 * 5 * (nw / 2 + 1)
    res = dict(ms=ms, plain_ms=plain_ms, equal=True, err=err,
               shape=f"B={q.shape[0]} L={q.shape[1]}", bytes=int(nbytes),
               ops=float(ops), occ_pair_positions=good, calls=checked)
    log(f"K7w timed {res}")
    return res


# --------------------------------------------------------------------------
# each recorded call against the plain version
# --------------------------------------------------------------------------

def cuda_time(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed_once(fn):
    """One call bracketed by CUDA events: (result, ms)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def busy_time(fn, reps):
    """CUDA-event ms a call with the card kept busy ahead of the host (an
    idle kernel of about 0.1 s queued first), so that the host's time
    between calls is hidden: the device time of the call's kernels,
    its small torch ops' included."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def k1_outputs(out):
    """seeds after sort_seeds, seed_n, ovf, done_step and steps (the
    longest lane's), on the host."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    return [t.cpu() for t in (fmm.sort_seeds(out[0], out[1], False), out[1],
                              out[3], out[4].to(torch.int32))] \
        + [torch.tensor([int(out[2])], dtype=torch.int32)]


def k1_lanes(q, qlen, longest: bool):
    """Lanes of a recorded K1 call to hold to the plain version: every lane
    of one read less than half as long as the longest, one empty lane, and
    with `longest` every lane of the longest read (lanes of one read share
    their codes and length).  When every live lane has one length (150 bp
    reads packed two a lane), that rule finds no short read, so 128 lanes
    spread evenly over the call are held as well."""
    import torch

    ql = qlen.to(torch.int64)

    def lanes_of(lane):
        return set(((q == q[lane]).all(1) & (ql == ql[lane])).nonzero()
                   .flatten().tolist())

    top = int(ql.argmax())
    sel = lanes_of(top) if longest else set()
    short = ((ql > 0) & (ql * 2 < ql[top])).nonzero().flatten()
    if short.numel():
        sel |= lanes_of(int(short[0]))
    empty = (ql == 0).nonzero().flatten()
    if empty.numel():
        sel.add(int(empty[0]))
    live = (ql > 0).nonzero().flatten()
    if live.numel() and bool((ql[live] == ql[top]).all()):
        sel |= set(live[::max(1, live.numel() // 128)][:128].tolist())
    if not sel:
        sel = lanes_of(top)
    return sorted(sel)


def k1_subset(args, kw, longest):
    """K1 on a subset of a recorded call's lanes, on the card, against the
    plain version of the same lanes on the host."""
    import numpy as np
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    idx, q, qlen, nv = args[:4]
    rows = k1_lanes(q, qlen, longest)
    r = torch.as_tensor(rows, device=q.device)
    a = [idx, q[r], qlen[r], nv[r], *args[4:]]
    k = dict(kw)
    if k.get("shard") is not None:
        k["shard"] = tuple(np.asarray(x)[rows] for x in k["shard"])
    got = k1_outputs(fmm.seed_machine(*a, **k))
    host = [{kk: (v.cpu() if torch.is_tensor(v) else v)
             for kk, v in idx.items()}] + [t.cpu() for t in a[1:4]] + a[4:]
    t0 = time.perf_counter()
    want = k1_outputs(fmm.seed_machine_plain(*host, **k))
    return got, want, dict(lanes=len(rows), cap=kw["cap"],
                           cap_s=kw["cap_s"], width=int(q.shape[1]),
                           plain_host_s=time.perf_counter() - t0)


def k2_subset(args, kw):
    """K2 on a subset of a recorded call's jobs (32 live ones spread over
    the call, longest first, and one empty one) against the plain version
    on the host, or on the card for a band wider than 1024 slots (the
    host's plain version at P >= 2304 over 10 kb targets takes tens of
    seconds a call)."""
    import torch

    from bwa_tpu_torch.ops import ksw_band

    tlen = args[8]
    live = (tlen > 0).nonzero().flatten()
    rows = set(live[::max(1, live.numel() // 32)][:32].tolist())
    dead = (tlen == 0).nonzero().flatten()
    if dead.numel():
        rows.add(int(dead[0]))
    rows = sorted(rows)
    r = torch.as_tensor(rows, device=tlen.device)
    a = list(args[:3]) + [x[r] for x in args[3:11]] + list(args[11:])
    got = ksw_band.ksw_band_side(*a, **kw).cpu()
    P = kw.get("P", args[-1])
    host = a if P > 1024 else [x.cpu() if torch.is_tensor(x) else x
                               for x in a]
    t0 = time.perf_counter()
    want = ksw_band.ksw_band_side_plain(*host, **kw).cpu()
    return got, want, dict(jobs=len(rows), P=P, max_tlen=int(tlen[r].max()),
                           plain_on="card" if P > 1024 else "host",
                           plain_s=time.perf_counter() - t0)


def check_calls(rec, kernel, skip=(0,)):
    """Every recorded call but those in skip, on a subset of its rows; the
    skipped calls are held on all their rows by time_k1/time_k2."""
    import torch

    res = []
    phases = [ph for ph, _, _ in rec.calls]
    for i, (ph, args, kw) in enumerate(rec.calls):
        if i in skip:
            continue
        if kernel == "K1":
            last = i == len(phases) - 1 or phases[i + 1] != ph
            got, want, info = k1_subset(args, kw, longest=last)
        else:
            got, want, info = k2_subset(args, kw)
            got, want = [got], [want]
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        info = dict(phase=ph, call=i, equal=ok, **info)
        log(f"{kernel} call {info}")
        if not ok:
            fail(f"{kernel} disagrees with its plain version on {info}")
        res.append(info)
    return res


def k1_lane_wide(rec, phase="mem_pacbio") -> int:
    """Index of a pacbio phase's K1 launch at the lane-wide rung (a seed
    cap past the ladder's 256 per read)."""
    pb = [i for i, (ph, _, kw) in enumerate(rec.calls)
          if ph == phase and kw["cap_s"] > 256]
    if not pb:
        fail(f"{phase}: K1 was not launched at the lane-wide rung")
    return max(pb, key=lambda i: rec.calls[i][2]["cap_s"])


def start_k1_host_plain(d: Path, rec, i, tag="k1_host"):
    """The plain version of recorded K1 call i on all its lanes, on the
    host, in two subprocesses that see no card: the lanes of the longest
    reads (at least half as long as the longest lane) and the rest, since a
    plain run takes as many steps as its longest lane.  Returns the jobs
    for wait_k1_host_plain."""
    import numpy as np
    import torch

    _, args, kw = rec.calls[i]
    idx = {k: (v.cpu() if torch.is_tensor(v) else v)
           for k, v in args[0].items()}
    q, qlen, nv = (t.cpu() for t in args[1:4])
    ql = qlen.to(torch.int64)
    longest = ql * 2 > ql.max()
    jobs = []
    for g, lanes in enumerate((longest.nonzero().flatten(),
                               (~longest).nonzero().flatten())):
        if not lanes.numel():
            continue
        k = dict(kw)
        if k.get("shard") is not None:
            k["shard"] = tuple(np.asarray(x)[lanes.numpy()]
                               for x in k["shard"])
        inp, out = d / f"{tag}_{g}.pt", d / f"{tag}_{g}_plain.pt"
        torch.save(dict(idx=idx, q=q[lanes], qlen=qlen[lanes], nv=nv[lanes],
                        consts=list(args[4:8]), kw=k), inp)
        err = open(d / f"{tag}_{g}.log", "w")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--k1-plain",
             str(inp), str(out)], cwd=REPO, env=env, stdout=err,
            stderr=subprocess.STDOUT)
        took = {}
        threading.Thread(target=lambda p=proc, t=took, t0=t0: t.setdefault(
            "s", (p.wait(), time.perf_counter() - t0)[1]), daemon=True).start()
        jobs.append((proc, err, out, lanes, took))
    return jobs


def k1_plain_host(inp: str, out: str) -> int:
    """Subprocess of start_k1_host_plain: the plain version on the host."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    torch.set_num_threads(1)
    a = torch.load(inp, weights_only=False)
    res = fmm.seed_machine_plain(a["idx"], a["q"], a["qlen"], a["nv"],
                                 *a["consts"], **a["kw"])
    torch.save(k1_outputs(res), out)
    return 0


def wait_k1_host_plain(jobs, like):
    """The host plain version's outputs of all lanes, assembled in lane
    order in tensors shaped like the kernel's (like = k1_outputs of the
    kernel), and the longest subprocess's seconds."""
    import torch

    want = [torch.zeros_like(t) for t in like]
    secs = 0.0
    for proc, err, out, lanes, took in jobs:
        if proc.wait() != 0:
            fail(f"K1 host plain version exited {proc.returncode} (see "
                 f"{err.name})")
        while "s" not in took:
            time.sleep(0.01)
        secs = max(secs, took["s"])
        part = torch.load(out)
        for t, p in zip(want[:4], part[:4]):
            t[lanes] = p
        want[4] = torch.maximum(want[4], part[4])
    return want, secs


def time_k1_call(rec, i, reps, host=None):
    """Recorded K1 call i on all its lanes: the kernel against its plain
    version (all five outputs; on the card on the same device tensors, or
    from the host jobs of start_k1_host_plain), the kernel's time over reps
    launches, and the work a bound counts from the plain version's step
    counts."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    ph, args, kw = rec.calls[i]
    idx, q = args[0], args[1]
    out = fmm.seed_machine(*args, **kw)
    got = k1_outputs(out)
    ms = cuda_time(lambda: fmm.seed_machine(*args, **kw), reps)
    # what clearing the seed store in the wrapper would cost instead of
    # the kernel's zeroing of the slots no push reached
    zero_ms = cuda_time(lambda: torch.zeros_like(out[0]), reps)
    if host is None:
        plain, plain_ms = timed_once(
            lambda: fmm.seed_machine_plain(*args, **kw))
        want, plain_host_s = k1_outputs(plain), None
    else:
        (want, plain_host_s), plain_ms = wait_k1_host_plain(host, got), None
    equal, err = k1_equal(got, want)
    longest = int(want[4][0])
    nbytes, ops, steps = k1_work(args, out[0], want[3])
    res = dict(phase=ph, call=i, ms=ms, plain_ms=plain_ms,
               plain_host_s=plain_host_s, equal=bool(equal), err=err,
               shape=f"B={q.shape[0]} L={q.shape[1]} cap={kw['cap']} "
                     f"cap_s={kw['cap_s']}",
               lane_steps=steps, longest_lane_steps=longest,
               ns_per_step=per_unit(ms, longest),
               zero_seed_store_ms=zero_ms, bytes=int(nbytes), ops=float(ops))
    res["bound_ms"], res["bound_by"] = bound(nbytes, ops)
    log(f"K1 timed {res}")
    return res


def k1_equal(got, want):
    """(all five outputs equal, largest absolute difference)."""
    import torch

    pairs = list(zip(got, want))
    return (all(torch.equal(x, y) for x, y in pairs),
            max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                for x, y in pairs))


def k1_work(args, seeds, done_step):
    """(bytes, integer ops, lane steps) a bound counts for a K1 call: each
    input and output once; per lane step (done_step: each lane's steps, as
    this run's data took them) what the step's function needs: it extends
    one entry by one base (bwt_extend's count of that base and of the bases
    above it, at both ends: two masks at 5 integer ops a mask and text
    word, xor, shift, and, popcount, add, over nw/2 + 1 words on average,
    as refill_work counts the refill mode's step), plus ~64 ops of state
    update."""
    import torch

    idx, q, nv = args[0], args[1], args[3]
    occ = idx["occtab"]
    nw = occ.shape[1] - 4
    steps = int(done_step.to(torch.int64).sum())
    nbytes = (occ.numel() * 4 + q.numel() + nv.numel() * 4
              + q.shape[0] * 4 * 4 + seeds.numel() * seeds.element_size()
              + q.shape[0] * 9)
    return nbytes, steps * (2 * 2 * 5 * (nw / 2 + 1) + 64), steps


def k1_first_launch(rec, phase, count=256):
    """The phase's first K1 launch: the kernel on all its lanes, timed over
    5 launches, and held to the plain version on the card on `count` lanes
    spread over the launch plus its longest lane (the most steps); the
    bound counts the whole launch's lane steps."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    i = next(j for j, (ph, _, _) in enumerate(rec.calls) if ph == phase)
    _, args, kw = rec.calls[i]
    idx, q, qlen, nv = args[:4]
    out = fmm.seed_machine(*args, **kw)
    ms = cuda_time(lambda: fmm.seed_machine(*args, **kw), 5)
    live = (qlen > 0).nonzero().flatten()
    rows = set(live[::max(1, live.numel() // count)][:count].tolist())
    rows.add(int(out[4].argmax()))
    r = torch.as_tensor(sorted(rows), device=q.device)
    a = [idx, q[r], qlen[r], nv[r], *args[4:]]
    got = k1_outputs(fmm.seed_machine(*a, **kw))
    plain, plain_ms = timed_once(lambda: fmm.seed_machine_plain(*a, **kw))
    equal, err = k1_equal(got, k1_outputs(plain))
    nbytes, ops, steps = k1_work(args, out[0], out[4])
    longest = int(out[4].max())
    res = dict(phase=phase, call=i, ms=ms, plain_ms_checked_lanes=plain_ms,
               equal=equal, err=err, lanes_checked=len(rows),
               shape=f"B={q.shape[0]} L={q.shape[1]} cap={kw['cap']} "
                     f"cap_s={kw['cap_s']}",
               lane_steps=steps, longest_lane_steps=longest,
               ns_per_step=per_unit(ms, longest), bytes=int(nbytes),
               ops=float(ops))
    res["bound_ms"], res["bound_by"] = bound(nbytes, ops)
    log(f"K1 first launch {res}")
    if not equal:
        fail(f"K1 disagrees with its plain version at {phase}'s first "
             f"launch")
    return res


def aligner_seqs(reads):
    import numpy as np

    return [np.frombuffer(b"ACGTN", np.uint8)[r].tobytes() for _, r in reads]


def aligner_phase(prefix, reads, recs):
    """A dozen reads through the library's Aligner on the card (its default
    device): the phase's numbers and each read's hits."""
    from bwa_tpu_torch.api import Aligner

    seqs = aligner_seqs(reads)
    for r in recs.values():
        r.events = []
        r.phase = "api_aligner"
    zero_launches()
    t0 = time.perf_counter()
    card = Aligner(prefix)
    got = [[vars(h) for h in card.align(s)] for s in seqs]
    dt = time.perf_counter() - t0
    launches = read_launches()
    kernel_ms = {k: r.take_ms() for k, r in recs.items()}
    return dict(phase="api_aligner", reads=len(reads), seconds=dt,
                reads_per_s=len(reads) / dt, launches=launches,
                kernel_event_ms=kernel_ms), got


def check_aligner(prefix, reads, info, got):
    """The card Aligner's hits against Aligner(device="cpu")'s, the plain
    versions on the host (no recorder in place)."""
    from bwa_tpu_torch.api import Aligner

    host = Aligner(prefix, device="cpu")
    for (name, _), s, g in zip(reads, aligner_seqs(reads), got):
        want = [vars(h) for h in host.align(s)]
        if g != want:
            fail(f"api_aligner: read {name}: hits on the card {g} differ "
                 f"from Aligner(device='cpu')'s {want}")
    if sum(bool(g) for g in got) < 0.9 * len(reads):
        fail("api_aligner: fewer than 90% of the reads have a hit")
    info["hits_equal_cpu"] = True


def python_and_fastmap_phases(d, prefix, fm, reads150, sam_se, pb5_reads,
                              pe, pe_sam, cpu5):
    """The Python mem route (SE -5, BWA_TPU_FINALIZE=python SE and PE, -x
    pacbio -5) and fastmap through the CLI on the card, and the library's
    Aligner, K1's calls recorded apart from the earlier phases'; their
    checks; K1's first launch of the -5 and fastmap phases against the
    plain version.  The pacbio -5 phase's SAM is returned for the check
    of its first 8 reads against a CPU run."""
    import numpy as np

    from bwa_tpu_torch.mem import batch_seed, fastmap
    from bwa_tpu_torch.ops import fm_machine
    from bwa_tpu_torch.ops.fm_host import HostFM

    t0 = time.perf_counter()
    recs = {"K1": Recorder(fm_machine, "seed_machine",
                           keep=lambda out: out[2])}
    host_spec = Counter(batch_seed, "host_reseed")
    per_read = Counter(fastmap, "fastmap_lines")
    try:
        p5, sam5 = main_path(d, prefix, "mem_se_150bp_primary5", reads150,
                             ["-5"], recs, host_spec=host_spec)
        with finalize_python():
            py, sam_py = main_path(d, prefix, "mem_se_150bp_python",
                                   reads150, [], recs, host_spec=host_spec)
            pepy, sam_pepy = main_path(d, prefix, "mem_pe_python",
                                       pe[0][:256], [], recs, pe[1][:256],
                                       host_spec=host_spec)
        pb5, sam_pb5 = main_path(d, prefix, "mem_pacbio_primary5",
                                 pb5_reads, ["-x", "pacbio", "-5"], recs,
                                 host_spec=host_spec)
        n_pr = per_read.n
        fm5, out_fm = main_path(d, prefix, "fastmap_150bp", reads150, [],
                                recs, cmd="fastmap")
        fm5["per_read_route_reads"] = per_read.n - n_pr
        api, hits = aligner_phase(prefix, reads150[:12], recs)
    finally:
        for r in (recs["K1"], host_spec, per_read):
            r.restore()
    check_aligner(prefix, reads150[:12], api, hits)
    for ph in (p5, py, pepy, pb5, fm5, api):
        if ph["launches"]["K1"] < 1:
            fail(f"{ph['phase']}: kernel K1 was not launched")
    for ph, a, b, what in (
            (py, sam_py, sam_se, "mem_se_150bp's C++-route SAM"),
            (pepy, sam_pepy, pe_sam, "mem_pe_first256's C++-route SAM")):
        diff = records_differ(a, b)
        if diff:
            fail(f"{ph['phase']}: SAM differs from {what}: {diff}")
        ph["equal_cpp_route"] = True
    # fastmap's first 64 reads against the host spec, read by read
    blocks = out_fm.split("//\n")
    host = HostFM(fm)
    want = "".join("\n".join(fastmap.fastmap_lines(
        fm, host, n, np.frombuffer(b"ACGTN", np.uint8)[r].tobytes())) + "\n"
        for n, r in reads150[:64])
    if "//\n".join(blocks[:64]) + "//\n" != want:
        fail("fastmap_150bp: the first 64 reads' output differs from "
             "fastmap_lines through HostFM")
    fm5["first64_equal_host_spec"] = True
    main_s = time.perf_counter() - t0
    first = {ph: k1_first_launch(recs["K1"], ph)
             for ph in ("mem_se_150bp_primary5", "fastmap_150bp")}
    log(f"Python mem route and fastmap: {main_s:.1f} s, their K1 checks "
        f"{time.perf_counter() - t0 - main_s:.1f} s more")
    check_first64(p5, sam5, cpu5, {n for n, _ in reads150[:64]})
    for ph in (py, pepy, fm5, api):
        print(json.dumps(ph), flush=True)
    return [p5, py, pepy, pb5, fm5, api], first, recs["K1"], \
        time.perf_counter() - t0, sam_pb5


def time_k1(rec, host):
    """K1 at the main path's first launch (150 bp SE), against the plain
    version on the card, and at the pacbio phase's lane-wide rung, against
    the host jobs' plain version, each on all its lanes; and every
    main-path launch's event time with its longest lane's steps."""
    se = time_k1_call(rec, 0, 5)
    pb = time_k1_call(rec, k1_lane_wide(rec), 5, host)
    launches = []
    for i, (ph, _, kw) in enumerate(rec.calls):
        ms, longest = rec.call_ms[i], int(rec.kept[i])
        launches.append(dict(phase=ph, call=i, cap=kw["cap"],
                             cap_s=kw["cap_s"], event_ms=ms,
                             longest_lane_steps=longest,
                             ns_per_step=per_unit(ms, longest)))
        log(f"K1 launch {launches[-1]}")
    return dict(se, pacbio_lane_wide=pb, launches_on_main_path=launches,
                equal=se["equal"] and pb["equal"], err=max(se["err"],
                                                           pb["err"]))


def k2_longest(out):
    """Rows swept by a K2 call's longest problem (a device tensor)."""
    return out[:, 6].max() if out.numel() else out.new_zeros(())


def time_k2(rec, i=0):
    """K2 at recorded call i (the main path's first launch by default) on
    all its jobs, against the plain version on the card, with the work a
    bound counts; and every main-path launch's event time with its P, n,
    the longest problem's rows and ns a row."""
    import torch

    from bwa_tpu_torch.ops import ksw_band

    _, args, kw = rec.calls[i]
    out = ksw_band.ksw_band_side(*args, **kw)
    plain, plain_ms = timed_once(
        lambda: ksw_band.ksw_band_side_plain(*args, **kw))
    equal = bool(torch.equal(out, plain))
    err = int((out.to(torch.int64) - plain.to(torch.int64)).abs().max())
    ms = cuda_time(lambda: ksw_band.ksw_band_side(*args, **kw), 5)
    pac, qflat, w = args[0], args[2], args[9]
    n = args[3].shape[0]
    rows = out[:, 6].to(torch.int64)
    longest = int(rows.max())
    cells = band_cells(rows, w, args[5])
    nbytes = pac.numel() + qflat.numel() + n * (8 * 2 + 4 * 6) + n * 7 * 4
    launches = []
    for j, (ph, a, k) in enumerate(rec.calls):
        ms_j, top = rec.call_ms[j], int(rec.kept[j])
        launches.append(dict(phase=ph, call=j, P=k.get("P", a[-1]),
                             n=int(a[3].shape[0]), event_ms=ms_j,
                             longest_rows=top,
                             ns_per_row=per_unit(ms_j, top)))
        log(f"K2 launch {launches[-1]}")
    return dict(ms=ms, plain_ms=plain_ms, equal=equal, err=err,
                shape=f"n={n} P={kw.get('P', args[-1])} "
                      f"max_tlen={int(args[8].max())}",
                rows=int(rows.sum()), cells=cells, bytes=int(nbytes),
                ops=float(cells * 20), longest_rows=longest,
                ns_per_row=per_unit(ms, longest),
                launches_on_main_path=launches)


# --------------------------------------------------------------------------
# 4d. trip-sorted packing (K8), K1's refill mode, main_mem's threads
# --------------------------------------------------------------------------

@contextlib.contextmanager
def env_set(**kv):
    """The environment variables kv set for the calls made inside."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def same_sam(name, a, b, what):
    diff = records_differ(a, b)
    if diff or records_of(a) != records_of(b):
        fail(f"{name}: SAM differs from {what}: {diff}")


def k1_steps(rec, phase):
    """Each K1 launch of a phase: its lanes and longest lane's steps."""
    return [dict(call=i, lanes=int(a[1].shape[0]),
                 longest_lane_steps=int(rec.kept[i]),
                 event_ms=rec.call_ms.get(i))
            for i, (ph, a, _) in enumerate(rec.calls) if ph == phase]


def k8_ends(idx, q):
    """The counts K8's function needs on the rows q, from the intervals as
    the plain version forms them: (positions that extend an interval of
    two rows or more, which count one base at both ends; positions that
    extend a one-row interval, which count it at k1's end and read the one
    code at k2; breaks)."""
    import torch

    from bwa_tpu_torch.ops import fm as fm_ops

    B, L = q.shape
    i64 = torch.int64
    L2 = idx["L2"].to(i64)
    x1 = torch.ones(B, dtype=i64, device=q.device)
    x2 = torch.zeros(B, dtype=i64, device=q.device)
    started = torch.zeros(B, dtype=torch.bool, device=q.device)
    bidx = torch.arange(B, device=q.device)
    two = one = breaks = 0
    for x in range(L):
        c = q[:, x].to(i64)
        good = c < 4
        ext = started & good
        one += int((ext & (x2 == 1)).sum())
        two += int((ext & (x2 != 1)).sum())
        cf = (3 - c).clamp(0, 3)
        o1 = fm_ops._occ4(idx, x1 - 1).to(i64)[bidx, cf]
        sz = fm_ops._occ4(idx, x1 - 1 + x2).to(i64)[bidx, cf] - o1
        ok = ext & (sz >= 1)
        breaks += int((ext & (sz < 1)).sum())
        _, s1, s2 = (v.to(i64) for v in fm_ops._set_intv(idx, c))
        restart = good & ~ok
        x1 = torch.where(ok, L2[cf] + 1 + o1, torch.where(restart, s1, x1))
        x2 = torch.where(ok, sz, torch.where(restart, s2, x2))
        started = good
    return two, one, breaks


def check_k8(rec, phase="mem_se_tripsort"):
    """K8's main-path launch in `phase` (all rows) against the plain
    version on the card, its time over 5 launches, and its bound: the
    codes, the occtab and the counts once; one base's count (5 integer ops
    a text word: the pattern's xor, a shift, the and of the two bit
    planes, a popcount, an add; nw / 2 + 1 words on average) at both ends
    where the position extends an interval of two rows or more, at k1's
    end alone where it extends a one-row interval (k8_ends), 16 ops at
    every position; on an int32 tree also the int64 instantiation on the
    same rows, held and timed."""
    import torch

    from bwa_tpu_torch.ops import fm as fm_ops

    i = next(j for j, (ph, _, _) in enumerate(rec.calls) if ph == phase)
    idx, q, qlen = rec.calls[i][1]
    got = fm_ops.probe_breaks(idx, q, qlen)
    want, plain_ms = timed_once(lambda: fm_ops.probe_breaks_plain(idx, q))
    err = int((got.long() - want.long()).abs().max())
    ms = cuda_time(lambda: fm_ops.probe_breaks(idx, q, qlen), 5)
    occ = idx["occtab"]
    nw = occ.shape[1] - 4
    two, one, brk = k8_ends(idx, q)
    if brk != int(want.sum()):
        fail(f"k8_ends counts {brk} breaks, the plain version "
             f"{int(want.sum())}")
    nbytes = q.numel() + occ.numel() * 4 + q.shape[0] * 4
    ops = (2 * two + one) * 5 * (nw / 2 + 1) + q.numel() * 16
    res = dict(phase=phase, call=i, ms=ms, plain_ms=plain_ms,
               event_ms=rec.call_ms.get(i), equal=err == 0, err=err,
               rows=int(q.shape[0]), shape=f"B={q.shape[0]} L={q.shape[1]}",
               extending_positions=two + one, one_row_extensions=one,
               breaks=int(want.sum()), bytes=int(nbytes), ops=float(ops))
    res["bound_ms"], res["bound_by"] = bound(nbytes, ops)
    if idx["cdt"] == torch.int32:  # the int64 instantiation, same rows
        t64 = coord_tree(idx, "int64")
        got64 = fm_ops.probe_breaks(t64, q, qlen)
        want64, plain64 = timed_once(
            lambda: fm_ops.probe_breaks_plain(t64, q))
        err64 = int((got64.long() - want64.long()).abs().max())
        res["int64"] = dict(ms=cuda_time(
            lambda: fm_ops.probe_breaks(t64, q, qlen), 5), plain_ms=plain64,
            equal=err64 == 0, err=err64)
        res["err"] = max(err, err64)
        res["equal"] = res["err"] == 0
    log(f"K8 {res}")
    if res["err"]:
        fail(f"K8 disagrees with its plain version on {phase}'s rows")
    return res


def refill_rows(out):
    """Each read's seed rows of a refill launch, the way _demux_refill
    orders them (sort_seeds in each lane, then a stable sort by (read,
    start, end)), and the reads whose rows depend on the lane that drew
    them: those seeded in a lane that overflowed its seed store or
    stack."""
    import numpy as np

    from bwa_tpu_torch.ops import fm_machine as fmm

    s = fmm.sort_seeds(out[0], out[1], False).cpu().numpy()
    sn = out[1].cpu().numpy().astype(np.int64)
    live = np.arange(s.shape[1])[None, :] < sn[:, None]
    bad = (sn > s.shape[1]) | out[3].cpu().numpy().astype(bool)
    rows = s[live]
    return (rows[np.lexsort((rows[:, 4], rows[:, 3], rows[:, 5]))],
            np.unique(s[bad][live[bad]][:, 5]))


def refill_equal(got, want, n):
    """Two runs of K1's refill mode on one table of n reads, whichever
    lane drew which read: the rows of every read that both drew (the
    cursor hands reads out in order, so the first min(drawn) reads) and
    that neither seeded in an overflowing lane, equal.  Returns (equal,
    max abs err, rows compared, reads left out, (drawn, drawn))."""
    import numpy as np

    drawn = (min(int(got[5]), n), min(int(want[5]), n))
    (g, gbad), (w, wbad) = refill_rows(got), refill_rows(want)
    skip = np.union1d(gbad, wbad)

    def kept(r):
        return r[(r[:, 5] < min(drawn)) & ~np.isin(r[:, 5], skip)]

    g, w = kept(g).astype(np.int64), kept(w).astype(np.int64)
    same = g.shape == w.shape
    equal = same and bool((g == w).all()) and g.shape[0] > 0
    err = int(abs(g - w).max()) if same and g.size else (0 if equal else -1)
    return equal, err, int(g.shape[0]), int(skip.size), drawn


def refill_checked(c, got, want, got64):
    """A main-path refill launch's check, at int32 (got) and int64 (got64;
    the same coordinates on a tree below 2^31) against one plain run: each
    read's rows equal, and every read drawn."""
    n = c["reads"]
    for key, out in (("", got), ("int64_", got64)):
        equal, err, rows, left_out, drawn = refill_equal(out, want, n)
        c.update({f"{key}equal": equal, f"{key}err": err,
                  f"{key}rows_checked": rows,
                  f"{key}reads_left_out": left_out, f"{key}drawn": drawn})
        if not equal or drawn != (n, n):
            log(f"K1 refill check {c}")
            fail(f"K1's refill mode {'at int64 ' if key else ''}in its "
                 f"{c['form']} form disagrees with its plain version at "
                 f"{c['phase']}'s launch {c['call']}, or left reads undrawn "
                 f"(reads drawn {drawn} of {n})")
    c["err"] = max(c["err"], c["int64_err"])
    log(f"K1 refill check {c}")


def start_refill_host_plain(d: Path, i, args, kw):
    """The plain version of recorded refill launch i on the host, in a
    subprocess that sees no card; returns the job for finish_refill."""
    import torch

    idx = {k: (v.cpu() if torch.is_tensor(v) else v)
           for k, v in args[0].items()}
    inp, out = d / f"refill_host_{i}.pt", d / f"refill_host_{i}_plain.pt"
    torch.save(dict(args=[idx, args[1].cpu(), *args[2:]], kw=kw), inp)
    err = open(d / f"refill_host_{i}.log", "w")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--refill-plain",
         str(inp), str(out)], cwd=REPO, env=env, stdout=err,
        stderr=subprocess.STDOUT)
    return proc, err, out, t0


def refill_plain_host(inp: str, out: str) -> int:
    """Subprocess of start_refill_host_plain: the plain version on the
    host."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    torch.set_num_threads(1)
    a = torch.load(inp, weights_only=False)
    res = fmm.seed_machine_refill_plain(*a["args"], **a["kw"])
    torch.save([torch.as_tensor(x) for x in res], out)
    return 0


def finish_refill(rows, pending):
    """Wait for the main-path refill launches held on the host and check
    them (refill_checked); their host seconds go to plain_host_s, and a
    form's row whose first launch was held there takes them as its
    plain_ms."""
    import torch

    for c, (proc, err, out, t0), got, got64 in pending:
        if proc.wait() != 0:
            fail(f"the refill host plain version exited {proc.returncode} "
                 f"(see {err.name})")
        err.close()
        c["plain_host_s"] = time.perf_counter() - t0
        want = torch.load(out)
        refill_checked(c, got, (*want[:2], int(want[2]), *want[3:]), got64)
    for row in rows.values():
        if row["plain_ms"] is None:
            row["plain_ms"] = row["main_path_checks"][0]["plain_host_s"] * 1e3
            row["plain_shape"] = (
                f"this launch's plain version on the host CPU, one thread, "
                f"beside the run; {row['plain_shape']}")
        row["err"] = max(c["err"] for c in row["main_path_checks"])


def refill_work(idx, table, out):
    """(bytes, integer ops, lane steps) a refill launch's bound counts: the
    occtab, the table and the outputs once; per lane step (its lanes'
    done_step, as this run's data took them) a lookup at both ends that
    counts two masks, base c and the bases above it (5 integer ops a
    mask and text word, nw / 2 + 1 words on average), and ~64 ops of
    state update."""
    import torch

    nw = idx["occtab"].shape[1] - 4
    steps = int(out[4].to(torch.int64).sum())
    nbytes = (idx["occtab"].numel() * 4 + table.numel() * 4
              + out[0].numel() * out[0].element_size() + out[0].shape[0] * 9)
    return nbytes, steps * (2 * 2 * 5 * (nw / 2 + 1) + 64), steps


def check_refill(rec, host_dir, forms, count=257, lanes=128):
    """K1's refill mode against its plain version at every main-path
    launch on its own arguments and in the form it ran there (`forms`,
    from the launch's own count): the whole table, its lanes and caps,
    each timed over 5 launches at int32 and int64, both held to one plain
    run and every read drawn; the first launch's plain run on the card,
    the later ones on the host in subprocesses (host_dir) that
    finish_refill waits for with the pending list returned beside the
    rows; and `count` reads spread over the first launch's table, drawn by
    `lanes` lanes (several reads each), in both forms at both coordinate
    types.  Each read's seeds, in _demux_refill's order, must be equal.
    Returns a row for each form (the kernels line's), from that form's
    first main-path launch, its bound from its own lane steps; a form
    that no main-path launch ran fails the run."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    checks, pending = [], []
    for i, (ph, args, kw) in enumerate(rec.calls):
        k = dict(kw, group=forms[i] == "group")
        a64 = (coord_tree(args[0], "int64"), *args[1:])
        got = fmm.seed_machine_refill(*args, **k)
        got64 = fmm.seed_machine_refill(*a64, **k)
        nbytes, ops, steps = refill_work(args[0], args[1], got)
        c = dict(phase=ph, call=i, reads=int(args[1].shape[0]),
                 lanes=int(args[2]), form=forms[i], cap_s=kw["cap_s"],
                 cap_r=kw["cap_r"], longest_lane_steps=int(got[2]),
                 lane_steps=steps, bytes=int(nbytes), ops=float(ops),
                 ms=cuda_time(lambda: fmm.seed_machine_refill(*args, **k),
                              5),
                 int64_ms=cuda_time(
                     lambda: fmm.seed_machine_refill(*a64, **k), 5),
                 int64_longest_lane_steps=int(got64[2]), err=0)
        checks.append(c)
        if i == 0:  # the first launch's plain version on the card, timed
            want, c["plain_ms"] = timed_once(
                lambda: fmm.seed_machine_refill_plain(*args, **kw))
            refill_checked(c, got, want, got64)
        else:  # the rest on the host meanwhile (finish_refill waits)
            pending.append((c, start_refill_host_plain(host_dir, i, args,
                                                       kw), got, got64))
    _, args, kw = rec.calls[0]
    idx, table = args[0], args[1]
    n = table.shape[0]
    sel = torch.arange(0, n, max(1, n // count), device=table.device)[:count]
    k = dict(kw, cap_s=2 * kw["cap_r"] * (-(-count // lanes) + 1))
    a = (idx, table[sel], lanes, *args[3:])

    def small(a):
        """Both forms on the subset against one plain run."""
        want = fmm.seed_machine_refill_plain(*a, **k)
        out = {}
        for form in ("warp", "group"):
            equal, err, rows, left_out, drawn = refill_equal(
                fmm.seed_machine_refill(*a, **k, group=form == "group"),
                want, count)
            out[form] = dict(equal=equal and drawn == (count, count),
                             err=err, rows_checked=rows,
                             reads_left_out=left_out, drawn=drawn)
        return out

    extra = dict(reads=count, lanes=lanes, cap_s=k["cap_s"], int32=small(a),
                 int64=small((coord_tree(idx, "int64"), *a[1:])))
    log(f"K1 refill small check {extra}")
    for coords in ("int32", "int64"):
        for form in ("warp", "group"):
            if not extra[coords][form]["equal"]:
                fail(f"K1's refill mode at {coords} in its {form} form "
                     f"disagrees with its plain version on {count} reads "
                     f"of mem_se_refill (reads drawn "
                     f"{extra[coords][form]['drawn']})")
    rows = {}
    for form in ("group", "warp"):
        cs = [c for c in checks if c["form"] == form]
        if not cs:
            fail(f"no main-path launch ran K1's refill mode in its {form} "
                 f"form")
        c = cs[0]
        _, a0, kw0 = rec.calls[c["call"]]
        rows[form] = dict(
            phase=c["phase"], call=c["call"], ms=c["ms"],
            plain_ms=c.get("plain_ms"),
            plain_shape=f"each main-path launch at its own shape, the first "
                        f"on the card, the rest on the host; also {count} "
                        f"reads on {lanes} lanes",
            equal=True, err=c["err"], main_path_checks=cs,
            small_check=extra,
            shape=f"N={c['reads']} lanes={c['lanes']} "
                  f"L={(a0[1].shape[1] - 2) // 2} cap={kw0['cap']} "
                  f"cap_s={kw0['cap_s']}",
            lane_steps=c["lane_steps"],
            longest_lane_steps=c["longest_lane_steps"], n_drawn=c["reads"],
            bytes=c["bytes"], ops=c["ops"],
            int64=dict(ms=c["int64_ms"],
                       longest_lane_steps=c["int64_longest_lane_steps"]))
        rows[form]["bound_ms"], rows[form]["bound_by"] = bound(c["bytes"],
                                                               c["ops"])
        log(f"K1 refill {form} form {rows[form]}")
    return rows, pending


def pipeline_phase(d, prefix, name, fqs, extra, K, want):
    """main_mem with -K K (four chunks or more) on the card: the
    chunk_done_hook's (reads, seconds) of each chunk, and its SAM records
    against `want`, the same command's single-chunk output."""
    import torch

    from bwa_tpu_torch.cli import main_mem

    stamps = []
    out = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    rc = main_mem([*extra, "-K", str(K), "--device", "cuda", prefix,
                   *map(str, fqs)], out, chunk_done_hook=lambda n:
                  stamps.append((n, time.perf_counter() - t0)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    info = dict(phase=name, K=K, chunks=len(stamps), chunk_done=stamps,
                seconds=dt, launches=read_launches())
    if rc != 0:
        fail(f"{name}: main_mem exited {rc}")
    if len(stamps) < 4:
        fail(f"{name}: {len(stamps)} chunks, expected 4 or more")
    same_sam(name, out.getvalue(), want, "the single-chunk run's")
    info["equal_single_chunk"] = True
    log(f"{name} {info}")
    return info


def seeding_route_phases(d, prefix, codes, pe, sam_se):
    """Step 4d: the 24,576 x 150 bp SE reads with BWA_TPU_TRIP_SORT off,
    force, force and off, the 12,288 pairs off and force, the SE reads with
    BWA_TPU_SEED_REFILL=1 (and BWA_TPU_REFILL_LANES=1024), SAM equal to
    the unsorted static run's; K8 and the refill mode held to their plain
    versions; then main_mem in four chunks or more.  Returns (phases, K8's
    row, the refill row, its launches pending on the host)."""
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.ops import fm_machine

    t0 = time.perf_counter()
    reads = simulate(codes, 24576, 150, SEED + 12, 0.005, 0.0002, "t")[0]
    recs = {"K1": Recorder(fm_machine, "seed_machine",
                           keep=lambda out: out[2]),
            "K8": Recorder(fm_ops, "probe_breaks"),
            "K1 refill": Recorder(fm_machine, "seed_machine_refill",
                                  keep=lambda out: (
                                      out[5],
                                      fm_machine.refill_group_launches))}
    runs = {}
    try:
        # off, force, force, off: the SE walls in turns
        for name, rd, rd2, env in (
                ("mem_se_tripsort_off", reads, None,
                 dict(BWA_TPU_TRIP_SORT="off")),
                ("mem_se_tripsort", reads, None,
                 dict(BWA_TPU_TRIP_SORT="force")),
                ("mem_se_tripsort_2", reads, None,
                 dict(BWA_TPU_TRIP_SORT="force")),
                ("mem_se_tripsort_off_2", reads, None,
                 dict(BWA_TPU_TRIP_SORT="off")),
                ("mem_pe_tripsort_off", pe[0], pe[1],
                 dict(BWA_TPU_TRIP_SORT="off")),
                ("mem_pe_tripsort", pe[0], pe[1],
                 dict(BWA_TPU_TRIP_SORT="force")),
                ("mem_se_refill", reads, None,
                 dict(BWA_TPU_SEED_REFILL="1")),
                ("mem_se_refill_1024", reads, None,
                 dict(BWA_TPU_SEED_REFILL="1", BWA_TPU_REFILL_LANES="1024"))):
            with env_set(**env):
                runs[name] = main_path(d, prefix, name, rd, [], recs, rd2)
    finally:
        for r in recs.values():
            r.restore()
    info = {k: v[0] for k, v in runs.items()}
    sam = {k: v[1] for k, v in runs.items()}
    for name, ref in (("mem_se_tripsort", "mem_se_tripsort_off"),
                      ("mem_se_tripsort_2", "mem_se_tripsort_off"),
                      ("mem_se_tripsort_off_2", "mem_se_tripsort_off"),
                      ("mem_pe_tripsort", "mem_pe_tripsort_off"),
                      ("mem_se_refill", "mem_se_tripsort_off"),
                      ("mem_se_refill_1024", "mem_se_tripsort_off")):
        same_sam(name, sam[name], sam[ref], f"{ref}'s")
        info[name][f"sam_equal_{ref}"] = True
    for name, k8, k1, k1r in (
            ("mem_se_tripsort", 1, 1, 0), ("mem_se_tripsort_off", 0, 1, 0),
            ("mem_se_tripsort_2", 1, 1, 0),
            ("mem_se_tripsort_off_2", 0, 1, 0),
            ("mem_pe_tripsort", 1, 1, 0), ("mem_pe_tripsort_off", 0, 1, 0),
            ("mem_se_refill", 0, 0, 1), ("mem_se_refill_1024", 0, 0, 1)):
        c = info[name]["launches"]
        if c["K8"] != k8 or (c["K1"] >= 1) != bool(k1) \
                or (c["K1 refill"] >= 1) != bool(k1r):
            fail(f"{name}: launches {c}: expected K8 {k8}, K1 "
                 f"{'some' if k1 else 'none'}, K1 refill "
                 f"{'some' if k1r else 'none'}")
    for r in recs.values():
        r.take_ms()
    steps = {ph: k1_steps(recs["K1"], ph) for ph in (
        "mem_se_tripsort_off", "mem_se_tripsort", "mem_se_tripsort_2",
        "mem_se_tripsort_off_2", "mem_pe_tripsort_off", "mem_pe_tripsort")}
    for sorted_ph in ("mem_se_tripsort", "mem_pe_tripsort"):
        a = [s["longest_lane_steps"] for s in steps[sorted_ph]]
        b = [s["longest_lane_steps"]
             for s in steps[sorted_ph + "_off"]]
        info[sorted_ph]["longest_lane_steps"] = a
        info[sorted_ph]["longest_lane_steps_off"] = b
        info[sorted_ph]["steps_change"] = sum(a) / max(1, sum(b)) - 1
    # each refill launch's form, from the group form's count after it (the
    # counts start at 0 with each phase)
    refill_launches, after = [], {}
    for i, ((ph, a, kw), (qctr, n_group)) in enumerate(
            zip(recs["K1 refill"].calls, recs["K1 refill"].kept)):
        form = "group" if n_group > after.get(ph, 0) else "warp"
        after[ph] = n_group
        refill_launches.append(dict(
            phase=ph, call=i, form=form, lanes=int(a[2]),
            reads=int(a[1].shape[0]), cap_s=kw["cap_s"],
            n_drawn=min(int(qctr), int(a[1].shape[0])),
            event_ms=recs["K1 refill"].call_ms.get(i)))
        log(f"K1 refill launch {refill_launches[-1]}")
    main_s = time.perf_counter() - t0
    k8 = check_k8(recs["K8"])
    k1r, k1r_pending = check_refill(recs["K1 refill"], d,
                                    [x["form"] for x in refill_launches])
    for form, row in k1r.items():
        row["launches_on_main_path"] = [x for x in refill_launches
                                        if x["form"] == form]
    # main_mem's reader/writer threads: SE against mem_se_150bp's output,
    # PE (-I: no per-chunk insert-size estimate) against the one-chunk run
    se_fq = [d / "mem_se_150bp.fq"]
    pe_fq = [d / "mem_pe_150bp.fq", d / "mem_pe_150bp_2.fq"]
    pe_want, _ = run_mem(prefix, pe_fq, ["-I", "350,40"])
    pipes = [pipeline_phase(d, prefix, "mem_se_150bp_chunked", se_fq, [],
                            150_000, sam_se),
             pipeline_phase(d, prefix, "mem_pe_150bp_chunked", pe_fq,
                            ["-I", "350,40"], 1_000_000, pe_want)]
    log(f"step 4d: {main_s:.1f} s of phases, "
        f"{time.perf_counter() - t0:.1f} s in all")
    for ph in (*info.values(), *pipes):
        print(json.dumps(ph), flush=True)
    print(json.dumps(dict(k1_longest_lane_steps=steps)), flush=True)
    return list(info.values()) + pipes, k8, k1r, k1r_pending


# --------------------------------------------------------------------------
# 4f. the seeding routes off the default path (K12, K13) and the
# cross-check programs (K9, K10, K11)
# --------------------------------------------------------------------------

ROUTE_ENV = {"split": {"BWA_TPU_SEED_MACHINE": "split"},
             "compact": {"BWA_TPU_SEED_COMPACT": "1"}}
# each route's mem phases: (name, the FASTQs of step 4d or 4a, options, the
# unified route's phase whose SAM must come out)
ROUTE_PHASES = (
    ("mem_se", ["mem_se_tripsort_off"], [], "mem_se_tripsort_off"),
    ("mem_pe", ["mem_pe_tripsort_off", "mem_pe_tripsort_off_2"], [],
     "mem_pe_tripsort_off"),
    ("mem_se_primary5", ["mem_se_150bp_primary5"], ["-5"],
     "mem_se_150bp_primary5"),
    ("mem_pacbio_primary5", ["mem_pacbio_primary5"], ["-x", "pacbio", "-5"],
     "mem_pacbio_primary5"))
# K1's state mode: its per-lane fields, in and out (ops/fm_machine.py::
# SEG_FIELDS, ik three of them)
STATE_FIELDS = 23


class SegmentRecorder:
    """Stands in for fm_machine.segment (K13): keeps a copy of the first
    call's state (the kernel updates the state in place) and inputs,
    brackets every call with CUDA events, notes each call's phase, lanes
    and step budget."""

    def __init__(self):
        from bwa_tpu_torch.ops import fm_machine

        self.mod, self.real = fm_machine, fm_machine.segment
        self.phase, self.first, self.calls, self.events = None, None, [], []
        self.call_ms = {}
        fm_machine.segment = self

    def __call__(self, d, idx, q, qlen, nv, *rest):
        import torch

        if self.first is None:
            self.first = ({k: v.clone() if torch.is_tensor(v) else v
                           for k, v in d.items()}, idx, q.clone(),
                          qlen.clone(), nv.clone(), rest)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.real(d, idx, q, qlen, nv, *rest)
        b.record()
        self.events.append((len(self.calls), a, b))
        self.calls.append(dict(phase=self.phase, lanes=int(q.shape[0]),
                               max_steps=int(rest[4])))
        return out

    take_ms = Recorder.take_ms

    def restore(self):
        self.mod.segment = self.real


class LevelLog:
    """Wraps BatchedFMEngine._compact: each call's lanes, steps and lanes
    still running after every segment (the engine's last_levels)."""

    def __init__(self):
        from bwa_tpu_torch.ops import fm

        self.cls, self.real = fm.BatchedFMEngine, fm.BatchedFMEngine._compact
        self.phase, self.levels = None, []
        real, levels = self.real, self.levels

        def compact(eng, *a, **kw):
            out = real(eng, *a, **kw)
            levels.append(dict(phase=self.phase, levels=[
                dict(lanes=b, steps=s, running=r)
                for b, s, r in eng.last_levels]))
            return out

        self.cls._compact = compact

    def restore(self):
        self.cls._compact = self.real


def route_run(prefix, phase, fqs, extra, route, recs, device):
    """`mem` on the FASTQs through the CLI on the device under a seeding
    route, the launches counted from zero and each recorded wrapper's
    event ms summed."""
    import torch

    from bwa_tpu_torch.cli import main as cli_main

    for r in recs.values():
        r.phase = phase
        r.events = []
    zero_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with env_set(**ROUTE_ENV[route]):
        rc = cli_main(["mem", *extra, "--device", device, str(prefix),
                       *map(str, fqs)], out_fp=out)
    torch.cuda.synchronize()
    sam, dt = out.getvalue(), time.perf_counter() - t0
    if rc != 0:
        fail(f"{phase}: mem exited {rc}")
    info = dict(phase=phase, route=route, seconds=dt,
                launches=read_launches(),
                kernel_event_ms={k: r.take_ms() for k, r in recs.items()
                                 if hasattr(r, "take_ms")})
    return info, sam


def counted(phase, fn):
    """fn() with the launches counted from zero: (its result, the phase's
    record)."""
    import torch

    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(phase=phase, seconds=time.perf_counter() - t0,
                     launches=read_launches())


def state_rows(d, rows):
    """Rows `rows` of a machine state (its per-lane tensors), a copy."""
    import torch

    B = d["phase"].shape[0]
    return {k: v[rows].clone() if torch.is_tensor(v) and v.dim() >= 1
            and v.shape[0] == B else v for k, v in d.items()}


def states_equal(a, b):
    """(every field of two machine states equal, the largest difference)."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    ok, err = True, 0
    for k in fmm.SEG_FIELDS + ("stkA", "stkB", "seeds", "qmask", "steps"):
        x, y = a[k], b[k]
        x = x.cpu().long().reshape(-1) if torch.is_tensor(x) \
            else torch.tensor([int(x)])
        y = y.cpu().long().reshape(-1) if torch.is_tensor(y) \
            else torch.tensor([int(y)])
        ok &= torch.equal(x, y)
        err = max(err, int((x - y).abs().max()) if x.numel() else 0)
    return ok, err


def spread_rows(n, extra, count=256):
    """`count` rows spread over n, and the rows `extra` (the longest)."""
    rows = set(range(0, n, max(1, n // count)))
    rows.update(int(e) for e in extra)
    return sorted(rows)


def state_bytes(B, cap, cap_s, q, nv, occ):
    """A launch of K1's state mode: the occtab, codes, lengths and
    next-valid table read once; the per-lane fields and both stacks
    (int64), the seed store (int64) and its bits read and written once."""
    return (occ.numel() * 4 + q.numel() + q.shape[0] * 4 + nv.numel() * 4
            + 2 * B * (STATE_FIELDS * 8 + 2 * cap * 4 * 8 + cap_s * 5 * 8
                       + cap_s))


def step_ops(steps, nw):
    """K1's count for a lane step (k1_work): two masks at 5 ops a word an
    end over nw/2 + 1 words, and ~64 ops of state update."""
    return steps * (2 * 2 * 5 * (nw / 2 + 1) + 64)


def state_kernel_ms(pack, reps=5):
    """CUDA-event ms a launch of K1's state mode alone (cuda_kernels.
    seed_state), on states packed in advance: pack() returns a fresh
    launch's arguments (fm_machine._pack_state), not timed."""
    import torch

    from bwa_tpu_torch.ops import cuda_kernels

    packs = [pack() for _ in range(reps + 1)]
    cuda_kernels.seed_state(*packs.pop())  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for p in packs:
        cuda_kernels.seed_state(*p)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_k12(rec, name, pass2=None):
    """A recorded K12 call (smem_machine, pass 1 or 2, or seed3_machine:
    the first of step 4f) on all its lanes, timed; then the same launch of
    K1's state mode on 256 of its lanes and its longest, its whole state
    against the plain version's on the card (and its lane steps, from
    done_step, for the bound)."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    i = 0 if pass2 is None else next(
        j for j, (_, a, kw) in enumerate(rec.calls) if kw["pass2"] == pass2)
    ph, args, kw = rec.calls[i]
    fn = getattr(fmm, rec.name)
    idx, q, qlen, nv = args[:4]
    ms = cuda_time(lambda: fn(*args, **kw), 5)
    if rec.name == "smem_machine":
        p2 = kw["pass2"]
        stage, cap = (fmm.S_P2 if p2 else fmm.S_P1), kw["cap"]
        seeds, seed_n, old_n = args[7], args[8], args[9] if p2 else None
        consts, use_p3, jobs = (*args[4:7], 0), False, p2
    else:
        stage, cap = fmm.S_P3, 1
        seeds, seed_n, old_n = args[6], args[7], None
        consts, use_p3, jobs = (args[4], 0, 0, args[5]), True, False

    def state(rows=None):
        r = (lambda t: t) if rows is None else (lambda t: t[rows])
        d = fmm._stage_state(idx, r(q), stage, cap, kw["cap_s"], r(seeds),
                             r(seed_n), None if old_n is None else r(old_n))
        return d, idx, r(q), r(qlen), r(nv), *consts, fmm.BIG_STEPS, cap, \
            kw["cap_s"], use_p3, stage, r(seeds) if jobs else None

    kernel_ms = state_kernel_ms(lambda: fmm._pack_state(*state()))
    done = fmm._launch_state(*state())["done_step"]
    rows = torch.as_tensor(spread_rows(q.shape[0], [int(done.argmax())]),
                           device=q.device)
    got = fmm._launch_state(*state(rows))
    sub = state(rows)
    want, plain_ms = timed_once(lambda: fmm._plain_state(*sub))
    equal, err = states_equal(got, want)
    steps = int(done.sum())
    occ = idx["occtab"]
    nbytes = state_bytes(q.shape[0], cap, kw["cap_s"], q, nv, occ)
    res = dict(phase=ph, call=i, ms=ms, kernel_ms=kernel_ms,
               plain_ms=plain_ms,
               plain_shape=f"{len(rows)} lanes on the card",
               equal=bool(equal), err=err,
               shape=f"B={q.shape[0]} L={q.shape[1]} cap={cap} "
                     f"cap_s={kw['cap_s']}" + (f" pass2={kw['pass2']}"
                                               if "pass2" in kw else ""),
               lane_steps=steps, longest_lane_steps=int(done.max()),
               ns_per_step=per_unit(kernel_ms, int(done.max())),
               bytes=int(nbytes),
               ops=float(step_ops(steps, occ.shape[1] - 4)))
    res["bound_ms"], res["bound_by"] = bound(nbytes, res["ops"])
    log(f"{name} {res}")
    if not equal:
        fail(f"{name} disagrees with its plain version at {ph}'s launch")
    return res


def check_k13(seg):
    """K13's first main-path launch (the compaction route's first
    segment) on all its lanes, timed from copies of its first state, and
    on 256 of its lanes and the one that runs longest, two segments (the
    first's budget, then a second of 256 steps) against the plain version
    on the card, the whole state compared after each."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    d0, idx, q, qlen, nv, rest = seg.first
    B = q.shape[0]
    copies = [state_rows(d0, torch.arange(B, device=q.device))
              for _ in range(6)]
    fmm.segment(copies.pop(), idx, q, qlen, nv, *rest)  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for c in copies:
        fmm.segment(c, idx, q, qlen, nv, *rest)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / len(copies)
    kernel_ms = state_kernel_ms(lambda: fmm._pack_state(
        state_rows(d0, torch.arange(B, device=q.device)), idx, q, qlen, nv,
        *rest, fmm.S_P3, None))
    out = copies[-1]
    steps_in, stop = (int(torch.as_tensor(x).reshape(-1)[0])
                      for x in (d0["steps"], out["steps"]))
    ran = torch.where(out["done_step"] > 0, out["done_step"],
                      torch.full_like(out["done_step"], stop)) - steps_in
    ran = torch.where(d0["phase"] == fmm.P_DONE, torch.zeros_like(ran), ran)
    lane_steps = int(ran.sum())
    longest = int(ran.argmax())
    rows = torch.as_tensor(spread_rows(B, [longest]), device=q.device)
    dc = state_rows(d0, rows)
    dp = state_rows(d0, rows)
    ins = (q[rows], qlen[rows], nv[rows])
    res, plain_ms = [], None
    for budget in (rest[4], 256):
        r2 = (*rest[:4], budget, *rest[5:])
        dc = fmm.segment(dc, idx, *ins, *r2)
        torch.cuda.synchronize()
        dp, t = timed_once(lambda: fmm._plain_state(dp, idx, *ins, *r2,
                                                    fmm.S_P3, None))
        plain_ms = t if plain_ms is None else plain_ms
        res.append(states_equal(dc, dp))
    equal = all(e for e, _ in res)
    cap, cap_s = rest[5], rest[6]
    occ = idx["occtab"]
    nbytes = state_bytes(B, cap, cap_s, q, nv, occ)
    info = dict(phase=seg.calls[0]["phase"], call=0, ms=ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                plain_shape=f"{len(rows)} lanes, the first segment",
                equal=bool(equal), err=max(e for _, e in res),
                shape=f"B={B} L={q.shape[1]} cap={cap} cap_s={cap_s} "
                      f"max_steps={rest[4]}",
                lane_steps=lane_steps, longest_lane_steps=int(ran.max()),
                ns_per_step=per_unit(kernel_ms, int(ran.max())),
                bytes=int(nbytes),
                ops=float(step_ops(lane_steps, occ.shape[1] - 4)))
    info["bound_ms"], info["bound_by"] = bound(nbytes, info["ops"])
    log(f"K13 {info}")
    if not equal:
        fail("K13 disagrees with its plain version at its first main-path "
             "segment")
    return info


def check_smem_kernel(rec, name, keyed, count=256, call=0):
    """A recorded K10a, K10b or K11 call (rec.calls[call]) on all its reads,
    timed, its intervals extended counted by the kernel, and on `count`
    of its reads and the one that extends most (keyed(out): per read)
    against the plain version on the card; its launch plan (the form, the
    reads a warp, the warps a block, the resident reads), its device time
    (busy_time: the card kept busy ahead of the host) and, for K10a, the
    other form on the same call, timed, its outputs equal."""
    import torch

    from bwa_tpu_torch.ops import fm as fm_ops

    ph, args, kw = rec.calls[call]
    fn = getattr(fm_ops, rec.name)
    plain = getattr(fm_ops, rec.name + "_plain")
    idx, q = args[0], args[1]
    work = torch.zeros(1, dtype=torch.int64, device=q.device)
    out = fn(*args, **kw, work=work)
    plan = dict(fm_ops.smem_plans.get(name, {}) if q.is_cuda else {})
    ms = cuda_time(lambda: fn(*args, **kw), 5)
    busy_ms = busy_time(lambda: fn(*args, **kw), 5) if q.is_cuda else None
    rows = torch.as_tensor(spread_rows(q.shape[0], [int(keyed(out).argmax())],
                                       count), device=q.device)
    sub = [idx] + [a[rows] if torch.is_tensor(a) and a.dim() >= 1
                   and a.shape[0] == q.shape[0] else a for a in args[1:]]
    got = fn(*sub, **kw)
    pkw = {k: v for k, v in kw.items() if k != "form"}  # a kernel's only
    want, plain_ms = timed_once(lambda: plain(*sub, **pkw))
    equal = all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))
    err = max(int((g.cpu().long() - w.cpu().long()).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    occ = idx["occtab"]
    n = int(work)
    nbytes = occ.numel() * 4 + sum(a.numel() * a.element_size()
                                   for a in args[1:] if torch.is_tensor(a)) \
        + sum(o.numel() * o.element_size() for o in out)
    res = dict(phase=ph, call=call, ms=ms, busy_ms=busy_ms, plain_ms=plain_ms,
               plain_shape=f"{len(rows)} reads on the card", equal=equal,
               err=err, shape=f"B={q.shape[0]} L={q.shape[1]}"
               + "".join(f" {k}={v}" for k, v in kw.items()),
               extensions=n, bytes=int(nbytes),
               ops=float(step_ops(n, occ.shape[1] - 4)), **{
                   k: plan.get(k) for k in ("form", "reads_per_warp",
                                        "warps_per_block", "blocks",
                                        "resident_reads", "lists",
                                        "registers")})
    if plan and name == "K10a":  # the other form, the same call
        other = next(f for f in fm_ops.SMEM_FORMS if f != plan["form"])
        ko = dict(kw, form=other)
        same = all(torch.equal(a, b) for a, b in zip(out, fn(*args, **ko)))
        res["other_form"] = dict(
            form=other, equal=same,
            ms=cuda_time(lambda: fn(*args, **ko), 5),
            busy_ms=busy_time(lambda: fn(*args, **ko), 5))
        if not same:
            fail(f"{name}'s {other} form disagrees with its "
                 f"{plan['form']} form at {ph}'s launch")
    res["bound_ms"], res["bound_by"] = bound(nbytes, res["ops"])
    log(f"{name} {res}")
    if not equal:
        fail(f"{name} disagrees with its plain version at {ph}'s launch")
    return res


def check_k9(idx, ks):
    """K9 on the 65,536 rows: timed, its walk steps counted by the kernel,
    against the plain version on the card (all rows)."""
    import torch

    from bwa_tpu_torch.ops import fm as fm_ops

    work = torch.zeros(1, dtype=torch.int64, device=ks.device)
    got = fm_ops.sa_batch(idx, ks, work=work)
    ms = cuda_time(lambda: fm_ops.sa_batch(idx, ks), 10)
    want, plain_ms = timed_once(lambda: fm_ops.sa_batch_plain(idx, ks))
    equal = torch.equal(got, want)
    walk = int(work)
    nbytes = sum(idx[k].numel() * idx[k].element_size()
                 for k in ("ckpt", "words", "ssa")) + 2 * ks.numel() * 4
    # a walk step: the base at the row (a word), then its count at one end,
    # one base, over the words of the block up to the row: nw/2 + 1 of its
    # nw on average, 5 ops a word, ~16 besides
    nw = idx["words"].shape[1]
    res = dict(phase="sa_batch_65536", call=0, ms=ms, plain_ms=plain_ms,
               plain_shape="all 65,536 rows on the card", equal=equal,
               err=int((got.long() - want.long()).abs().max()),
               shape=f"N={ks.numel()}", walk_steps=walk, bytes=int(nbytes),
               ops=float(walk * ((nw / 2 + 1) * 5 + 16)))
    res["bound_ms"], res["bound_by"] = bound(nbytes, res["ops"])
    log(f"K9 {res}")
    if not equal:
        fail("K9 disagrees with its plain version")
    return res


def read_lists(out, n):
    """Per-read [(x0, x1, x2, info)] of collect_seeds' numpy arrays (None
    for a read whose seeds overflowed the store)."""
    s0, s1, s2, ss, se, sn = out[:6]
    cap_s = s0.shape[1]
    return [None if sn[b] > cap_s else
            [(int(s0[b, j]), int(s1[b, j]), int(s2[b, j]),
              (int(ss[b, j]) << 32) | int(se[b, j]))
             for j in range(int(sn[b]))] for b in range(n)]


def seeding_route_kernels(d, prefix, fm, reads150, device="cuda"):
    """Step 4f: `mem` under BWA_TPU_SEED_MACHINE=split (K12) and
    BWA_TPU_SEED_COMPACT=1 (K13) on step 4d's 24,576 SE reads and 12,288
    pairs, step 4a's 4,096 reads with -5 and its -x pacbio -5 reads (SAM
    equal to the unified route's runs of them), the -x pacbio reads
    (their lane shards refused, as bwa_tpu's demux fails on them); the
    cross-check programs on the 4,096 SE reads (collect_seeds(fused=True),
    K11, and collect_intv_batch_unfused, K10a and K10b: seeds equal to the
    unified route's read for read), sa_batch (K9) on 65,536 rows against
    fm.sa_lookup, sharded_seed_step and the dry run's entry() on the 20 kb
    genome (card against CPU); each new kernel's first launch held to its
    plain version on the card and timed.  Returns (phases, rows).  On the
    CPU (device "cpu", a rehearsal) the plain versions stand in."""
    import numpy as np
    import torch

    from bwa_tpu_torch.cli import main as cli_main
    from bwa_tpu_torch.mem import batch_seed
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.ops import fm_machine
    from bwa_tpu_torch.options import MemOptions
    from bwa_tpu_torch.parallel import dryrun, mesh

    t0 = time.perf_counter()
    recs = {"K12a": Recorder(fm_machine, "smem_machine",
                             keep=lambda out: None),
            "K12b": Recorder(fm_machine, "seed3_machine",
                             keep=lambda out: None),
            "K13": SegmentRecorder()}
    levels = LevelLog()
    phases, refused = [], {}
    try:
        for route in ("split", "compact"):
            for name, fqs, extra, ref in ROUTE_PHASES:
                ph = f"{name}_{route}"
                levels.phase = ph
                info, sam = route_run(prefix, ph, [d / f"{f}.fq"
                                                   for f in fqs],
                                      extra, route, recs, device)
                same_sam(ph, sam, (d / f"{ref}.out").read_text(),
                         f"{ref}'s (the unified route)")
                info[f"sam_equal_{ref}"] = True
                c = info["launches"]
                need = ("K12a", "K12b") if route == "split" else ("K13",)
                if any(c[k] < 1 for k in need) or c["K1"] or c["K1 refill"]:
                    fail(f"{ph}: launches {c}: expected {need}, no K1")
                if route == "compact":
                    info["compaction_levels"] = [
                        x["levels"] for x in levels.levels if x["phase"] == ph]
                info["segments"] = [x for x in recs["K13"].calls
                                    if x["phase"] == ph]
                log(f"step 4f {info}")
                phases.append(info)
            # -x pacbio's lane shards need the provenance column that these
            # routes' seed store lacks (bwa_tpu's demux fails on them)
            key = next(iter(ROUTE_ENV[route]))
            with env_set(**ROUTE_ENV[route]):
                try:
                    cli_main(["mem", "-x", "pacbio", "--device", device,
                              str(prefix), str(d / "mem_pacbio.fq")],
                             out_fp=io.StringIO())
                except ValueError as e:
                    if key not in str(e):
                        fail(f"mem_pacbio_{route}: {e!r} names no route")
                    refused[route] = str(e)
                else:
                    fail(f"mem_pacbio_{route}: lane-sharded reads ran")
        for r in recs.values():
            r.take_ms()
    finally:
        for r in (*recs.values(), levels):
            r.restore()
    route_s = time.perf_counter() - t0
    log(f"step 4f: the routes' phases in {route_s:.1f} s; pacbio refused "
        f"{refused}")

    # the cross-check programs on the 4,096 SE reads
    opt = MemOptions()
    eng = fm_ops.BatchedFMEngine(fm, device=device)
    codes = [r for _, r in reads150]
    n = len(codes)
    unified = batch_seed.collect_intv_batch(opt, eng, codes)
    crecs = {"K11": Recorder(fm_ops, "collect_intv_device"),
             "K10a": Recorder(fm_ops, "smem1a_batch"),
             "K10b": Recorder(fm_ops, "seed_strategy1_batch")}
    try:
        q, lens, _ = batch_seed._pad_reads(codes)
        crecs["K11"].phase = "seeds_fused_4096"
        crecs["K10a"].phase = crecs["K10b"].phase = "seeds_unfused_4096"
        out, ph_f = counted("seeds_fused_4096", lambda: eng.collect_seeds(
            q, lens, opt, 96, fused=True))
        fused = read_lists(out, n)
        # reads whose seeds overflow cap_s 96 are run again at twice the
        # cap until none does, and compared like the rest
        over = [b for b in range(n) if fused[b] is None]
        cap_s, left = 96, over
        while left:
            cap_s *= 2
            if cap_s > 8 * q.shape[1]:
                fail(f"seeds_fused_4096: reads {left[:8]} overflow cap_s "
                     f"{cap_s // 2}")
            again = read_lists(eng.collect_seeds(
                q[left], lens[left], opt, cap_s, fused=True), len(left))
            for b, x in zip(left, again):
                fused[b] = x
            left = [b for b in left if fused[b] is None]
        diff = [b for b in range(n) if fused[b] != unified[b]]
        if diff:
            fail(f"seeds_fused_4096: reads {diff[:8]} differ from the "
                 f"unified route's")
        ph_f.update(reads_equal_unified=n, overflow_reads=len(over),
                    overflow_rerun_cap_s=cap_s if over else None)
        unf, ph_u = counted("seeds_unfused_4096", lambda: (
            batch_seed.collect_intv_batch_unfused(opt, eng, codes)))
        if unf != unified:
            fail("seeds_unfused_4096: seeds differ from the unified route's")
        ph_u["reads_equal_unified"] = n
        rng = np.random.default_rng(SEED + 13)
        ks = torch.from_numpy(rng.integers(0, fm.seq_len, 65536)).to(
            eng.idx["cdt"]).to(device)
        pos, ph_k9 = counted("sa_batch_65536",
                             lambda: fm_ops.sa_batch(eng.idx, ks))
        if not np.array_equal(pos.cpu().numpy(),
                              fm.sa_lookup(ks.cpu().numpy())):
            fail("sa_batch_65536: positions differ from fm.sa_lookup")
        # the 20 kb genome: sharded_seed_step on two shards of the card and
        # the dry run's entry(), each against its CPU run
        tiny = dryrun._tiny_index()
        qt = dryrun._tiny_reads(tiny)
        lt = np.full(qt.shape[0], qt.shape[1], np.int32)
        xt = np.random.default_rng(5).integers(0, 90, qt.shape[0]).astype(
            np.int32)
        from bwa_tpu_torch.index.fmindex import DeviceFMIndex

        cm = mesh.make_mesh(devices=[device] * 2)
        tm = {cm.devices[0]: DeviceFMIndex(tiny, device=device).tree()}
        hm = mesh.make_mesh(devices=["cpu", "cpu"])
        th = {hm.devices[0]: DeviceFMIndex(tiny, device="cpu").tree()}
        step = mesh.sharded_seed_step(tm, cm, qt.shape[1] + 2)
        crecs["K10a"].phase = "sharded_seed_step"
        got, ph_s = counted("sharded_seed_step", lambda: step(qt, lt, xt))
        want = mesh.sharded_seed_step(th, hm, qt.shape[1] + 2)(qt, lt, xt)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            fail("sharded_seed_step: the card's differs from the CPU's")
        ph_s.update(n_seeded=int(got[3]), mean_pos=int(got[4]))
        fn, args = dryrun.entry(device)
        crecs["K10a"].phase = "dryrun_entry"
        got, ph_e = counted("dryrun_entry", lambda: fn(*args))
        fh, ah = dryrun.entry("cpu")
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, fh(*ah))):
            fail("dryrun_entry: the card's step differs from the CPU's")
        for ph, ks_ in ((ph_f, ("K11",)), (ph_u, ("K10a", "K10b")),
                        (ph_k9, ("K9",)), (ph_s, ("K10a", "K9")),
                        (ph_e, ("K10a", "K9"))):
            if any(ph["launches"][k] < 1 for k in ks_):
                fail(f"{ph['phase']}: launches {ph['launches']}: expected "
                     f"{ks_}")
            log(f"step 4f {ph}")
        phases += [ph_f, ph_u, ph_k9, ph_s, ph_e]
    finally:
        for r in crecs.values():
            r.restore()
    # each kernel's first launch against its plain version, timed
    rows = {"K12a": check_k12(recs["K12a"], "K12a", pass2=False),
                "K12a pass 2": check_k12(recs["K12a"], "K12a", pass2=True),
                "K12b": check_k12(recs["K12b"], "K12b"),
                "K13": check_k13(recs["K13"]),
                "K9": check_k9(eng.idx, ks),
                "K10a": check_smem_kernel(crecs["K10a"], "K10a",
                                          lambda o: o[6]),
                "K10b": check_smem_kernel(crecs["K10b"], "K10b",
                                          lambda o: o[0] - o[5]),
                "K11": check_smem_kernel(crecs["K11"], "K11",
                                         lambda o: o[5], count=64)}
    # K10a's first launch runs the group form (every read from x = 0); the
    # unfused route's pass-2 launch, the warp form, is held to the plain
    # version too, at its own shape (x inside the reads)
    k10a = crecs["K10a"]
    pass2 = max(i for i, (ph, _, _) in enumerate(k10a.calls)
                if ph == "seeds_unfused_4096")
    if device == "cuda" and k10a.calls[pass2][2].get("form") != "warp":
        fail(f"step 4f: K10a's pass-2 launch ran the "
             f"{k10a.calls[pass2][2].get('form')} form, not the warp form")
    warp = check_smem_kernel(k10a, "K10a", lambda o: o[6], call=pass2)
    # launches by form: the calls on `device` (the recorder also sees the
    # CPU runs that the mesh step and the dry run are compared with)
    by_form = collections.Counter(kw.get("form", "warp")
                                  for _, args, kw in k10a.calls
                                  if args[1].device.type == device)
    rows["K10a"]["launches_by_form"] = dict(by_form)
    rows["K10a"]["warp_form"] = dict(
        launches=by_form["warp"], max_abs_err=warp["err"],
        **{k: warp[k] for k in (
            "phase", "call", "shape", "form", "ms", "busy_ms", "plain_ms",
            "plain_shape", "equal", "bound_ms", "bound_by", "extensions",
            "bytes", "ops", "reads_per_warp", "warps_per_block", "blocks",
            "resident_reads", "lists", "registers", "other_form")
           if k in warp})
    rows["K12a"]["pass2_launch"] = rows.pop("K12a pass 2")
    rows["K13"]["compaction_levels"] = [x for ph in phases
                                        for x in ph.get("compaction_levels",
                                                        [])]
    rows["K13"]["pacbio_refused"] = refused
    log(f"step 4f: {route_s:.1f} s of routes, "
        f"{time.perf_counter() - t0:.1f} s in all")
    return phases, rows


# --------------------------------------------------------------------------
# 4e. the mesh (every card, or two shards on one) and two hosts
# --------------------------------------------------------------------------

# step 4d's and 4b's inputs and the single-device engine's outputs of them
MESH_RUNS = (("mesh_mem_se", ("mem_se_tripsort_off.fq",),
              "mem_se_tripsort_off.out"),
             ("mesh_mem_pe", ("mem_pe_tripsort_off.fq",
                              "mem_pe_tripsort_off_2.fq"),
              "mem_pe_tripsort_off.out"),
             ("mesh_aln_se", ("aln_se_100bp.fq",), "aln_se_100bp.sai"))
# --chunk-size of the two hosts: the 24,576 x 150 bp reads in four batches
HOST_CHUNK = 24576 * 150 // 4


def the_mesh():
    """Every visible card when there are two or more, else two shards on
    cuda:0: (mesh, how it was chosen)."""
    import torch

    from bwa_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n >= 2:
        return make_mesh(), f"every visible card ({n})"
    return make_mesh(devices=["cuda:0", "cuda:0"]), \
        "two shards on cuda:0 (one card visible)"


def per_shard(rec, shard_of, phase, n, every=True):
    """A recorder's calls in `phase` by shard (shard_of: call index ->
    shard; "one" for a launch outside a sharded step): launches and
    summed event ms; with every, each of the n shards must have
    launched."""
    out = {}
    for i, (ph, _, _) in enumerate(rec.calls):
        if ph != phase:
            continue
        row = out.setdefault(shard_of.get(i, "one"),
                             dict(launches=0, event_ms=0.0))
        row["launches"] += 1
        row["event_ms"] += rec.call_ms.get(i, 0.0)
    if every and sorted(k for k in out if k != "one") != list(range(n)):
        fail(f"{phase}: launches by shard {out}: not every shard launched")
    return out


def shard_marks(recs: dict, cls):
    """Wrap cls.launch (a sharded step of parallel/mesh.py, which calls
    its kernel's wrapper once a shard, in shard order) so that the
    recorders' calls it makes are marked with their shard: returns
    ({recorder name: {call index: shard}}, a function that restores
    cls.launch)."""
    real = cls.launch
    marks = {k: {} for k in recs}

    def launch(self, *args, **kw):
        first = {k: len(r.calls) for k, r in recs.items()}
        out = real(self, *args, **kw)
        for k, r in recs.items():
            for s, i in enumerate(range(first[k], len(r.calls))):
                marks[k][i] = s
        return out

    cls.launch = launch
    return marks, lambda: setattr(cls, "launch", real)


def start_hosts(d: Path, prefix: str, fq: Path):
    """Two `python -m bwa_tpu_torch.parallel.multihost --device cuda`
    processes over gloo on 127.0.0.1 (rank r on cuda:(r mod cards)), the
    reads in four --chunk-size batches, host 0 merging: [(process, log, a
    dict that a waiter thread fills with its wall)], and the merged
    file's path."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    shards, merged = d / "hosts", d / "hosts_merged.sam"
    shutil.rmtree(shards, ignore_errors=True)
    merged.unlink(missing_ok=True)
    procs = []
    for rank in range(2):
        err = open(d / f"host{rank}.log", "w")
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "bwa_tpu_torch.parallel.multihost",
             prefix, str(fq), "--shard-dir", str(shards), "--device", "cuda",
             "--chunk-size", str(HOST_CHUNK)]
            + (["--out", str(merged)] if rank == 0 else []),
            cwd=REPO, env=env, stdout=err, stderr=subprocess.STDOUT)
        took = {}
        threading.Thread(target=lambda p=proc, t=took, t0=t0: t.setdefault(
            "s", (p.wait(), time.perf_counter() - t0)[1]),
            daemon=True).start()
        procs.append((proc, err, took))
    return procs, merged


def wait_hosts(procs, merged: Path, want: str, timeout=300) -> list:
    """Each host's wall; host 0's merged file against `want`."""
    walls = []
    for rank, (proc, err, took) in enumerate(procs):
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        err.close()
        if rc != 0:
            fail(f"multihost rank {rank} exited {rc} (see {err.name})")
        while "s" not in took:
            time.sleep(0.01)
        walls.append(took["s"])
    got = merged.read_text()
    if got != records_of(want):
        fail(f"two hosts: the merged SAM differs from one process's "
             f"({records_differ(got, want)})")
    return walls


def mesh_phases(d: Path, prefix: str, bg: list):
    """Step 4e: the mesh (every visible card, or two shards on cuda:0) as
    the CLI's engine (cli._ENGINE_CACHE, where the daemon keeps its own):
    mem on step 4d's 24,576 SE reads and 12,288 pairs, SAM equal to the
    single-device engine's runs of step 4d; aln on step 4b's 65,536 reads
    with the device search, .sai equal to step 4b's (the single-device
    engine's, equal to the native search's); each shard's first K1 launch
    held to the plain version on a lane subset here, its first K7 launch
    in a host subprocess (returned, for step 6); the dry run
    (dryrun_multichip) on the mesh's size; two multihost processes on the
    SE reads, host 0's merged SAM equal to one process's (their processes
    go into bg, which the caller stops on any exit).  Returns (the phases,
    the K1 checks, the K7 jobs)."""
    import torch

    from bwa_tpu_torch import cli
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.ops import fm_machine, gap_machine
    from bwa_tpu_torch.parallel import mesh as mesh_mod
    from bwa_tpu_torch.parallel.dryrun import dryrun_multichip

    t_all = time.perf_counter()
    mesh, how = the_mesh()
    n = mesh.size
    log(f"step 4e: the mesh is {how}: {mesh}")
    # the hosts first: their processes start while the mesh runs here
    want_se = (d / MESH_RUNS[0][2]).read_text()
    hosts, merged = start_hosts(d, prefix, d / MESH_RUNS[0][1][0])
    bg += hosts
    t0 = time.perf_counter()
    fm = FMIndex.load(prefix)
    engine = make_engine(fm, "cuda", mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    recs = {"K1": Recorder(fm_machine, "seed_machine"),
            "K7": Recorder(gap_machine, "gap_machine"),
            "K7w": Recorder(gap_machine, "cal_width")}
    # each call's shard: K1's from the sharded seeding step, K7's from the
    # sharded search (K7w runs once a chunk on the first device)
    k1_shard, undo_k1 = shard_marks({"K1": recs["K1"]},
                                    mesh_mod.ShardedMachine)
    k7_shard, undo_k7 = shard_marks({"K7": recs["K7"]},
                                    mesh_mod.ShardedGap)
    shard_of = {**k1_shard, **k7_shard, "K7w": {}}
    key = os.path.realpath(prefix)
    phases = []
    try:
        cli._ENGINE_CACHE[key] = (fm, engine, "cuda")
        for name, fqs, ref in MESH_RUNS:
            for r in recs.values():
                r.events = []
                r.phase = name
            zero_launches()
            paths = [d / f for f in fqs]
            if name.startswith("mesh_aln"):
                out, dt = run_aln(prefix, paths[0], True)
                if out != (d / ref).read_bytes():
                    fail(f"{name}: the mesh's .sai differs from the "
                         f"single-device engine's")
            else:
                out, dt = run_mem(prefix, paths, [])
                same_sam(name, out, (d / ref).read_text(),
                         "the single-device engine's")
            info = dict(phase=name, mesh=str(mesh), seconds=dt,
                        launches=read_launches(),
                        kernel_event_ms={k: r.take_ms()
                                         for k, r in recs.items()},
                        equal_single_device=True)
            for k, r in recs.items():
                if any(ph == name for ph, _, _ in r.calls):
                    info[f"{k}_by_shard"] = per_shard(r, shard_of[k], name,
                                                      n, k != "K7w")
            need = ("K7", "K7w") if name.startswith("mesh_aln") else ("K1",)
            for k in need:
                if info["launches"][k] < 1:
                    fail(f"{name}: kernel {k} was not launched")
            log(f"{name} {info}")
            phases.append(info)
    finally:
        cli._ENGINE_CACHE.pop(key, None)
        undo_k1()
        undo_k7()
        for r in recs.values():
            r.restore()
    # each shard's first K1 launch on a lane subset against the plain
    # version here, its first K7 launch in a host subprocess
    t0 = time.perf_counter()
    checks, k7_jobs = [], []
    for s in range(n):
        i = next(j for j, (ph, _, _) in enumerate(recs["K1"].calls)
                 if ph == "mesh_mem_se" and k1_shard["K1"].get(j) == s)
        _, args, kw = recs["K1"].calls[i]
        got, want, info = k1_subset(args, kw, longest=False)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        checks.append(dict(kernel="K1", shard=s, call=i, equal=ok, **info))
        if not ok:
            fail(f"K1 disagrees with its plain version at shard {s}: {info}")
        i = next(j for j, (ph, _, _) in enumerate(recs["K7"].calls)
                 if ph == "mesh_aln_se" and k7_shard["K7"].get(j) == s)
        k7_jobs.append(start_k7_host_plain(d, recs["K7"], i,
                                           f"k7_host_shard{s}"))
    check_s = time.perf_counter() - t0
    log(f"step 4e: K1 shards checked {checks}")
    # the dry run on the mesh's size
    zero_launches()
    t0 = time.perf_counter()
    dryrun_multichip(n, "cuda")
    torch.cuda.synchronize()
    phases.append(dict(phase="mesh_dryrun", shards=n,
                       seconds=time.perf_counter() - t0,
                       launches=read_launches()))
    log(f"mesh_dryrun {phases[-1]}")
    walls = wait_hosts(hosts, merged, want_se)
    phases.append(dict(phase="two_hosts", chunk_size=HOST_CHUNK,
                       host_walls=walls, merged_equal_one_process=True))
    log(f"two_hosts {phases[-1]}")
    for ph in phases:
        print(json.dumps(ph), flush=True)
    log(f"step 4e: {time.perf_counter() - t_all:.1f} s in all (engine "
        f"{setup_s:.1f} s, K1 checks {check_s:.1f} s)")
    return phases, checks, k7_jobs


# --------------------------------------------------------------------------
# --big-genome: trip-sort's auto gate at 210 Mbp
# --------------------------------------------------------------------------

BIG_GENOME_LEN = 210_000_000


def big_genome_main() -> int:
    """A 210 Mbp genome from the seed, indexed by the port's index_build
    (build/big_genome, kept between runs of one checkout), then the
    24,576 x 150 bp SE reads through `mem` with BWA_TPU_TRIP_SORT unset
    (auto sorts at l_pac >= 200 Mbp, so K8 launches once) and with off, in
    turns auto, off, auto, off, every SAM equal.  Prints the index build's
    seconds, each phase's wall and K1 launches (longest lane's steps,
    event ms), K8 against its plain version, and a fresh process's first
    K8 launch at this genome, whole and split (first_launch_main)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    from bwa_tpu_torch.index.build import index_build
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.native.build import get_lib
    from bwa_tpu_torch.ops import cuda_kernels

    card_line = (smi("--query-gpu=name,power.limit") or ["(no nvidia-smi)"])[0]
    get_lib()
    cuda_kernels.build_all()
    d = REPO / "build" / "big_genome"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 20)
    codes = rng.integers(0, 4, BIG_GENOME_LEN).astype(np.uint8)
    fa = d / "big210.fa"
    t0 = time.perf_counter()
    if not (d / "big210.fa.sa").exists():
        seq = np.frombuffer(b"ACGT", np.uint8)[codes]
        lines = np.concatenate(
            [seq[:len(seq) // 70 * 70].reshape(-1, 70),
             np.full((len(seq) // 70, 1), ord("\n"), np.uint8)], axis=1)
        with open(fa, "wb") as f:
            f.write(b">synthetic_210m\n" + lines.tobytes()
                    + seq[len(seq) // 70 * 70:].tobytes() + b"\n")
        del seq, lines
        index_build(str(fa))
    index_s = time.perf_counter() - t0
    fm = FMIndex.load(str(fa))
    log(f"210 Mbp index built in {index_s:.1f} s (l_pac={fm.l_pac})")
    if fm.l_pac < 200_000_000:
        fail(f"l_pac {fm.l_pac} is below trip-sort's auto gate")
    # a cold process's first K8 launch at this genome, whole and in parts
    first = [first_launch(variant, ["--big"])
             for variant in ("direct", "torch_first", "split")]
    reads = simulate(codes, 24576, 150, SEED + 12, 0.005, 0.0002, "g")[0]
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.ops import fm_machine

    recs = {"K1": Recorder(fm_machine, "seed_machine",
                           keep=lambda out: out[2]),
            "K8": Recorder(fm_ops, "probe_breaks")}
    os.environ.pop("BWA_TPU_TRIP_SORT", None)
    runs = []
    try:  # auto, off, auto, off: the walls in turns
        for i, mode in enumerate(("auto", "off", "auto", "off")):
            name = "mem_se_big_genome" + ("_off" if mode == "off" else "") \
                + ("_2" if i > 1 else "")
            with env_set(**({"BWA_TPU_TRIP_SORT": "off"} if mode == "off"
                             else {})):
                runs.append(main_path(d, str(fa), name, reads, [], recs))
    finally:
        for r in recs.values():
            r.restore()
    info = runs[0][0]
    info.update(index_build_seconds=index_s, genome_len=BIG_GENOME_LEN,
                l_pac=int(fm.l_pac))
    for (ph, sam), want_k8 in zip(runs, (1, 0, 1, 0)):
        ph["k1_launches"] = k1_steps(recs["K1"], ph["phase"])
        print(json.dumps(ph), flush=True)
        same_sam(ph["phase"], sam, runs[1][1], "mem_se_big_genome_off's")
        if ph["launches"]["K8"] != want_k8 or ph["launches"]["K1"] < 1:
            fail(f"{ph['phase']}: launches {ph['launches']}: auto should "
                 f"launch K8 once, off never")
    k8 = check_k8(recs["K8"], "mem_se_big_genome")
    print(json.dumps(dict(k8_big_genome=k8)), flush=True)
    for f in first:
        print(json.dumps(f), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --------------------------------------------------------------------------
# --seed-bench: K8 and K1's refill mode alone; a cold process's first launch
# --------------------------------------------------------------------------

SEED_BENCH_LANES = ((12288, 96), (1024, 600))  # (lanes, cap_s), step 4d's
# (lanes, stack cap) of --switch: the refill route's lane counts (12,288 at
# L <= 256, 6,144 at 512, 3,072 at 1,024; fewer reads: a power of two from
# 256) at its ladder's stack caps
SWITCH_SWEEP = ((1024, 16), (2048, 16), (2560, 16), (3072, 16), (4096, 16),
                (6144, 16), (12288, 16), (3072, 32), (6144, 32), (12288, 32),
                (3072, 64), (6144, 64), (12288, 64))


def seed_inputs(big=False, table=True):
    """The smoke genome's index on the card (the engine's tree, occtab R =
    4), step 4d's 24,576 x 150 bp reads as K8 gets them (_pad_reads: 192
    columns) and their refill table (or None), the index's FASTA; with
    big, the 210 Mbp genome that --big-genome built and its reads."""
    import numpy as np
    import torch

    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.mem.batch_seed import _pad_reads
    from bwa_tpu_torch.ops.fm import BatchedFMEngine, _refill_table

    if big:
        fa = REPO / "build" / "big_genome" / "big210.fa"
        if not (REPO / "build" / "big_genome" / "big210.fa.sa").exists():
            fail("--big needs the index that --big-genome builds")
        codes = np.random.default_rng(SEED + 20).integers(
            0, 4, BIG_GENOME_LEN).astype(np.uint8)
    else:
        d = REPO / "build" / "smoke"
        d.mkdir(parents=True, exist_ok=True)
        fa, codes = make_genome(d)
    reads = simulate(codes, 24576, 150, SEED + 12, 0.005, 0.0002,
                     "g" if big else "t")[0]
    q, ql, _ = _pad_reads([r for _, r in reads])
    idx = BatchedFMEngine(FMIndex.load(str(fa)), "cuda").idx
    qd, qld = torch.from_numpy(q).cuda(), torch.from_numpy(ql).cuda()
    return idx, qd, qld, _refill_table(qd, qld) if table else None, fa


def coord_tree(idx, coords):
    """The tree as is, or as the 2*l_pac+2 >= 2^31 code path takes it."""
    import torch

    return idx if coords == "int32" else dict(idx, cdt=torch.int64,
                                              L2=idx["L2"].long())


def refill_args(idx, table, lanes, cap_s, cap=16):
    """K1's refill mode as mem_se_refill launches it: mem's default
    options, stack cap `cap` (16; the ladder's 32 and 64), a read's share
    cap_r = 24 of a lane's store."""
    from bwa_tpu_torch.options import MemOptions

    opt = MemOptions()
    return ((idx, table, lanes, opt.min_seed_len,
             int(opt.min_seed_len * opt.split_factor + 0.499),
             opt.split_width, opt.max_mem_intv),
            dict(cap=cap, cap_s=cap_s, use_p3=bool(opt.max_mem_intv > 0),
                 cap_r=24))


def seed_attrs(nw, L, cap=16):
    """Step 0 of the seed kernels: registers, shared and local bytes and
    occupancy of K1, its refill mode and K8 at both coordinate types."""
    from bwa_tpu_torch.ops import cuda_kernels

    return {f"{k} {c}": cuda_kernels.seed_kernel_attrs(k, c == "int64", nw,
                                                       cap, L)
            for k in cuda_kernels.SEED_KERNELS[:3]
            for c in ("int32", "int64")}


def seed_bench_main(argv) -> int:
    """K8 and K1's refill mode alone at step 4d's shapes, on the tree of
    --root DIR (a checkout of another commit) or this one: the kernels'
    registers and occupancy (where the tree exports them), K8 at int32
    and int64 coordinates (20 launches each, equal to the plain version),
    the refill mode at 12,288 and 1,024 lanes at both, in the form the
    route picks and in each form (5 launches each; reads drawn, lane
    steps); then, with --first-launch, fresh processes
    that time a process's first K8 launch whole and split into its parts.
    With --switch, instead of K8 and those launches: both refill forms at
    each (lanes, stack cap) of SWITCH_SWEEP, with the route's seed store
    (_se_flat_refill's cs_tot) and its pick (refill_group_form), at both
    coordinate types.  One JSON line each."""
    root = Path(argv[argv.index("--root") + 1]).resolve() \
        if "--root" in argv else REPO
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    from bwa_tpu_torch.ops import cuda_kernels
    from bwa_tpu_torch.ops import fm as fm_ops
    from bwa_tpu_torch.ops import fm_machine as fmm

    card = (smi("--query-gpu=name,power.limit") or ["(no nvidia-smi)"])[0]
    t0 = time.perf_counter()
    cuda_kernels.build_all()
    big = "--big" in argv
    idx, q, ql, table, fa = seed_inputs(big)
    head = dict(card=card, root=str(root), genome=fa.name,
                setup_s=time.perf_counter() - t0)
    for ln in cuda_kernels.build_log.get("seed_machine.cu", "").splitlines():
        log(f"ptxas {ln.strip()}")  # registers and spills of each kernel
    print(json.dumps(dict(seed_bench=head)), flush=True)
    nw = int(idx["occtab"].shape[1] - 4)
    if hasattr(cuda_kernels, "seed_kernel_attrs"):
        print(json.dumps(dict(attrs=seed_attrs(nw, q.shape[1]))), flush=True)
    if "--switch" in argv:
        return refill_switch(idx, table)
    for coords in ("int32", "int64"):
        t = coord_tree(idx, coords)
        got = fm_ops.probe_breaks(t, q, ql)
        want, plain_ms = timed_once(lambda: fm_ops.probe_breaks_plain(t, q))
        print(json.dumps(dict(k8=dict(
            coords=coords, ms=cuda_time(
                lambda: fm_ops.probe_breaks(t, q, ql), 20),
            equal=bool(torch.equal(got, want)), breaks=int(want.sum()),
            plain_ms=plain_ms))), flush=True)
    forms = ((None, False, True) if "group" in inspect.signature(
        fmm.seed_machine_refill).parameters else (None,))
    for coords in () if big else ("int32", "int64"):
        t = coord_tree(idx, coords)
        for lanes, cap_s in SEED_BENCH_LANES:
            for group in forms:  # as the route picks it, then each form
                a, kw = refill_args(t, table, lanes, cap_s)
                if group is not None:
                    kw["group"] = group
                out, once = timed_once(
                    lambda: fmm.seed_machine_refill(*a, **kw))
                print(json.dumps(dict(refill=dict(
                    coords=coords, lanes=lanes, cap_s=cap_s,
                    form={None: "route", False: "warp",
                          True: "group"}[group], first_ms=once,
                    ms=cuda_time(lambda: fmm.seed_machine_refill(*a, **kw),
                                 5),
                    n_drawn=min(int(out[5]), table.shape[0]),
                    longest_lane_steps=int(out[2]),
                    lane_steps=int(out[4].to(torch.int64).sum())))),
                    flush=True)
    if "--first-launch" in argv:
        for variant in ("direct", "torch_first") + (
                ("split",) if hasattr(cuda_kernels, "seed_noop") else ()):
            print(json.dumps(first_launch(
                variant, ["--root", str(root)] + (["--big"] if big else []))),
                flush=True)
    return 0


def refill_switch(idx, table) -> int:
    """seed_bench_main --switch: both refill forms at SWITCH_SWEEP."""
    import torch

    from bwa_tpu_torch.ops import fm_machine as fmm

    n, L = table.shape[0], (table.shape[1] - 2) // 2
    for coords in ("int32", "int64"):
        t = coord_tree(idx, coords)
        for lanes, cap in SWITCH_SWEEP:
            # the ladder doubles the store at cap 32 and quadruples that at 64
            cap_s = max(4 * 24, (-(-n // lanes) + 1) * 24) * \
                {16: 1, 32: 2, 64: 8}[cap]
            a, kw = refill_args(t, table, lanes, cap_s, cap)
            row = dict(coords=coords, lanes=lanes, cap=cap, cap_s=cap_s,
                       route="group" if fmm.refill_group_form(t, lanes, cap, L)
                       else "warp")
            for form in ("warp", "group"):
                k = dict(kw, group=form == "group")
                out = fmm.seed_machine_refill(*a, **k)
                row[form] = dict(
                    ms=cuda_time(lambda: fmm.seed_machine_refill(*a, **k), 5),
                    n_drawn=min(int(out[5]), n),
                    longest_lane_steps=int(out[2]),
                    lane_steps=int(out[4].to(torch.int64).sum()))
            print(json.dumps(dict(switch=row)), flush=True)
    return 0


def first_launch(variant, extra):
    """first_launch_main's line from a fresh process."""
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--first-launch", variant, *extra],
                       capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"--first-launch {variant}: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def first_launch_main(argv) -> int:
    """A fresh process's first K8 launch on the smoke genome's tree (or,
    with --big, the 210 Mbp one), after the index is on the card and the
    reads uploaded: `direct` launches K8 first; `torch_first` runs one of
    PyTorch's own kernels before it; `split` also reads K8's attributes
    (which loads the module's kernel), launches the module's empty kernel
    and then K8 on one read before it.  Each part timed by the host clock
    to a synchronize, the K8 launches also by CUDA events.  One JSON
    line."""
    variant = argv[1]
    root = Path(argv[argv.index("--root") + 1]).resolve() \
        if "--root" in argv else REPO
    sys.path.insert(0, str(root))
    import torch

    from bwa_tpu_torch.ops import cuda_kernels
    from bwa_tpu_torch.ops import fm as fm_ops

    t0 = time.perf_counter()
    cuda_kernels.build_all()  # loads the .so files: no module is loaded yet
    # copies only: no kernel of PyTorch's or the port's runs before K8
    idx, q, ql, _, fa = seed_inputs("--big" in argv, table=False)
    torch.cuda.synchronize()
    res = dict(variant=variant, genome=str(fa.name),
               occtab_bytes=int(idx["occtab"].numel() * 4),
               setup_s=time.perf_counter() - t0)

    def wall(fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    if variant in ("torch_first", "split"):
        res["torch_kernel_ms"] = wall(
            lambda: torch.ones(1, device="cuda").add_(1))
    if variant == "split":
        nw = int(idx["occtab"].shape[1] - 4)
        res["attrs_ms"] = wall(lambda: cuda_kernels.seed_kernel_attrs(
            "K8", idx["cdt"] == torch.int64, nw, 16, q.shape[1]))
        res["empty_kernel_ms"] = wall(cuda_kernels.seed_noop)
        res["empty_kernel_2_ms"] = wall(cuda_kernels.seed_noop)
        # K8 itself on one read: a first launch that touches a row or two
        res["k8_one_read_ms"] = wall(
            lambda: fm_ops.probe_breaks(idx, q[:1], ql[:1]))
    for n in ("first", "second"):
        t = time.perf_counter()
        _, ev = timed_once(lambda: fm_ops.probe_breaks(idx, q, ql))
        res[f"k8_{n}_event_ms"] = ev
        res[f"k8_{n}_wall_ms"] = (time.perf_counter() - t) * 1e3
    print(json.dumps(dict(first_launch=res)), flush=True)
    return 0


# --------------------------------------------------------------------------
# 4c. the resident daemon and shm on the card
# --------------------------------------------------------------------------

def smi(query: str) -> list[str]:
    """nvidia-smi's csv rows for a query (none where there is no
    nvidia-smi: a rehearsal on the CPU)."""
    if shutil.which("nvidia-smi") is None:
        return []
    r = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                       capture_output=True, text=True)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def daemon_memory(pid: int) -> dict:
    """The daemon's card memory: its row of nvidia-smi's compute processes
    (null when that list does not show this pid namespace's pids), every
    row, and the card's whole memory.used (the daemon's share is its
    change from card_used_before_daemon)."""
    rows = smi("--query-compute-apps=pid,used_memory")
    mine = [r.split(",", 1)[1].strip() for r in rows
            if r.split(",", 1)[0].strip() == str(pid)]
    return dict(smi_used=mine[0] if mine else None, smi_rows=rows,
                card_used=(smi("--query-gpu=memory.used") or [None])[0])


def daemon_log_done(log: Path, n_done: int) -> dict:
    """The daemon's n_done-th "done" line (1-based): seconds, launches and
    the torch allocator's MiB after the request."""
    done = [ln for ln in log.read_text().splitlines()
            if ln.startswith("[daemon] done ")]
    if len(done) < n_done:
        fail(f"daemon: {len(done)} requests logged, expected {n_done}")
    ln = done[n_done - 1]
    launches = json.loads(ln.split("launches=", 1)[1].split("}", 1)[0] + "}")
    kv = dict(t.split("=", 1) for t in ln.split() if "=" in t
              and not t.startswith("launches="))
    return dict(rc=int(kv["rc"]), daemon_seconds=float(kv["seconds"]),
                launches=launches,
                **{k: float(kv[k]) if k in kv else None
                   for k in ("allocated_mib", "reserved_mib")})


def start_daemon(d: Path, prefix: str, sockdir: Path, device: str):
    """`daemon start` on the device in a fresh process (every warm stage);
    waits for its ping.  Returns (process, env, log path, seconds from
    Popen to the ping)."""
    from bwa_tpu_torch import server

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BWA_TPU_") or k == "BWA_TPU_SHM_DIR"}
    env.update(BWA_TPU_DAEMON_DIR=str(sockdir), PYTHONPATH=str(REPO))
    dlog = d / "daemon.log"
    t0 = time.perf_counter()
    with open(dlog, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bwa_tpu_torch.cli", "daemon", "start",
             "--device", device, prefix], cwd=REPO, env=env, stderr=err)
    os.environ["BWA_TPU_DAEMON_DIR"] = str(sockdir)
    try:
        while not server.daemon_available(prefix):
            if proc.poll() is not None:
                fail(f"daemon exited {proc.returncode} before its ping: "
                     f"{dlog.read_text()[-3000:]}")
            if time.perf_counter() - t0 > 600:
                # its stacks into its log (faulthandler on SIGUSR1), then
                # stop it: no process of the smoke outlives a failure
                proc.send_signal(signal.SIGUSR1)
                time.sleep(2)
                proc.kill()
                proc.wait()
                fail(f"daemon: no ping after 600 s: "
                     f"{dlog.read_text()[-6000:]}")
            time.sleep(0.1)
    finally:
        os.environ.pop("BWA_TPU_DAEMON_DIR")
    return proc, env, dlog, time.perf_counter() - t0


def client(args, env, native=False, **extra):
    """One command through the Python client (python3 -m bwa_tpu_torch.cli)
    or the native one (client_exe()): (result, wall seconds)."""
    from bwa_tpu_torch.native.build import client_exe

    cmd = ([str(client_exe())] if native
           else [sys.executable, "-m", "bwa_tpu_torch.cli"])
    t0 = time.perf_counter()
    r = subprocess.run([*cmd, *map(str, args)], capture_output=True,
                       cwd=REPO, env=dict(env, BWA_TPU_PYTHON=sys.executable,
                                          **extra), timeout=600)
    return r, time.perf_counter() - t0


def daemon_phase(d: Path, prefix: str, device: str = "cuda") -> dict:
    """Step 4c: the daemon serves the smoke's own inputs on the card (or
    the given device: "cpu" rehearses the phase without one), each
    output equal to the main process's local one (written by main_path and
    aln_phase), through the Python and the native client; the cold one-shot
    beside the forward; stop; then shm staging and a mem on the attached
    index."""
    fa = prefix
    # a unix socket's path holds at most 107 bytes: the temporary
    # directory, or the smoke's own where that one's path is too long
    room = 107 - len("/engine-0123456789abcdef.sock")
    sockdir = Path(tempfile.mkdtemp(prefix="btd"))
    if len(str(sockdir)) > room:
        sockdir.rmdir()
        sockdir = Path(tempfile.mkdtemp(prefix="btd", dir=d))
        if len(str(sockdir)) > room:
            sockdir.rmdir()
            fail(f"daemon: no socket directory within {room} bytes "
                 f"(TMPDIR and {d} are too long)")
    card_before = (smi("--query-gpu=memory.used") or [None])[0]
    proc, env, dlog, start_s = start_daemon(d, fa, sockdir, device)
    info = dict(phase="daemon", card_used_before_daemon=card_before,
                start_to_ping_s=start_s, warm_s={})
    try:
        for ln in dlog.read_text().splitlines():
            if " warm in " in ln:
                tag, s = ln[len("[daemon] "):].split(" warm in ")
                info["warm_s"][tag] = float(s.rstrip("s"))
            if ln.startswith("[daemon] warm") and "reserved_mib" in ln:
                info["after_warm_reserved_mib"] = float(
                    ln.split("reserved_mib=")[1])
        if sorted(info["warm_s"]) != ["PE", "SE", "aln", "fastmap",
                                      "pacbio"]:
            fail(f"daemon: warm stages {sorted(info['warm_s'])}")
        info["after_warm_memory"] = daemon_memory(proc.pid)
        log(f"daemon up in {start_s:.3f} s, warm {info['warm_s']}, reserved "
            f"{info.get('after_warm_reserved_mib')} MiB, card "
            f"{card_before} before it, {info['after_warm_memory']}")
        fq = lambda name: d / f"{name}.fq"
        sai = d / "aln_se_100bp.sai"
        dev = ["--device", device]
        reqs = [("mem_se_150bp", ["mem", *dev, fa, fq("mem_se_150bp")], {},
                 "sam"),
                # the client's seeding switch applies in the daemon: K8
                ("mem_se_150bp_tripsort", ["mem", *dev, fa,
                                           fq("mem_se_150bp")],
                 {"BWA_TPU_TRIP_SORT": "force"}, "sam"),
                ("mem_pe_150bp", ["mem", *dev, fa, fq("mem_pe_150bp"),
                                  fq("mem_pe_150bp_2")], {}, "sam"),
                ("mem_pacbio", ["mem", "-x", "pacbio", *dev, fa,
                                fq("mem_pacbio")], {}, "sam"),
                # and the tail-compaction route's switch: K13
                ("mem_se_150bp_compact", ["mem", *dev, fa,
                                          fq("mem_se_150bp")],
                 {"BWA_TPU_SEED_COMPACT": "1"}, "sam"),
                ("fastmap_150bp", ["fastmap", *dev, fa, fq("fastmap_150bp")],
                 {}, "text"),
                ("aln_se_100bp", ["aln", *dev, fa, fq("aln_se_100bp")],
                 {"BWA_TPU_ALN": "device"}, "sai"),
                ("samse_100bp", ["samse", fa, sai, fq("aln_se_100bp")], {},
                 "samse")]
        # a route's request answers as the default route's local run
        local = lambda ph: ph.removesuffix("_tripsort").removesuffix(  # noqa
            "_compact")
        want = {"sam": lambda ph: records_of(
                    (d / f"{local(ph)}.out").read_text()),
                "text": lambda ph: (d / f"{ph}.out").read_text(),
                "sai": lambda ph: sai.read_bytes(),
                "samse": lambda ph: records_of(
                    (d / "aln_se_100bp.sam").read_text())}
        got_of = {"sam": lambda b: records_of(b.decode()),
                  "text": lambda b: b.decode(), "sai": lambda b: b,
                  "samse": lambda b: records_of(b.decode())}
        n_done = 0
        info["requests"] = []
        # launches each request must show in the daemon (its wrappers
        # count only the card's kernels)
        need = {"mem_se_150bp": ("K1",),
                "mem_se_150bp_tripsort": ("K1", "K8"),
                "mem_se_150bp_compact": ("K13",),
                "mem_pe_150bp": ("K1",),
                "mem_pacbio": ("K1", "K2"), "fastmap_150bp": ("K1",),
                "aln_se_100bp": ("K7", "K7w"), "samse_100bp": ()}
        if device != "cuda":
            need = {}
        for native in (False, True):
            for ph, args, extra, kind in reqs:
                if native and ph not in ("mem_se_150bp", "aln_se_100bp"):
                    continue
                r, wall = client(args, env, native, **extra)
                n_done += 1
                if r.returncode != 0:
                    fail(f"daemon: {ph} through the "
                         f"{'native' if native else 'Python'} client "
                         f"exited {r.returncode}: {r.stderr[-2000:]}")
                if not native and b"forwarding to the resident engine " \
                        b"daemon" not in r.stderr:
                    fail(f"daemon: {ph} was not forwarded: "
                         f"{r.stderr[-2000:]}")
                if got_of[kind](r.stdout) != want[kind](ph):
                    fail(f"daemon: {ph}'s forwarded output differs from the "
                         f"main process's")
                req = dict(phase=ph, client="native" if native else "python",
                           wall_s=wall, equal_local=True,
                           **daemon_log_done(dlog, n_done),
                           memory=daemon_memory(proc.pid))
                for k in need.get(ph, ()):
                    if req["launches"][k] < 1:
                        fail(f"daemon: {ph} launched no {k} in the daemon")
                if need and req["launches"]["K8"] != ("K8" in need.get(ph, ())):
                    fail(f"daemon: {ph} launched K8 "
                         f"{req['launches']['K8']} times in the daemon")
                info["requests"].append(req)
                log(f"daemon request {req}")
        # the cold one-shot of the same mem SE command: interpreter, torch,
        # CUDA context, kernel loads, index load and upload
        r, wall = client(reqs[0][1], env, BWA_TPU_NO_DAEMON="1")
        if r.returncode != 0 or b"forwarding" in r.stderr \
                or records_of(r.stdout.decode()) != want["sam"](
                    "mem_se_150bp"):
            fail(f"daemon: the cold one-shot failed or differs: "
                 f"{r.stderr[-2000:]}")
        info["cold_one_shot_mem_se_s"] = wall
        log(f"daemon: cold one-shot mem SE {wall:.3f} s")
        # a bogus input gives a non-zero exit through both clients, and the
        # daemon serves on
        bogus = d / "bogus.sai"
        bogus.write_bytes(b"not a sai file\n")
        r1, _ = client(["samse", fa, bogus, fq("aln_se_100bp")], env)
        se = fq("mem_se_150bp")
        r2, _ = client(["mem", *dev, fa, se, se, se], env, native=True)
        if r1.returncode == 0 or r2.returncode == 0:
            fail(f"daemon: a bogus request exited {r1.returncode} (Python "
                 f"client), {r2.returncode} (native client)")
        info["bogus_exit_codes"] = [r1.returncode, r2.returncode]
        if proc.poll() is not None:
            fail(f"daemon died after the bogus requests: "
                 f"{dlog.read_text()[-2000:]}")
        r, _ = client(["daemon", "stop", fa], env)
        rc = proc.wait(timeout=120)
        if r.returncode != 0 or rc != 0 or list(sockdir.glob("*.sock")):
            fail(f"daemon stop: client {r.returncode}, daemon exit {rc}, "
                 f"sockets left {list(sockdir.glob('*.sock'))}")
        info["stop_exit_code"] = rc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(sockdir, ignore_errors=True)
    info["shm"] = shm_phase(d, fa, env, device)
    return info


def shm_phase(d: Path, fa: str, env: dict, device: str) -> dict:
    """Stage the smoke index with shm, run mem SE on the card against the
    attached index (the SAM must equal the disk-loaded run's), time the
    index load and its upload both ways, destroy the staging."""
    import torch

    from bwa_tpu_torch import shm
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex, FMIndex

    root = d / "shm"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log(f"shm: staging under {root}")
    env = dict(env, BWA_TPU_SHM_DIR=str(root), BWA_TPU_NO_DAEMON="1")
    info = dict(shm_dir=str(root))
    try:
        r, info["stage_s"] = client(["shm", fa], env)
        if r.returncode != 0:
            fail(f"shm staging exited {r.returncode}: {r.stderr[-2000:]}")
        r, info["mem_se_wall_s"] = client(
            ["mem", "--device", device, fa, d / "mem_se_150bp.fq"], env)
        if r.returncode != 0 or b"[M::bwa_idx_load_from_shm]" not in r.stderr:
            fail(f"shm: mem did not attach the staged index: "
                 f"{r.stderr[-2000:]}")
        if records_of(r.stdout.decode()) != records_of(
                (d / "mem_se_150bp.out").read_text()):
            fail("shm: mem's SAM on the attached index differs from the "
                 "disk-loaded run's")
        info["equal_disk_loaded"] = True
        saved = os.environ.get("BWA_TPU_SHM_DIR")
        os.environ["BWA_TPU_SHM_DIR"] = str(root)
        try:
            for way, load in (("disk", FMIndex.load_from_disk),
                              ("shm", shm.shm_attach)):
                t0 = time.perf_counter()
                fm = load(fa)
                t1 = time.perf_counter()
                DeviceFMIndex(fm, device=device)
                if device == "cuda":
                    torch.cuda.synchronize()
                info[f"load_{way}_s"] = t1 - t0
                info[f"load_and_upload_{way}_s"] = time.perf_counter() - t0
        finally:
            if saved is None:
                os.environ.pop("BWA_TPU_SHM_DIR")
            else:
                os.environ["BWA_TPU_SHM_DIR"] = saved
        r, _ = client(["shm", "-d"], env)
        if r.returncode != 0:
            fail(f"shm -d exited {r.returncode}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"shm {info}")
    return info


def bound(nbytes, ops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --------------------------------------------------------------------------

def main(argv) -> int:
    if argv[:1] == ["--refill-plain"]:  # of start_refill_host_plain
        return refill_plain_host(*argv[1:3])
    if argv[:1] == ["--k1-plain"]:  # a subprocess of start_k1_host_plain
        return k1_plain_host(*argv[1:3])
    if argv[:1] == ["--aln-ladder"]:  # a subprocess of start_aln_ladder
        return aln_ladder_main(*argv[1:4])
    if argv[:1] == ["--k7-plain"]:  # a subprocess of start_k7_host_plain
        return k7_plain_host(*argv[1:3])
    if argv[:1] == ["--aln-chunk"]:
        return aln_chunk_main()
    if argv[:1] == ["--k7-bench"]:
        return k7_bench_main()
    if argv[:1] == ["--big-genome"]:
        return big_genome_main()
    if argv[:1] == ["--seed-bench"]:
        return seed_bench_main(argv)
    if argv[:1] == ["--first-launch"]:
        return first_launch_main(argv)
    log_dir = None
    if "--log" in argv:
        log_dir = Path(argv[argv.index("--log") + 1])
        log_dir.mkdir(parents=True, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    try:
        import bwa_tpu_torch  # noqa: F401
    except ImportError:
        fail("bwa_tpu_torch not found: run from the repository root")
    from bwa_tpu_torch.native.build import get_lib
    from bwa_tpu_torch.ops import cuda_kernels

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]

    # 1. builds: native g++ in a thread, every nvcc at once
    errs = []

    def native():
        try:
            get_lib()
        except BaseException as e:  # reported below
            errs.append(e)

    th = threading.Thread(target=native)
    th.start()
    t0 = time.perf_counter()
    cuda_kernels.build_all()
    th.join()
    if errs:
        fail(f"native build failed: {errs[0]}")
    build_s = time.perf_counter() - t0
    log(f"kernels and native library built in {build_s:.1f} s")
    # step 0 of K1, its refill mode and K8 at step 4d's launches (occtab R =
    # 4, stack cap 16, 192 codes a read)
    attrs = seed_attrs(32, 192)
    log(f"seed kernels' registers and occupancy {attrs}")
    if log_dir:
        (log_dir / "nvcc_build.log").write_text(
            "\n".join(f"== {k}\n{v}" for k, v in
                      cuda_kernels.build_log.items()))

    # 2. genome, index, reads; the CPU runs of each SE phase's first 64
    # reads and of the first 256 pairs
    d = REPO / "build" / "smoke"
    d.mkdir(parents=True, exist_ok=True)
    # every index load (here, in the daemon and in each client) looks for
    # a shm staging in the checkout's own directory, not the host's
    # /dev/shm registry, which another checkout may have filled
    os.environ["BWA_TPU_SHM_DIR"] = str(d / "shm")
    t0 = time.perf_counter()
    fa, codes = make_genome(d)
    from bwa_tpu_torch.index.fmindex import FMIndex

    fm = FMIndex.load(str(fa))
    log(f"genome + index ready in {time.perf_counter() - t0:.1f} s "
        f"(l_pac={fm.l_pac}, occtab R={'4' if fm.words.shape[0] > 65536 else '1'})")
    reads150, _ = simulate(codes, 4096, 150, SEED + 3, 0.005, 0.0002, "s")
    pb2k, org2k = simulate(codes, 512, 2000, SEED + 4, 0.05, 0.03, "p")
    pb10k, _ = simulate(codes, 32, 10000, SEED + 5, 0.05, 0.03, "q")
    pe1, pe2 = simulate_pairs(codes, 12288, 150, SEED + 6, 0.005, "f")
    w1100 = simulate(codes, 64, 2000, SEED + 7, 0.05, 0.03, "w")[0] \
        + simulate(codes, 4, 10000, SEED + 8, 0.05, 0.03, "x")[0] \
        + deletion_reads(codes, 2, SEED + 9, "d")
    # four 10 kb reads lead, so the CPU run of the first 64 takes the same
    # 10,048-base lanes and cap ladder as the card
    pacbio = pb10k[:4] + pb2k + pb10k[4:]
    # -x pacbio -5: two 10 kb reads lead (they climb to the lane-wide rung,
    # one read a lane); the CPU run takes the first 8
    pb5_reads = pb10k[:2] + pb2k[:64]
    aln_se, _ = simulate(codes, 65536, 100, SEED + 10, 0.02, 0.001, "a")
    aln_pe = simulate_pairs(codes, 16384, 100, SEED + 11, 0.02, "b")
    phases = (("mem_se_150bp", reads150, None, []),
              ("mem_pacbio", pacbio, None, ["-x", "pacbio"]),
              ("mem_pe_150bp", pe1, pe2, []))
    cpu, host, host5, ladder, k7_host, refill = {}, [], [], [], [], []
    hosts = []  # step 4e's multihost processes
    try:
        ladder.append(start_aln_ladder(d, str(fa), aln_se[:LADDER_READS]))
        for ph, reads, _, extra in phases[:2]:
            fq = d / f"{ph}_first64.fq"
            write_fastq(fq, reads[:64])
            cpu[ph] = start_cpu_run(d, str(fa), f"{ph}_first64", [fq],
                                    extra)
        cpu["mem_se_150bp_primary5"] = start_cpu_run(
            d, str(fa), "mem_se_150bp_primary5_first64",
            [d / "mem_se_150bp_first64.fq"], ["-5"])
        fq = d / "mem_pacbio_primary5_first8.fq"
        write_fastq(fq, pb5_reads[:8])
        cpu["mem_pacbio_primary5"] = start_cpu_run(
            d, str(fa), "mem_pacbio_primary5_first8", [fq],
            ["-x", "pacbio", "-5"])
        pe256 = [d / "mem_pe_first256_1.fq", d / "mem_pe_first256_2.fq"]
        write_fastq(pe256[0], pe1[:256])
        write_fastq(pe256[1], pe2[:256])
        cpu["mem_pe_first256"] = start_cpu_run(d, str(fa), "mem_pe_first256",
                                               pe256, [])

        # 3. parity on the card
        t0 = time.perf_counter()
        k1_par = k1_parity(fm, reads150, pb2k)
        k2_par = k2_parity(fm, pb2k, org2k)
        entry_par = entry_parity()
        log(f"parity done in {time.perf_counter() - t0:.1f} s")

        # 4. main path, with every kernel call recorded
        from bwa_tpu_torch.ops import ext_gather, fm_machine

        recs = {"K1": Recorder(fm_machine, "seed_machine",
                               keep=lambda out: out[2]),
                "K2": Recorder(ext_gather, "ksw_band_side",
                               keep=k2_longest)}
        ran = [main_path(d, str(fa), ph, reads, extra, recs, reads2)
               for ph, reads, reads2, extra in phases]
        # -w 1100: K2's wide path (P = 2304, retry 4480); only K2's calls
        # are recorded (K1's are those of the pacbio phase)
        recs["K1"].restore()
        phase_w, sam_w = main_path(d, str(fa), "mem_pacbio_w1100", w1100,
                                   ["-x", "pacbio", "-w", "1100"],
                                   {"K2": recs["K2"]})
        recs["K2"].restore()
        wide = [i for i, (ph, a, k) in enumerate(recs["K2"].calls)
                if ph == "mem_pacbio_w1100"]
        bands = [(recs["K2"].calls[i][2].get("P", recs["K2"].calls[i][1][-1]),
                  int(recs["K2"].kept[i])) for i in wide]
        if not wide or min(P for P, _ in bands) <= 1024 \
                or not any(P == 4480 and rows for P, rows in bands):
            fail(f"mem_pacbio_w1100: K2 launches (P, longest rows) {bands}: "
                 f"not all on the wide path, or no live retry at P = 4480")
        check_w1100(str(fa), fm, d / "mem_pacbio_w1100.fq", phase_w, sam_w)
        (phase_se, sam_se), (phase_pb, sam_pb), (phase_pe, _) = ran
        for name, ph in (("K1", phase_se), ("K1", phase_pb),
                         ("K2", phase_pb), ("K1", phase_pe), ("K1", phase_w),
                         ("K2", phase_w)):
            if ph["launches"][name] < 1:
                fail(f"{ph['phase']}: kernel {name} was not launched")
        for ph in (phase_se, phase_pe):
            if ph["launches"]["K2"] != 0:
                fail(f"{ph['phase']} launched K2 (150 bp extension should "
                     f"stay on the host)")
        for name, r in recs.items():
            if not r.calls:
                fail(f"the main path did not reach the {name} wrapper")
        pe_info, pe_sam = check_pe256(d, str(fa), fm, pe256,
                                      cpu["mem_pe_first256"])

        # 4a. the Python mem route (-5, BWA_TPU_FINALIZE=python) and fastmap
        new_phases, k1_new, rec_new, new_s, sam_pb5 = \
            python_and_fastmap_phases(d, str(fa), fm, reads150, sam_se,
                                      pb5_reads, (pe1, pe2), pe_sam,
                                      cpu["mem_se_150bp_primary5"])
        # the -5 lane-wide rung's plain version, on the host meanwhile
        lane_wide5 = k1_lane_wide(rec_new, "mem_pacbio_primary5")
        host5 += start_k1_host_plain(d, rec_new, lane_wide5, "k1_host_pb5")

        # 4d. trip-sorted packing (K8), K1's refill mode, main_mem's
        # reader/writer threads
        route_phases, k8, k1r, k1r_pending = seeding_route_phases(
            d, str(fa), codes, (pe1, pe2), sam_se)
        refill += [job for _, job, *_ in k1r_pending]

        # 4f. the split and compaction routes (K12, K13) on 4d's and 4a's
        # inputs, the cross-check programs (K9, K10, K11)
        phases_4f, rows_4f = seeding_route_kernels(d, str(fa), fm, reads150)
        # the plain version of K1's lane-wide pacbio rung, on the host from
        # here on (minutes of it; step 6 waits for it)
        lane_wide = k1_lane_wide(recs["K1"])
        host += start_k1_host_plain(d, recs["K1"], lane_wide)

        # 4b. aln: native and device search, samse and sampe; K7 and K7w
        # calls recorded
        from bwa_tpu_torch.aln import batch_search
        from bwa_tpu_torch.ops import gap_machine

        arecs = {"K7": Recorder(gap_machine, "gap_machine", keep=k7_keep),
                 "K7w": Recorder(gap_machine, "cal_width")}
        fallback = Counter(batch_search, "_host_fallback")
        t0 = time.perf_counter()
        fq_se = d / "aln_se_100bp.fq"
        write_fastq(fq_se, aln_se)
        fq_pe = [d / "aln_pe_100bp_1.fq", d / "aln_pe_100bp_2.fq"]
        write_fastq(fq_pe[0], aln_pe[0])
        write_fastq(fq_pe[1], aln_pe[1])
        phase_aln_se = aln_phase(d, str(fa), "aln_se_100bp", [fq_se], arecs,
                                 fallback)
        phase_aln_pe = aln_phase(d, str(fa), "aln_pe_100bp", fq_pe, arecs,
                                 fallback)
        for r in (*arecs.values(), fallback):
            r.restore()
        log(f"aln phases done in {time.perf_counter() - t0:.1f} s")
        k7_host.append(start_k7_host_plain(d, arecs["K7"]))

        # 4e. the mesh as the CLI's engine (step 4d's and 4b's inputs
        # against their single-device outputs), the dry run, two hosts
        mesh_ph, mesh_k1, mesh_k7 = mesh_phases(d, str(fa), hosts)
        k7_host += mesh_k7

        # 4c. the resident daemon on the card, serving the smoke's own
        # inputs through both clients; then shm
        t0 = time.perf_counter()
        phase_daemon = daemon_phase(d, str(fa))
        log(f"daemon and shm phases done in {time.perf_counter() - t0:.1f} "
            f"s")
        if log_dir:
            (log_dir / "daemon_phase.json").write_text(
                json.dumps(phase_daemon, indent=1))
            (log_dir / "daemon.log").write_bytes(
                (d / "daemon.log").read_bytes())

        # 5. the kernel entry point (K2 host-array mode and K5) through
        # bench_kernel at its three shapes
        from bwa_tpu_torch import bench_kernel

        t0 = time.perf_counter()
        zero_launches()
        bench = {(kind, shape): bench_kernel.run_shape(kind, *shape)
                 for shape in bench_kernel.SHAPES
                 for kind in bench_kernel.KERNELS}
        phase_entry = dict(phase="kernel_entry", launches=read_launches(),
                           seconds=time.perf_counter() - t0)
        for b in bench.values():
            print(json.dumps(b), flush=True)
        for name in ("K2 host-array", "K5"):
            if phase_entry["launches"][name] < 1:
                fail(f"kernel entry: {name} was not launched")
        entry_past = entry_wide()

        # 6. every recorded call against the plain version; times of the
        # first call of each kernel and of K1's lane-wide rung, whose plain
        # version runs on the host since step 4d
        t0 = time.perf_counter()
        k2 = time_k2(recs["K2"])
        # the wide path at the -w 1100 phase's first launch with a live job
        wide_i = next((i for i in wide if int(recs["K2"].kept[i])), wide[0])
        k2w = time_k2(recs["K2"], wide_i)
        for k, wide_phase in ((k2, False), (k2w, True)):
            k["launches_on_main_path"] = [
                x for x in k["launches_on_main_path"]
                if (x["phase"] == "mem_pacbio_w1100") == wide_phase]
        k2h = time_entry("band", bench)
        k5 = time_entry("full", bench)
        calls = {"K1": check_calls(recs["K1"], "K1", skip=(0, lane_wide)),
                 "K2": check_calls(recs["K2"], "K2", skip=(0, wide_i))}
        k1 = time_k1(recs["K1"], host)
        t0 = time.perf_counter()
        k7 = time_k7(arecs["K7"])
        k7["second_rung"] = wait_k7_host_plain(k7_host[0])
        k7["mesh_shard_checks"] = [wait_k7_host_plain(j)
                                   for j in k7_host[1:]]
        k1["mesh_shard_checks"] = mesh_k1
        k7["design"] = K7_DESIGN
        k7w = time_k7w(arecs["K7w"])
        k7w["design"] = K7W_DESIGN
        phase_ladder = wait_aln_ladder(ladder[0], str(fa))
        log(f"K7, K7w and the ladder checked in "
            f"{time.perf_counter() - t0:.1f} s")
        k1_wide5 = time_k1_call(rec_new, lane_wide5, 5, host5)
        if not k1_wide5["equal"]:
            fail("K1 disagrees with its plain version at "
                 "mem_pacbio_primary5's lane-wide rung")
        k1["one_read_lanes"] = dict(
            first_launches=k1_new, pacbio_primary5_lane_wide=k1_wide5,
            main_thread_seconds=new_s,
            launches=[dict(phase=ph, call=i, cap_s=kw["cap_s"],
                           lanes=int(a[1].shape[0]),
                           event_ms=rec_new.call_ms[i],
                           longest_lane_steps=int(rec_new.kept[i]))
                      for i, (ph, a, kw) in enumerate(rec_new.calls)])
        k1["err"] = max(k1["err"], k1_wide5["err"],
                        *(v["err"] for v in k1_new.values()))
        for name, k in (("K1", k1), ("K2", k2), ("K2 wide path", k2w),
                        ("K2 host-array", k2h), ("K5", k5)):
            if not k["equal"]:
                fail(f"{name} disagrees with its plain version at the main "
                     f"path's shape")
        log(f"main-path calls checked and timed in "
            f"{time.perf_counter() - t0:.1f} s")
        finish_refill(k1r, k1r_pending)
        for (info, sam), (_, reads, _, _) in zip(ran[:2], phases):
            check_first64(info, sam, cpu[info["phase"]],
                          {n for n, _ in reads[:64]})
        check_first64(new_phases[3], sam_pb5, cpu["mem_pacbio_primary5"],
                      {n for n, _ in pb5_reads[:8]})
        print(json.dumps(phase_pe), flush=True)
        print(json.dumps(phase_w), flush=True)
        for ph in (phase_aln_se, phase_aln_pe, phase_ladder, phase_daemon):
            print(json.dumps(ph), flush=True)
    finally:
        for proc, err, *_ in [*cpu.values(), *host, *host5, *ladder,
                              *k7_host, *refill, *hosts]:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            err.close()

    mains = (phase_se, phase_pb, phase_pe, phase_w, *new_phases,
             *route_phases, *phases_4f)
    # step 4e's runs on the mesh engine (and the dry run's)
    mesh_mains = tuple(p for p in mesh_ph if "launches" in p)
    # the warp form of the refill mode is K1's kernel; the group form its own
    for k, name in ((k1, "K1"), (k1r["warp"], "K1"),
                    (k1r["group"], "K1 refill"), (k8, "K8")):
        k["attrs"] = {c: attrs[f"{name} {c}"] for c in ("int32", "int64")}
    # each row's launches in one run's counts (the main path's phases, or
    # the daemon's requests): K2's warp path is its gather mode's launches
    # less the wide path's
    count = {"K1 seed_machine": lambda c: c["K1"],
             "K1 seed_machine refill mode, a warp a lane":
             lambda c: c["K1 refill"] - c["K1 refill group"],
             "K1 seed_refill, the refill mode's group form":
             lambda c: c["K1 refill group"],
             "K8 probe_breaks": lambda c: c["K8"],
             "K2 ksw_band": lambda c: c["K2"] - c["K2 wide"],
             "K2 ksw_band wide path (P > 1024)": lambda c: c["K2 wide"],
             "K2 ksw_band host-array mode": lambda c: c["K2 host-array"],
             "K5 ksw_full": lambda c: c["K5"], "K7 gap_machine":
             lambda c: c["K7"], "K7w cal_width": lambda c: c["K7w"],
             "K12a smem_machine, K1's state mode (split route passes 1, 2)":
             lambda c: c["K12a"],
             "K12b seed3_machine, K1's state mode (split route pass 3)":
             lambda c: c["K12b"],
             "K13 seed_machine_seg segments, K1's state mode (tail "
             "compaction)": lambda c: c["K13"],
             "K9 sa_batch": lambda c: c["K9"],
             "K10a smem1a_batch": lambda c: c["K10a"],
             "K10b seed_strategy1_batch": lambda c: c["K10b"],
             "K11 collect_intv_device": lambda c: c["K11"]}
    kernels = []
    for name, src, repl, k, par, n, checked in (
            ("K1 seed_machine", "bwa_tpu_torch/csrc/seed_machine.cu",
             "bwa_tpu/ops/fm_machine.py:369", k1, k1_par, mains,
             calls["K1"]),
            ("K1 seed_machine refill mode, a warp a lane",
             "bwa_tpu_torch/csrc/seed_machine.cu",
             "bwa_tpu/ops/fm_machine.py:369", k1r["warp"], None, mains,
             len(k1r["warp"]["main_path_checks"])),
            ("K1 seed_refill, the refill mode's group form",
             "bwa_tpu_torch/csrc/seed_machine.cu",
             "bwa_tpu/ops/fm_machine.py:369", k1r["group"], None, mains,
             len(k1r["group"]["main_path_checks"])),
            ("K8 probe_breaks", "bwa_tpu_torch/csrc/seed_machine.cu",
             "bwa_tpu/ops/fm.py:253", k8, None, mains, None),
            ("K2 ksw_band", "bwa_tpu_torch/csrc/ksw_band.cu",
             "bwa_tpu/ops/ksw_pallas.py:380", k2, k2_par, mains,
             calls["K2"]),
            ("K2 ksw_band wide path (P > 1024)",
             "bwa_tpu_torch/csrc/ksw_band.cuh",
             "bwa_tpu/ops/ksw_pallas.py:380", k2w, k2_par, mains, None),
            ("K2 ksw_band host-array mode", "bwa_tpu_torch/csrc/ksw_band.cu",
             "bwa_tpu/ops/ksw_pallas.py:622", k2h, entry_par,
             (phase_entry,), None),
            ("K5 ksw_full", "bwa_tpu_torch/csrc/ksw_full.cu",
             "bwa_tpu/ops/ksw_pallas.py:273", k5, entry_par,
             (phase_entry,), None),
            ("K7 gap_machine", "bwa_tpu_torch/csrc/gap_machine.cu",
             "bwa_tpu/ops/gap_machine.py:164", k7, None,
             (phase_aln_se, phase_aln_pe), None),
            ("K7w cal_width", "bwa_tpu_torch/csrc/gap_machine.cu",
             "bwa_tpu/ops/gap_machine.py:100", k7w, None,
             (phase_aln_se, phase_aln_pe), k7w["calls"]),
            ("K12a smem_machine, K1's state mode (split route passes 1, 2)",
             "bwa_tpu_torch/csrc/seed_machine.cu",
             "bwa_tpu/ops/fm_machine.py:93", rows_4f["K12a"], None, mains,
             None),
            ("K12b seed3_machine, K1's state mode (split route pass 3)",
             "bwa_tpu_torch/csrc/seed_machine.cu",
             "bwa_tpu/ops/fm_machine.py:733", rows_4f["K12b"], None, mains,
             None),
            ("K13 seed_machine_seg segments, K1's state mode (tail "
             "compaction)", "bwa_tpu_torch/csrc/seed_machine.cu",
             "bwa_tpu/ops/fm_machine.py:369", rows_4f["K13"], None, mains,
             None),
            ("K9 sa_batch", "bwa_tpu_torch/csrc/smem_batch.cu",
             "bwa_tpu/ops/fm.py:201", rows_4f["K9"], None, mains, None),
            ("K10a smem1a_batch", "bwa_tpu_torch/csrc/smem_batch.cu",
             "bwa_tpu/ops/fm.py:319", rows_4f["K10a"], None, mains, None),
            ("K10b seed_strategy1_batch", "bwa_tpu_torch/csrc/smem_batch.cu",
             "bwa_tpu/ops/fm.py:481", rows_4f["K10b"], None, mains, None),
            ("K11 collect_intv_device", "bwa_tpu_torch/csrc/smem_batch.cu",
             "bwa_tpu/ops/fm.py:589", rows_4f["K11"], None, mains, None)):
        b_ms, b_by = bound(k["bytes"], k["ops"])
        on_mesh = sum(count[name](p["launches"]) for p in mesh_mains)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=sum(count[name](p["launches"]) for p in n) + on_mesh,
            mesh_launches=on_mesh,
            # the daemon's own launches in step 4c (its wrappers' counts)
            daemon_launches=sum(count[name](r["launches"])
                                for r in phase_daemon["requests"]),
            max_abs_err=k["err"], tolerance=0, ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, timed_shape=k["shape"], parity=par,
            parity_at_main_shape=k["equal"], main_path_calls=checked,
            plain_shape=k.get("plain_shape"),
            entry_shapes=k.get("shapes"),
            work={kk: k[kk] for kk in ("bytes", "ops", "lane_steps",
                                       "occ_pair_steps", "walk_steps",
                                       "occ_pair_positions",
                                       "overflow_lanes",
                                       "longest_lane_steps", "ns_per_step",
                                       "extending_positions",
                                       "one_row_extensions", "breaks",
                                       "n_drawn", "extensions",
                                       "rows", "cells", "full_width_cells",
                                       "longest_rows", "ns_per_row")
                  if kk in k},
            **{kk: k[kk] for kk in ("pacbio_lane_wide",
                                    "launches_on_main_path",
                                    "main_path_checks", "small_check",
                                    "one_read_lanes", "design", "int64",
                                    "attrs", "mesh_shard_checks",
                                    "pass2_launch", "compaction_levels",
                                    "pacbio_refused", "kernel_ms",
                                    "busy_ms", "form",
                                    "reads_per_warp", "warps_per_block",
                                    "resident_reads", "lists", "other_form",
                                    "launches_by_form", "warp_form")
               if kk in k},
            **({"entry_past_4096": [
                e for e in entry_past
                if e["kernel"] == ("K5" if k is k5 else "K2 host-array")]}
               if k is k5 or k is k2h else {})))
    print(json.dumps(dict(
        build_seconds=build_s,
        launches_per_phase={p["phase"]: p["launches"]
                            for p in (*mains, phase_entry, phase_aln_se,
                                      phase_aln_pe, *mesh_mains)},
        pe_first256=pe_info,
        total_seconds=time.perf_counter() - t_start)), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
