"""Reads data-parallel over hosts (torch.distributed, gloo).

The reference has no distributed backend; its determinism story is `-K`
fixed chunking, so the output does not depend on the thread count
(fastmap.c:303).  The same property across hosts:

  * every host streams the same FASTQ(s) with the same chunk boundaries
    (`-K`-style fixed chunk_size x n_threads bases, an even count for PE),
  * host h aligns the batches j with j % n_hosts == h on its own card(s)
    (the index is loaded on each host; within a host, reads split over
    the cards' mesh, parallel/mesh.py, through make_engine),
  * each host writes its batches as ordered shards; `merge_shards`
    concatenates them in global batch order (the kt_pipeline ordered
    step, kthread.c:96-113).

Batch composition is the single-host run's, so each batch's output,
mem_pestat's batch statistics included, is byte-identical to the
single-host (and reference) output after the merge.  Each host runs
align_distributed (or `python -m bwa_tpu_torch.parallel.multihost`) with
torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); only a
barrier and a small offset table cross hosts, over gloo (NCCL would
refuse two ranks on one card).  align_shard itself needs only (host_id,
n_hosts), so the tests also drive it as separate calls.
"""

from __future__ import annotations

import os
from datetime import timedelta
from pathlib import Path

from bwa_tpu_torch.engine import make_engine
from bwa_tpu_torch.index.fmindex import FMIndex
from bwa_tpu_torch.io.fastq import SeqReader, read_batch
from bwa_tpu_torch.options import MEM_F_PE

# how long a host waits at a barrier for the others (their alignment)
BARRIER_TIMEOUT_S = 3600


def distributed_init():
    """The process group for a multi-host run: call once a host before
    align_shard.  Reads torchrun's contract (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) and joins a gloo group by env://; a no-op on a
    single process, so one entry point serves one host and many.
    Returns (host_id, n_hosts)."""
    n_hosts = int(os.environ.get("WORLD_SIZE", "1"))
    host_id = int(os.environ.get("RANK", "0"))
    if n_hosts > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            dist.init_process_group("gloo", init_method="env://",
                                    world_size=n_hosts, rank=host_id,
                                    timeout=timedelta(
                                        seconds=BARRIER_TIMEOUT_S))
        return dist.get_rank(), dist.get_world_size()
    return host_id, n_hosts


def host_device(device: str, host_id: int) -> str:
    """A host's engine device: with several processes on this host
    (torchrun's LOCAL_WORLD_SIZE, else WORLD_SIZE), "cuda" becomes the card
    cuda:(local rank mod cards) (LOCAL_RANK, else RANK); with one process
    a host it stays "cuda", which make_engine meshes over every card."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    if device != "cuda" or local <= 1:
        return device
    import torch

    rank = int(os.environ.get("LOCAL_RANK", host_id))
    return f"cuda:{rank % max(1, torch.cuda.device_count())}"


def align_distributed(prefix: str, fq1: str, fq2: str | None,
                      shard_dir: str, out_path: str | None = None,
                      opt=None, device: str = "cuda", rg_id=None,
                      header: str = "") -> int:
    """Whole multi-host entry: process group -> shard-aligned batches ->
    (on host 0) ordered merge.  Every host runs this same function; batch
    ownership is j % n_hosts (the -K-deterministic chunking keeps the
    merged bytes identical to a single-host run).  The group is
    destroyed at the end, whatever happened."""
    import torch.distributed as dist

    host_id, n_hosts = distributed_init()
    try:
        offsets = None
        can_seek = _seekable(fq1) and (fq2 is None or _seekable(fq2))
        if n_hosts > 1 and can_seek:
            # scan the -K batch boundaries ONCE (host 0) and share the
            # table, so each host reads only its own ~1/n_hosts of the input
            import json

            from bwa_tpu_torch.options import MemOptions

            tbl = Path(shard_dir) / "offsets.json"
            if host_id == 0:
                tbl.parent.mkdir(parents=True, exist_ok=True)
                offsets = scan_batch_offsets(opt or MemOptions(), fq1, fq2)
                tbl.write_text(json.dumps(offsets))
            dist.barrier()
            if host_id != 0:
                offsets = [tuple(row) for row in json.loads(tbl.read_text())]
        n = align_shard(prefix, fq1, fq2, host_id, n_hosts, shard_dir,
                        opt=opt, device=host_device(device, host_id),
                        rg_id=rg_id, offsets=offsets)
        if n_hosts > 1:
            # EVERY process barriers before host 0 merges (a one-sided
            # barrier would deadlock the coordinator)
            dist.barrier()
        if out_path and host_id == 0:
            merge_shards(shard_dir, out_path, header)
        return n
    finally:
        if n_hosts > 1:
            dist.destroy_process_group()


def iter_batches(opt, fq1: str, fq2: str | None):
    """Deterministic batch stream shared by all hosts (bseq_read with the
    actual_chunk_size semantics of fastmap.c:394)."""
    ks1 = SeqReader(fq1)
    ks2 = SeqReader(fq2) if fq2 else None
    chunk = opt.chunk_size * opt.n_threads
    while True:
        reads = read_batch(ks1, ks2, chunk)
        if not reads:
            break
        yield reads


def _seekable(path) -> bool:
    """Plain uncompressed regular file (the seek-to-batch fast path);
    gz/stdin/URL inputs keep the streaming path."""
    p = str(path)
    if p == "-" or p.startswith(("http://", "ftp://", "https://")):
        return False
    try:
        with open(p, "rb") as f:
            return f.read(2) != b"\x1f\x8b"
    except OSError:
        return False


def _scan_records(path) -> list[tuple[int, int]]:
    """One sequential lex pass over an uncompressed FASTA/FASTQ: returns
    (byte offset of record header, sequence length) per record, with
    exactly SeqReader's record-boundary semantics (multi-line sequences,
    blank-line skips, qual read until len(qual) >= len(seq))."""
    out: list[tuple[int, int]] = []
    with open(str(path), "rb") as f:
        pos = 0
        pending: tuple[bytes, int] | None = None  # pushed-back header
        while True:
            if pending is not None:
                line, start = pending
                pending = None
            else:
                start = pos
                line = f.readline()
                pos += len(line)
            if not line:
                break
            s = line.rstrip(b"\r\n")
            if not s:
                continue
            if s[:1] not in (b"@", b">"):
                raise ValueError(f"malformed record header: {s[:40]!r}")
            seq_len = 0
            while True:
                lstart = pos
                body = f.readline()
                pos += len(body)
                if not body:
                    break
                b = body.rstrip(b"\r\n")
                if b[:1] == b"+":
                    got = 0
                    while got < seq_len:
                        ql = f.readline()
                        if not ql:
                            break
                        pos += len(ql)
                        got += len(ql.rstrip(b"\r\n"))
                    break
                if b[:1] in (b"@", b">"):
                    pending = (body, lstart)
                    break
                seq_len += len(b)
            out.append((start, seq_len))
    return out


def scan_batch_offsets(opt, fq1: str, fq2: str | None):
    """Pre-scan the -K batch boundaries ONCE: returns one row per batch,
    (off1, off2, n_records_per_file, n_processed_before).  Row j lets a
    host seek straight to its own batches instead of parsing the entire
    input and discarding (n_hosts-1)/n_hosts of it — while preserving
    bseq_read's exact batch composition (size >= chunk AND even read
    count, bwa.c:79-112), so the merged output stays byte-identical."""
    recs1 = _scan_records(fq1)
    recs2 = _scan_records(fq2) if fq2 else None
    if recs2 is not None and len(recs2) < len(recs1):
        import sys
        print("[W::bseq_read] the 2nd file has fewer sequences.",
              file=sys.stderr)
    n = min(len(recs1), len(recs2)) if recs2 is not None else len(recs1)
    chunk = opt.chunk_size * opt.n_threads
    batches = []
    i = 0
    n_processed = 0
    while i < n:
        off1 = recs1[i][0]
        off2 = recs2[i][0] if recs2 is not None else -1
        size = 0
        cnt = 0
        j = i
        while j < n:
            size += recs1[j][1]
            cnt += 1
            if recs2 is not None:
                size += recs2[j][1]
                cnt += 1
            j += 1
            if size >= chunk and cnt % 2 == 0:
                break
        batches.append((off1, off2, j - i, n_processed))
        n_processed += cnt
        i = j
    return batches


def _read_n(ks1: SeqReader, ks2: SeqReader | None, n: int):
    """Read exactly n records per file, building the batch exactly like
    read_batch (interleaved PE, batch-local ids, comments dropped)."""
    reads = []
    for _ in range(n):
        r1 = next(iter(ks1))
        r1.id = len(reads)
        r1.comment = None
        reads.append(r1)
        if ks2 is not None:
            r2 = next(iter(ks2))
            r2.id = len(reads)
            r2.comment = None
            reads.append(r2)
    return reads


# bytes of FASTQ consumed by the last align_shard call's alignment phase
# (excludes any offset pre-scan) — observability for the no-amplification
# property: host h should read ~1/n_hosts of the input, not all of it
last_bytes_read = 0


class _CountingFile:
    """Minimal readline wrapper that counts bytes consumed."""

    def __init__(self, f):
        self.f = f
        self.n = 0

    def readline(self):
        l = self.f.readline()
        self.n += len(l)
        return l

    def close(self):
        self.f.close()


def align_shard(prefix: str, fq1: str, fq2: str | None, host_id: int,
                n_hosts: int, shard_dir: str, opt=None,
                device: str = "cuda", rg_id=None, offsets=None) -> int:
    """Align this host's batches on an engine made by make_engine(fm,
    device); writes <shard_dir>/batch<j>.sam per owned batch.  Returns
    the number of batches owned.

    With seekable inputs the host seeks straight to its own batches via
    the pre-scanned offset table (`offsets`, or scanned here when None)
    instead of parsing the whole input and discarding the other hosts'
    share; gz/stdin/URL inputs fall back to the streaming path (same
    bytes out either way — batch composition is identical)."""
    global last_bytes_read
    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.options import MemOptions

    opt = opt or MemOptions()
    if fq2:
        opt.flag |= MEM_F_PE
    fm = FMIndex.load(prefix)
    engine = make_engine(fm, device)
    shard = Path(shard_dir)
    shard.mkdir(parents=True, exist_ok=True)
    n_own = 0
    can_seek = _seekable(fq1) and (fq2 is None or _seekable(fq2))
    if offsets is None and can_seek and n_hosts > 1:
        offsets = scan_batch_offsets(opt, fq1, fq2)
    if offsets is not None and can_seek:
        last_bytes_read = 0
        f1 = _CountingFile(open(str(fq1), "rb"))
        f2 = _CountingFile(open(str(fq2), "rb")) if fq2 else None
        for j, (off1, off2, n_rec, n_processed) in enumerate(offsets):
            if j % n_hosts != host_id:
                continue
            f1.f.seek(off1)
            ks1 = SeqReader(f1)
            ks2 = None
            if f2 is not None:
                f2.f.seek(off2)
                ks2 = SeqReader(f2)
            reads = _read_n(ks1, ks2, n_rec)
            process_seqs(opt, engine, fm, reads, n_processed, None, rg_id)
            with open(shard / f"batch{j:08d}.sam", "w") as f:
                for r in reads:
                    f.write(r.sam)
            n_own += 1
        last_bytes_read = f1.n + (f2.n if f2 is not None else 0)
        f1.close()
        if f2 is not None:
            f2.close()
        return n_own
    n_processed = 0
    for j, reads in enumerate(iter_batches(opt, fq1, fq2)):
        if j % n_hosts == host_id:
            process_seqs(opt, engine, fm, reads, n_processed, None, rg_id)
            with open(shard / f"batch{j:08d}.sam", "w") as f:
                for r in reads:
                    f.write(r.sam)
            n_own += 1
        n_processed += len(reads)
    return n_own


def _main(argv=None) -> int:
    """Per-host launcher: `python -m bwa_tpu_torch.parallel.multihost
    <prefix> <fq1> [fq2] --shard-dir D [--out merged.sam] [--device
    cuda|cpu] [--chunk-size N]`.  Run once a host with torchrun's
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); host 0 merges
    after the last barrier."""
    import argparse

    ap = argparse.ArgumentParser(prog="bwa_tpu_torch.parallel.multihost")
    ap.add_argument("prefix")
    ap.add_argument("fq1")
    ap.add_argument("fq2", nargs="?", default=None)
    ap.add_argument("--shard-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunk-size", type=int, default=None)
    a = ap.parse_args(argv)
    opt = None
    if a.chunk_size:
        from bwa_tpu_torch.options import MemOptions

        opt = MemOptions()
        opt.chunk_size = a.chunk_size
        opt.n_threads = 1
    align_distributed(a.prefix, a.fq1, a.fq2, a.shard_dir, out_path=a.out,
                      opt=opt, device=a.device)
    return 0


def merge_shards(shard_dir: str, out_path: str, header: str = "") -> int:
    """Ordered merge of every host's batch shards (host-side concatenation
    in chunk order — the ordered kt_pipeline step)."""
    shard = Path(shard_dir)
    parts = sorted(shard.glob("batch*.sam"))
    with open(out_path, "w") as out:
        if header:
            out.write(header)
        for p in parts:
            out.write(p.read_text())
    return len(parts)


if __name__ == "__main__":
    import sys

    sys.exit(_main())
