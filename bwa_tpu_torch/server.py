"""Resident-engine daemon: a warm process that holds the loaded index, the
engine with its device index, the built kernels and the CUDA context, so
that a CLI one-shot skips the interpreter start, the torch import, the
CUDA context, the kernel loads and the index upload.  The process-level
completion of `bwa shm` (shm.py keeps the index warm; only a process keeps
a card warm).

    python -m bwa_tpu_torch.cli daemon start [--device cuda|cpu] <idxbase>
    python -m bwa_tpu_torch.cli mem <idxbase> reads.fq   # forwarded while
                                                         # a daemon serves
    python -m bwa_tpu_torch.cli daemon status|stop <idxbase>

Protocol (unix socket): the client sends one JSON line {"argv": [...],
"env": {...}}, env holding the client's BWA_TPU_* variables.  The daemon
answers one JSON status line, then the command's stdout as raw bytes until
it closes the connection:

    {"ok": rc}        the command ran; rc is its exit code
    {"refused": why}  the command asks for another device than the
                      daemon's: the client runs it itself
    {"error": repr}   the command raised (the client exits 1)

A forwarded command takes the route and the device that it would take
locally: the daemon applies the request's route switches (is_route_var)
for that request only, and refuses a request for another device.  A
warm stage that fails stops `daemon start`; a CUDA error, which poisons
the context, is answered with an error and ends the daemon with exit
code 1.  Nothing in the daemon falls back to the CPU.

Importing this module imports no torch: the forwarding client stays light.
"""

from __future__ import annotations

import codecs
import contextlib
import io
import json
import os
import socket
import sys
import time
import traceback
from pathlib import Path

from bwa_tpu_torch import tracing

# the commands that run on a device, and so take --device (cli._pop_device)
DEVICE_CMDS = ("mem", "fastmap", "aln")
# the switches that pick a route (read at call time by the port)
ROUTE_VARS = ("BWA_TPU_ALN", "BWA_TPU_FINALIZE", "BWA_TPU_SAMSE",
              "BWA_TPU_SAMPE", "BWA_TPU_EXT_FUSED", "BWA_TPU_EXT_STAGE",
              "BWA_TPU_STACK_CAP", "BWA_TPU_TRIP_SORT", "BWA_TPU_SEED_REFILL",
              "BWA_TPU_REFILL_LANES", "BWA_TPU_REFILL_BUCKET",
              "BWA_TPU_SEED_MACHINE", "BWA_TPU_SEED_COMPACT")


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit — shared with the native CLI client (client.c),
    which must compute the same socket name without Python."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def sock_dir() -> Path:
    """BWA_TPU_DAEMON_DIR, else bwa_tpu_torch_daemon under $TMPDIR (or
    /tmp): a directory of its own, so that a bwa_tpu daemon for the same
    index never answers the port's clients.  client.c takes the same."""
    d = os.environ.get("BWA_TPU_DAEMON_DIR")
    if not d:
        d = os.path.join(os.environ.get("TMPDIR") or "/tmp",
                         "bwa_tpu_torch_daemon")
    return Path(d)


def sock_path(prefix: str) -> Path:
    """Socket path for an index prefix (by real path identity, as
    client.c's realpath)."""
    key = f"{fnv1a64(os.path.realpath(prefix).encode()):016x}"
    return sock_dir() / f"engine-{key}.sock"


def is_route_var(name: str) -> bool:
    return name in ROUTE_VARS or name.startswith("BWA_TPU_ALN_")


def daemon_available(prefix: str, timeout: float = 2.0) -> bool:
    """Whether a daemon serves prefix.  A socket that refuses the
    connection is stale and goes; a ping that times out finds a busy
    daemon (it answers one connection at a time), which is up:
    client_run waits for its accept."""
    p = sock_path(prefix)
    if not p.exists():
        return False
    s = socket.socket(socket.AF_UNIX)
    try:
        s.settimeout(timeout)
        s.connect(str(p))
        s.sendall(b'{"ping": 1}\n')
        return s.recv(16).startswith(b"pong")
    except TimeoutError:
        return True
    except (ConnectionRefusedError, FileNotFoundError):
        p.unlink(missing_ok=True)
        return False
    except OSError:
        return False
    finally:
        s.close()


def client_run(prefix: str, argv: list[str], out_fp, tag: str):
    """Forward a CLI command to the resident daemon and stream its stdout
    to out_fp.  Returns the exit code, or None when the daemon refused
    the command (another device), which the caller then runs itself."""
    env = {k: v for k, v in os.environ.items() if k.startswith("BWA_TPU_")}
    with socket.socket(socket.AF_UNIX) as s:
        s.connect(str(sock_path(prefix)))
        s.sendall((json.dumps({"argv": argv, "env": env}) + "\n").encode())
        with s.makefile("rb") as f:
            status = json.loads(f.readline())
            if "refused" in status:
                print(f"[M::{tag}] not forwarded: {status['refused']}",
                      file=sys.stderr)
                return None
            print(f"[M::{tag}] forwarding to the resident engine daemon",
                  file=sys.stderr)
            if "error" in status:
                print(f"[daemon] {status['error']}", file=sys.stderr)
                return 1
            buf = getattr(out_fp, "buffer", out_fp)
            # a text sink (io.StringIO) takes the bytes decoded across
            # chunk boundaries, which may split a character
            dec = (codecs.getincrementaldecoder("utf-8")()
                   if isinstance(buf, io.TextIOBase) else None)
            while chunk := f.read(1 << 20):
                buf.write(dec.decode(chunk) if dec else chunk)
            if dec:
                buf.write(dec.decode(b"", final=True))
    return int(status["ok"])


class _BinOut:
    """Bytes accumulator that accepts both str (SAM text) and bytes
    (.sai) writes — the daemon runs text commands (mem/samse) and binary
    ones (aln) through one framing."""

    def __init__(self):
        self._b = io.BytesIO()
        self.buffer = self  # main_aln writes to out_fp.buffer

    def write(self, d) -> int:
        return self._b.write(d.encode() if isinstance(d, str) else d)

    def flush(self) -> None:
        pass

    def getvalue(self) -> bytes:
        return self._b.getvalue()


def _log(msg: str) -> None:
    print(f"[daemon] {msg}", file=sys.stderr, flush=True)


def _warm(fm, engine) -> None:
    """Run synthetic batches through every forwardable device shape
    before accepting requests, so that the first request finds the
    kernels loaded and the pools allocated: SE, PE, fastmap, pacbio long
    reads and the aln device search.  BWA_TPU_DAEMON_NO_WARM=1 skips it.
    A stage that raises stops the daemon: a shape that fails here would
    fail a request."""
    if os.environ.get("BWA_TPU_DAEMON_NO_WARM") == "1":
        return
    import numpy as np

    from bwa_tpu_torch.mem.pipeline import process_seqs
    from bwa_tpu_torch.mem.types import Read
    from bwa_tpu_torch.options import MEM_F_PE, MemOptions

    rng = np.random.default_rng(0)
    codes = fm.pac_codes
    b5 = np.frombuffer(b"ACGTN", np.uint8)

    def synth(n, L, err=0.0, name_of=lambda i: f"w{i}"):
        reads = []
        for i in range(n):
            s = int(rng.integers(0, max(1, fm.l_pac - L)))
            frag = np.minimum(codes[s:s + L], 4).copy()
            if frag.shape[0] < L:
                frag = np.pad(frag, (0, L - frag.shape[0]))
            if err > 0.0:
                m = rng.random(L) < err
                frag[m] = (frag[m] + rng.integers(1, 4, int(m.sum()))) % 4
            reads.append(Read(name=name_of(i), seq=b5[frag].tobytes()))
        return reads

    def stage(tag, fn):
        t0 = time.perf_counter()
        _log(f"warming {tag}...")
        try:
            fn()
            _sync(engine)
        except Exception as e:
            _log(f"{tag} warm failed: {e!r}")
            raise
        _log(f"{tag} warm in {time.perf_counter() - t0:.3f}s")

    def warm_se():
        process_seqs(MemOptions(), engine, fm, synth(8192, 150))

    def warm_pe():
        # proper FR pairs at insert ~350 so pestat converges like a real
        # library; read2 is the reverse complement of the mate-end window
        pairs = []
        rc = {0: b"T", 1: b"G", 2: b"C", 3: b"A", 4: b"N"}
        for i in range(2048):
            ins = max(200, min(500, int(rng.normal(350, 40))))
            s = int(rng.integers(0, max(1, fm.l_pac - ins - 1)))
            f1 = np.minimum(codes[s:s + 150], 4)
            f2 = np.minimum(codes[s + ins - 150:s + ins], 4)
            if f1.shape[0] < 150 or f2.shape[0] < 150:
                continue
            pairs.append(Read(name=f"p{i}", seq=b5[f1].tobytes()))
            pairs.append(Read(name=f"p{i}",
                              seq=b"".join(rc[int(c)] for c in f2[::-1])))
        o = MemOptions()
        o.flag |= MEM_F_PE
        process_seqs(o, engine, fm, pairs)

    def warm_fastmap():
        from bwa_tpu_torch.mem.fastmap import fastmap_batch

        list(fastmap_batch(fm, engine, synth(512, 150, name_of=str),
                           20, 17, False, 1, 0))

    def warm_long():
        o = MemOptions()
        o.apply_mode("pacbio")
        process_seqs(o, engine, fm, synth(256, 1200, err=0.08))

    def warm_aln():
        from bwa_tpu_torch.aln.batch_search import aln_batch_device
        from bwa_tpu_torch.aln.opts import GapOpt
        from bwa_tpu_torch.aln.seqio import PackedReads, _build_bt

        recs = [(r.name.encode(), r.seq, b"I" * len(r.seq))
                for r in synth(1024, 100, err=0.02)]
        pk = PackedReads.from_seqs(_build_bt(recs, False, 0))
        aln_batch_device(fm, engine, pk, GapOpt())

    stage("SE", warm_se)
    stage("PE", warm_pe)
    stage("fastmap", warm_fastmap)
    stage("pacbio", warm_long)
    stage("aln", warm_aln)


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        import torch

        torch.cuda.synchronize(engine.device)


def _context_lost(engine, err: Exception) -> bool:
    """Whether err left the daemon's CUDA context unusable: a CUDA error
    is sticky, so every later request would fail or read stale memory."""
    if engine.device.type != "cuda":
        return False
    import torch

    if isinstance(err, getattr(torch, "AcceleratorError", ())) \
            or "CUDA error" in str(err):
        return True
    try:
        torch.cuda.synchronize(engine.device)
    except RuntimeError:
        return True
    return False


def launch_counts() -> dict:
    """Kernel launches so far in this process, each wrapper's count: "K2"
    counts K2's gather mode on both paths, "K2 wide" those of them at
    P > 1024, "K1 refill" K1's refill mode in either form, "K1 refill
    group" those of them in its group form; K12a/K12b/K13 are K1's state
    mode as the split route's SMEM passes, its pass 3 and compaction's
    segments."""
    from bwa_tpu_torch.ops import (fm, fm_machine, gap_machine, ksw_band,
                                   ksw_full)

    return {"K1": fm_machine.launches,
            "K1 refill": fm_machine.refill_launches,
            "K1 refill group": fm_machine.refill_group_launches,
            "K12a": fm_machine.smem_launches,
            "K12b": fm_machine.seed3_launches,
            "K13": fm_machine.segment_launches,
            "K9": fm.sa_launches, "K10a": fm.smem1a_launches,
            "K10b": fm.strategy1_launches, "K11": fm.collect_launches,
            "K8": fm.probe_launches, "K2": ksw_band.launches,
            "K2 wide": ksw_band.wide_launches,
            "K2 host-array": ksw_band.array_launches,
            "K5": ksw_full.launches, "K7": gap_machine.launches,
            "K7w": gap_machine.width_launches}


def _memory(engine) -> str:
    if engine.device.type != "cuda":
        return ""
    import torch

    mib = 1 << 20
    alloc = torch.cuda.memory_allocated(engine.device) / mib
    reserved = torch.cuda.memory_reserved(engine.device) / mib
    return f" allocated_mib={alloc:.1f} reserved_mib={reserved:.1f}"


@contextlib.contextmanager
def _route_env(env: dict):
    """The request's route switches in os.environ for the request only
    (the daemon's own are unset where the request has none)."""
    keys = {k for k in (*os.environ, *env) if is_route_var(k)}
    saved = {k: os.environ.get(k) for k in keys}
    try:
        for k in keys:
            if k in env:
                os.environ[k] = str(env[k])
            else:
                os.environ.pop(k, None)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def request_device(argv: list[str]) -> str | None:
    """The device a command runs on (--device, the CLI's default cuda),
    or None for a host command."""
    from bwa_tpu_torch.cli import _pop_device

    return _pop_device(argv[1:])[1] if argv[0] in DEVICE_CMDS else None


def _serve_one(conn, cli_mod, engine, device: str) -> str:
    """Answer one connection: "serve" to go on, "stop" after a shutdown
    request, "lost" after a CUDA error."""
    with conn.makefile("rb") as f:
        req = json.loads(f.readline())
    if req.get("ping"):
        conn.sendall(b"pong\n")
        return "serve"
    if req.get("shutdown"):
        conn.sendall(b'{"ok": 0}\n')
        return "stop"
    argv = [str(a) for a in req["argv"]]
    env = {str(k): str(v) for k, v in req.get("env", {}).items()}
    _log(f"request: {argv} route="
         f"{json.dumps({k: v for k, v in env.items() if is_route_var(k)})}")
    try:
        dev = request_device(argv)
    except StopIteration:  # --device without its value
        dev = None
    if dev is not None and dev != device:
        why = f"the daemon runs on {device}, the command on {dev}"
        conn.sendall(json.dumps({"refused": why}).encode() + b"\n")
        _log(f"refused: {why}")
        return "serve"
    out = _BinOut()
    n0 = tracing.snapshot()["launches"]
    tracing.drain()  # this request's spans alone
    t0 = time.perf_counter()
    try:
        with _route_env(env):
            rc = cli_mod.main(argv, out_fp=out)
            _sync(engine)
    except Exception as e:  # the serving boundary: report, log, go on
        lost = _context_lost(engine, e)
        conn.sendall(json.dumps({"error": repr(e)}).encode() + b"\n")
        _log(f"error: {traceback.format_exc()}"
             + (" (the CUDA context is lost: exiting)" if lost else ""))
        return "lost" if lost else "serve"
    seconds = time.perf_counter() - t0
    launches = {k: v - n0[k]
                for k, v in tracing.snapshot()["launches"].items()}
    traced = ""
    if tracing.ON:
        s = tracing.summary(tracing.drain())
        traced = (f" spans={json.dumps(s['self_s'], sort_keys=True)}"
                  f" counters={json.dumps(s['counters'], sort_keys=True)}")
    _log(f"done rc={rc} bytes={len(out.getvalue())} "
         f"seconds={seconds:.6f} "
         f"launches={json.dumps(launches)}{traced}{_memory(engine)}")
    conn.sendall(json.dumps({"ok": rc}).encode() + b"\n")
    conn.sendall(out.getvalue())
    return "serve"


def serve(prefix: str, device: str = "cuda") -> int:
    """Load the index and the engine on `device` once, build the kernels
    (on a card), warm the shapes, then serve forwarded commands."""
    import faulthandler
    import signal

    from bwa_tpu_torch import cli as cli_mod
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex

    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks
    # SIGTERM ends the daemon through its finally: the socket goes too
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    key = os.path.realpath(prefix)
    t0 = time.perf_counter()
    fm = FMIndex.load(prefix)
    engine = make_engine(fm, device)
    if engine.device.type == "cuda":
        from bwa_tpu_torch.ops import cuda_kernels

        cuda_kernels.build_all()
    _sync(engine)
    _log(f"index, engine and kernels on {device} in "
         f"{time.perf_counter() - t0:.3f}s")
    cli_mod._ENGINE_CACHE[key] = (fm, engine, device)
    _warm(fm, engine)
    _log(f"warm{_memory(engine)}")
    sp = sock_path(prefix)
    sp.parent.mkdir(parents=True, exist_ok=True)
    sp.unlink(missing_ok=True)
    # the path appears only once the socket listens: a client that
    # connected between bind and listen would be refused, take the socket
    # for a stale one and unlink it (daemon_available)
    tmp = sp.with_suffix(".tmp")
    srv = socket.socket(socket.AF_UNIX)
    try:
        tmp.unlink(missing_ok=True)
        srv.bind(str(tmp))
        srv.listen(4)
        os.replace(tmp, sp)
        _log(f"serving {key} on {sp} (pid {os.getpid()}, {device})")
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    state = _serve_one(conn, cli_mod, engine, device)
                except (ValueError, KeyError, TypeError) as e:
                    _log(f"malformed request: {e!r}")
                    with contextlib.suppress(OSError):
                        conn.sendall(json.dumps({"error": repr(e)}).encode()
                                     + b"\n")
                    continue
                except OSError as e:  # the client went away
                    _log(f"connection lost: {e!r}")
                    continue
            if state != "serve":
                return 0 if state == "stop" else 1
    finally:
        srv.close()
        tmp.unlink(missing_ok=True)
        sp.unlink(missing_ok=True)


def main_daemon(argv: list[str]) -> int:
    from bwa_tpu_torch.cli import _pop_device

    argv, device = _pop_device(argv)
    if len(argv) != 2 or argv[0] not in ("start", "stop", "status"):
        print("Usage: python -m bwa_tpu_torch.cli daemon "
              "start [--device cuda|cpu]|stop|status <idxbase>",
              file=sys.stderr)
        return 1
    cmd, prefix = argv
    if cmd == "start":
        return serve(prefix, device)
    if cmd == "status":
        up = daemon_available(prefix)
        print(f"[daemon] {'running' if up else 'not running'} for {prefix}",
              file=sys.stderr)
        return 0 if up else 1
    try:
        with socket.socket(socket.AF_UNIX) as s:
            s.connect(str(sock_path(prefix)))
            s.sendall(b'{"shutdown": 1}\n')
            s.recv(16)
    except OSError:
        print("[daemon] not running", file=sys.stderr)
        return 1
    print("[daemon] stopped", file=sys.stderr)
    return 0
