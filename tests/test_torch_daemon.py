"""The port's resident daemon on the CPU: a daemon started with --device cpu
serves forwarded mem, fastmap, aln (native search and the device search's
plain version), samse and sampe, whose output equals bwa_tpu's one-shot
output run in process (BWA_TPU_NO_DAEMON=1).  Tolerance: none, bytes equal,
@ lines aside.  Also: exit codes cross the socket, stdin runs locally, a
forwarding client imports no torch, a command for another device is never
served on the daemon's and a request's route switches apply to that request
only, the native client (forward, exit code, fallback to the port's CLI,
fastmap and the device-route aln never in the native library), and
`daemon status` / `daemon stop`.  The counterparts of test_daemon.py,
held to bwa_tpu's output instead of the oracle's."""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

REPO = Path(__file__).resolve().parent.parent
# a client that reports whether forwarding imported torch
CLIENT = ("import sys; from bwa_tpu_torch.cli import main; rc = main(); "
          "sys.stdout.flush(); "
          "print('TORCH=%d' % ('torch' in sys.modules), file=sys.stderr); "
          "sys.exit(rc)")
CAPS = "64,128,256"  # bwa_tpu's ladder, for the plain gap machine


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()
    d = tmp_path_factory.mktemp("torch_daemon")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    write_fastq(d / "se.fq", simulate_reads(g, 48, read_len=100, seed=17,
                                            err_rate=0.02,
                                            indel_rate=0.004))
    a, b = simulate_reads(g, 24, read_len=100, seed=19, err_rate=0.02,
                          paired=True, insert_mean=300, insert_std=30)
    write_fastq(d / "pe1.fq", a)
    write_fastq(d / "pe2.fq", b)
    w = dict(prefix=index_build(str(d / "g.fa")), dir=d, se=d / "se.fq",
             pe=[d / "pe1.fq", d / "pe2.fq"])
    # bwa_tpu's .sai files, the inputs of both packages' samse/sampe
    for name, fq in (("se", w["se"]), ("pe1", w["pe"][0]),
                     ("pe2", w["pe"][1])):
        (d / f"{name}.sai").write_bytes(_jax(["aln", w["prefix"], str(fq)],
                                             binary=True))
    return w


def _jax(args, binary=False):
    """bwa_tpu's one-shot output, in process, no daemon."""
    from bwa_tpu.cli import main as jax_main

    os.environ["BWA_TPU_NO_DAEMON"] = "1"
    try:
        out = io.BytesIO() if binary else io.StringIO()
        assert jax_main(args, out_fp=out) == 0
    finally:
        os.environ.pop("BWA_TPU_NO_DAEMON", None)
    v = out.getvalue()
    return v if binary else v.encode()


def _records(b: bytes) -> list[bytes]:
    return [ln for ln in b.splitlines() if not ln.startswith(b"@")]


def _ping(path: Path) -> bool:
    try:
        with socket.socket(socket.AF_UNIX) as s:
            s.settimeout(2.0)
            s.connect(str(path))
            s.sendall(b'{"ping": 1}\n')
            return s.recv(16).startswith(b"pong")
    except OSError:
        return False


@pytest.fixture(scope="module")
def daemon(world, tmp_path_factory):
    sockdir = tmp_path_factory.mktemp("sock")
    env = dict(os.environ)
    env.pop("BWA_TPU_NO_DAEMON", None)
    env.update(BWA_TPU_DAEMON_DIR=str(sockdir), BWA_TPU_DAEMON_NO_WARM="1",
               PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    log = world["dir"] / "daemon.log"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bwa_tpu_torch.cli", "daemon", "start",
             "--device", "cpu", world["prefix"]],
            cwd=REPO, env=env, stderr=err)
    deadline = time.time() + 120
    while not any(_ping(p) for p in sockdir.glob("*.sock")):
        if proc.poll() is not None:
            raise RuntimeError(log.read_text()[-2000:])
        if time.time() > deadline:
            proc.kill()
            raise RuntimeError("the daemon did not come up")
        time.sleep(0.2)
    yield dict(env=env, proc=proc, log=log, sockdir=sockdir)
    if proc.poll() is None:
        proc.terminate()
    proc.wait(timeout=60)


def _client(args, env, stdin=None, cwd=REPO, **extra):
    env = dict(env, **extra)
    r = subprocess.run([sys.executable, "-c", CLIENT, *map(str, args)],
                       capture_output=True, cwd=cwd, env=env, input=stdin,
                       timeout=300)
    return r


def _native(args, env, stdin=None, cwd=REPO, **extra):
    from bwa_tpu_torch.native.build import client_exe

    env = dict(env, **{"BWA_TPU_PYTHON": sys.executable, **extra})
    return subprocess.run([str(client_exe()), *map(str, args)],
                          capture_output=True, cwd=cwd, env=env,
                          input=stdin, timeout=300)


FORWARDS = {
    "mem": (lambda w: ["mem", "--device", "cpu", w["prefix"], w["se"]],
            lambda w: ["mem", w["prefix"], str(w["se"])], {}),
    "mem_pe": (lambda w: ["mem", "--device", "cpu", w["prefix"], *w["pe"]],
               lambda w: ["mem", w["prefix"], *map(str, w["pe"])], {}),
    "fastmap": (lambda w: ["fastmap", "--device", "cpu", w["prefix"],
                           w["se"]],
                lambda w: ["fastmap", w["prefix"], str(w["se"])], {}),
    "aln_native": (lambda w: ["aln", "--device", "cpu", w["prefix"],
                              w["se"]],
                   lambda w: ["aln", w["prefix"], str(w["se"])], {}),
    "aln_device": (lambda w: ["aln", "--device", "cpu", w["prefix"],
                              w["se"]],
                   lambda w: ["aln", w["prefix"], str(w["se"])],
                   dict(BWA_TPU_ALN="device", BWA_TPU_ALN_CAPS=CAPS)),
    "samse": (lambda w: ["samse", w["prefix"], w["dir"] / "se.sai",
                         w["se"]],
              lambda w: ["samse", w["prefix"], str(w["dir"] / "se.sai"),
                         str(w["se"])], {}),
    "sampe": (lambda w: ["sampe", w["prefix"], w["dir"] / "pe1.sai",
                         w["dir"] / "pe2.sai", *w["pe"]],
              lambda w: ["sampe", w["prefix"], str(w["dir"] / "pe1.sai"),
                         str(w["dir"] / "pe2.sai"), *map(str, w["pe"])], {}),
}


@pytest.mark.parametrize("case", list(FORWARDS))
def test_forward_matches_jax(world, daemon, case):
    """Forwarded through the Python client: output equal to bwa_tpu's,
    torch never imported in the client, and the request's route switches
    reach the daemon (aln_device: the device search, its plain version)."""
    port_args, jax_args, extra = FORWARDS[case]
    r = _client(port_args(world), daemon["env"], **extra)
    assert r.returncode == 0, r.stderr[-2000:]
    assert b"forwarding to the resident engine daemon" in r.stderr, \
        r.stderr[-1000:]
    assert b"TORCH=0" in r.stderr
    want = _jax(jax_args(world), binary=case.startswith("aln"))
    if case.startswith("aln"):
        assert r.stdout == want  # the binary .sai through the socket
    else:
        assert _records(r.stdout) == _records(want)
        assert _records(want)
    if extra:
        last = [ln for ln in daemon["log"].read_text().splitlines()
                if "request:" in ln][-1]
        assert json.loads(last.split("route=", 1)[1]) == extra


def test_exit_code_crosses_the_socket(world, daemon, tmp_path):
    """A command that fails in the daemon fails the client, and the daemon
    serves on: a garbled .sai (samse raises there), mem with three read
    files through the native client (the usage error's rc 1), and
    malformed requests (each answered with an error)."""
    bogus = tmp_path / "bogus.sai"
    bogus.write_bytes(b"not a sai file\n")
    r = _client(["samse", world["prefix"], bogus, world["se"]],
                daemon["env"])
    assert r.returncode != 0
    assert b"[daemon]" in r.stderr
    r = _native(["mem", "--device", "cpu", world["prefix"], world["se"],
                 world["se"], world["se"]], daemon["env"])
    assert r.returncode == 1
    assert b"done rc=1" in daemon["log"].read_bytes()
    sock = next(daemon["sockdir"].glob("*.sock"))
    for junk in (b"not json\n", b"", b'{"no_argv": 1}\n'):
        with socket.socket(socket.AF_UNIX) as s:
            s.connect(str(sock))
            s.sendall(junk)
            s.shutdown(socket.SHUT_WR)
            assert s.makefile("rb").read().startswith(b'{"error"')
    r = _client(FORWARDS["mem"][0](world), daemon["env"])
    assert r.returncode == 0 and b"forwarding" in r.stderr


def test_stdin_runs_locally(world, daemon):
    fq = world["se"].read_bytes()
    r = _client(["mem", "--device", "cpu", world["prefix"], "-"],
                daemon["env"], stdin=fq)
    assert r.returncode == 0, r.stderr[-2000:]
    assert b"forwarding" not in r.stderr
    assert _records(r.stdout) == _records(
        _jax(["mem", world["prefix"], str(world["se"])]))


@pytest.mark.parametrize("run", [_client, _native],
                         ids=["python", "native"])
def test_output_file_runs_locally(world, daemon, tmp_path, run):
    """mem -o<file> and -Mo <file> (getopt's joined and clustered forms)
    write the client's own file in its own working directory: the command
    is never forwarded, and the file holds bwa_tpu's records."""
    for flags, jax_flags in ((["-oout.sam"], []), (["-Mo", "out.sam"], ["-M"])):
        n_req = daemon["log"].read_text().count("request:")
        r = run(["mem", *flags, "--device", "cpu", world["prefix"],
                 world["se"]], daemon["env"], cwd=tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        assert b"forwarding" not in r.stderr
        assert daemon["log"].read_text().count("request:") == n_req
        assert _records((tmp_path / "out.sam").read_bytes()) == _records(
            _jax(["mem", *jax_flags, world["prefix"], str(world["se"])]))
        (tmp_path / "out.sam").unlink()


def test_other_device_not_served(world, daemon):
    """A cuda command is refused by the cpu daemon and runs locally, where
    this machine has no card: it fails, it is never served on the CPU."""
    for run in (_client, _native):
        r = run(["mem", "--device", "cuda", world["prefix"], world["se"]],
                daemon["env"])
        assert b"not forwarded" in r.stderr, r.stderr[-1000:]
        assert b"forwarding" not in r.stderr
        assert b"torch.cuda.is_available() is false" in r.stderr
        assert r.returncode != 0
    assert b"refused: the daemon runs on cpu, the command on cuda" \
        in daemon["log"].read_bytes()


# the seeding switches of mem, applied per request as the others
SEED_ROUTES = {"BWA_TPU_TRIP_SORT": "force", "BWA_TPU_SEED_REFILL": "1",
               "BWA_TPU_REFILL_LANES": "1024",
               "BWA_TPU_REFILL_BUCKET": "4096",
               "BWA_TPU_SEED_MACHINE": "split", "BWA_TPU_SEED_COMPACT": "1"}


class _Cli:
    """Stands in for the CLI module inside _serve_one: records the route
    switches each command sees."""

    def __init__(self):
        self.seen = []

    def main(self, argv, out_fp):
        self.seen.append({k: os.environ.get(k) for k in
                          ("BWA_TPU_ALN", "BWA_TPU_FINALIZE",
                           "BWA_TPU_ALN_CAPS", *SEED_ROUTES)})
        out_fp.write(b"x")
        return 0


class _Engine:
    class device:
        type = "cpu"


def _serve(req: dict, device: str, cli):
    from bwa_tpu_torch import server

    a, b = socket.socketpair()
    with a, b:
        a.sendall(json.dumps(req).encode() + b"\n")
        state = server._serve_one(b, cli, _Engine(), device)
        b.shutdown(socket.SHUT_WR)
        reply = a.makefile("rb").read()
    return state, reply


def test_serve_one_device_and_route(monkeypatch):
    """_serve_one refuses a command for another device either way round
    (cpu on a cuda daemon, cuda on a cpu one; samse has no device), and
    applies the request's route switches for that request only: the
    daemon's own BWA_TPU_FINALIZE is unset while a request without it
    runs, and comes back after."""
    cli = _Cli()
    for device, argv in (("cuda", ["mem", "--device", "cpu", "p", "r"]),
                         ("cuda", ["aln", "--device=cpu", "p", "r"]),
                         ("cpu", ["fastmap", "p", "r"])):
        state, reply = _serve({"argv": argv}, device, cli)
        assert state == "serve"
        assert b'"refused"' in reply.split(b"\n")[0], (device, argv)
    assert not cli.seen
    monkeypatch.setenv("BWA_TPU_FINALIZE", "python")
    monkeypatch.delenv("BWA_TPU_ALN", raising=False)
    for k in SEED_ROUTES:
        monkeypatch.delenv(k, raising=False)
    state, reply = _serve({"argv": ["samse", "p", "s", "r"],
                           "env": {"BWA_TPU_ALN": "device",
                                   "BWA_TPU_ALN_CAPS": CAPS,
                                   "BWA_TPU_DAEMON_DIR": "/elsewhere",
                                   **SEED_ROUTES}},
                          "cuda", cli)
    assert reply == b'{"ok": 0}\nx'
    assert cli.seen == [dict(BWA_TPU_ALN="device", BWA_TPU_FINALIZE=None,
                             BWA_TPU_ALN_CAPS=CAPS, **SEED_ROUTES)]
    assert os.environ.get("BWA_TPU_FINALIZE") == "python"
    assert not {"BWA_TPU_ALN", *SEED_ROUTES} & set(os.environ)
    assert os.environ.get("BWA_TPU_DAEMON_DIR") != "/elsewhere"


def test_serve_one_seeding_routes(world, monkeypatch):
    """The port's own mem served through _serve_one on a CPU engine: a
    request's BWA_TPU_TRIP_SORT=force sorts that request's reads (the
    engine probes their trips, the SAM equals bwa_tpu's under force), the
    next request without it does not, and a request with
    BWA_TPU_SEED_COMPACT=1 is served on the tail-compaction route, its SAM
    equal to bwa_tpu's under that switch."""
    from bwa_tpu_torch import cli
    from bwa_tpu_torch.ops import fm

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    for k in SEED_ROUTES:
        monkeypatch.delenv(k, raising=False)
    probed = []
    real = fm.BatchedFMEngine.probe_trips
    monkeypatch.setattr(fm.BatchedFMEngine, "probe_trips",
                        lambda self, c: probed.append(len(c))
                        or real(self, c))
    argv = ["mem", "--device", "cpu", world["prefix"], str(world["se"])]
    monkeypatch.setenv("BWA_TPU_TRIP_SORT", "force")
    want = _records(_jax(argv[:1] + argv[3:]))
    monkeypatch.delenv("BWA_TPU_TRIP_SORT")
    for env, n_probed in (({"BWA_TPU_TRIP_SORT": "force"}, [48]),
                          ({}, [48])):
        state, reply = _serve({"argv": argv, "env": env}, "cpu", cli)
        head, body = reply.split(b"\n", 1)
        assert state == "serve" and json.loads(head) == {"ok": 0}, reply
        assert _records(body) == want
        assert probed == n_probed
    from bwa_tpu_torch.ops import fm_machine

    monkeypatch.setenv("BWA_TPU_SEED_COMPACT", "1")
    want = _records(_jax(argv[:1] + argv[3:]))
    monkeypatch.delenv("BWA_TPU_SEED_COMPACT")
    segments = []
    real_seg = fm_machine.segment
    monkeypatch.setattr(fm_machine, "segment",
                        lambda *a, **k: segments.append(1) or real_seg(*a,
                                                                       **k))
    state, reply = _serve({"argv": argv,
                           "env": {"BWA_TPU_SEED_COMPACT": "1"}}, "cpu", cli)
    head, body = reply.split(b"\n", 1)
    assert state == "serve" and json.loads(head) == {"ok": 0}, reply
    assert _records(body) == want
    assert segments  # the compaction route ran
    assert "BWA_TPU_SEED_COMPACT" not in os.environ


class _Raises(_Cli):
    def __init__(self, err):
        super().__init__()
        self.err = err

    def main(self, argv, out_fp):
        raise self.err


class _CudaEngine:
    class device:
        type = "cuda"


def test_serve_one_cuda_error_ends_the_daemon():
    """A command that raises answers {"error"}; after a CUDA error (the
    context is poisoned) _serve_one ends the daemon ("lost"), after any
    other error on a CPU engine it serves on."""
    from bwa_tpu_torch import server

    for err, engine, state in (
            (RuntimeError("CUDA error: an illegal memory access was "
                          "encountered"), _CudaEngine(), "lost"),
            (ValueError("not a sai file"), _Engine(), "serve")):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(json.dumps({"argv": ["samse", "p", "s", "r"]})
                      .encode() + b"\n")
            assert server._serve_one(b, _Raises(err), engine,
                                     engine.device.type) == state
            b.shutdown(socket.SHUT_WR)
            reply = a.makefile("rb").read()
        assert json.loads(reply)["error"] == repr(err)


class _Blocks(_Cli):
    """A command that runs until released: the daemon is busy."""

    def __init__(self):
        super().__init__()
        self.go = threading.Event()

    def main(self, argv, out_fp):
        self.seen.append(argv)
        self.go.wait(60)
        out_fp.write(b"x")
        return 0


def test_busy_daemon_keeps_its_socket(tmp_path_factory, monkeypatch):
    """A daemon busy with one request (it answers one connection at a
    time) does not answer a ping in time: daemon_available reports it up
    and leaves its socket, and the request completes; a socket that no
    process listens on is stale, and goes."""
    from bwa_tpu_torch import server

    monkeypatch.setenv("BWA_TPU_DAEMON_DIR", str(tmp_path_factory.mktemp("b")))
    prefix = "g.fa"
    sp = server.sock_path(prefix)
    sp.parent.mkdir(parents=True, exist_ok=True)
    cli = _Blocks()
    states = []
    with socket.socket(socket.AF_UNIX) as srv:
        srv.bind(str(sp))
        srv.listen(4)

        def serve_one():
            conn, _ = srv.accept()
            with conn:
                states.append(server._serve_one(conn, cli, _Engine(), "cpu"))

        th = threading.Thread(target=serve_one)
        th.start()
        with socket.socket(socket.AF_UNIX) as c:
            c.connect(str(sp))
            c.sendall(json.dumps({"argv": ["samse", "p", "s", "r"]})
                      .encode() + b"\n")
            while not cli.seen:  # the request runs
                time.sleep(0.01)
            assert server.daemon_available(prefix, timeout=0.3)
            assert sp.exists()
            cli.go.set()
            th.join(60)
            c.shutdown(socket.SHUT_WR)
            assert c.makefile("rb").read() == b'{"ok": 0}\nx'
        assert states == ["serve"]
    assert sp.exists()
    assert not server.daemon_available(prefix)
    assert not sp.exists()


def test_native_client(world, daemon, tmp_path):
    """client.c: forwards mem and aln (bytes equal to bwa_tpu's), execs the
    port's CLI for other commands (xa2multi), runs the native-route aln in
    the library with no daemon, and never sends fastmap or the device
    route's aln there: they reach the port's CLI, which asks for the card
    (absent here)."""
    env = daemon["env"]
    r = _native(["mem", "--device", "cpu", world["prefix"], world["se"]],
                env)
    assert r.returncode == 0, r.stderr[-1000:]
    assert _records(r.stdout) == _records(
        _jax(["mem", world["prefix"], str(world["se"])]))
    want_sai = _jax(["aln", world["prefix"], str(world["se"])], binary=True)
    r = _native(["aln", "--device", "cpu", world["prefix"], world["se"]],
                env)
    assert r.returncode == 0 and r.stdout == want_sai
    assert b"request: ['aln'" in daemon["log"].read_bytes()
    r = _native(["xa2multi"], env, stdin=b"@HD\tVN:1.5\n")
    assert r.returncode == 0, r.stderr[-1000:]
    assert r.stdout == b"@HD\tVN:1.5\n"
    # no daemon: aln on the native route runs in the library (no Python)
    r = _native(["aln", world["prefix"], world["se"]], env,
                BWA_TPU_NO_DAEMON="1", BWA_TPU_PYTHON="/nonexistent")
    assert r.returncode == 0 and r.stdout == want_sai
    for args, extra in ((["fastmap", world["prefix"], world["se"]], {}),
                        (["aln", world["prefix"], world["se"]],
                         dict(BWA_TPU_ALN="device"))):
        r = _native(args, env, BWA_TPU_NO_DAEMON="1", **extra)
        assert r.returncode != 0
        assert b"torch.cuda.is_available() is false" in r.stderr, \
            r.stderr[-1000:]


def test_daemon_status_and_stop(world, daemon):
    run = lambda cmd: subprocess.run(
        [sys.executable, "-m", "bwa_tpu_torch.cli", "daemon", cmd,
         world["prefix"]], capture_output=True, cwd=REPO,
        env=daemon["env"], timeout=120)
    r = run("status")
    assert r.returncode == 0 and b"running" in r.stderr
    r = run("stop")
    assert r.returncode == 0 and b"stopped" in r.stderr
    assert daemon["proc"].wait(timeout=60) == 0
    assert not list(daemon["sockdir"].glob("*.sock"))
    r = run("status")
    assert r.returncode == 1 and b"not running" in r.stderr
