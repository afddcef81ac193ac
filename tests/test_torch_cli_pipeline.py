"""main_mem's reader/writer threads on the CPU: several chunks (-K) give
bwa_tpu's SAM and its chunk_done_hook sequence, and an error in the reader
(a truncated gzip FASTQ) or the writer (an output that fails) is raised by
the caller's thread, not a hang."""

import gzip
import io
import threading
import zlib

import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_cli_pipeline")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    return dict(prefix=index_build(str(d / "g.fa")), genome=g, dir=d)


def _run(main_mem, argv, out, timeout=120, hook=None):
    """main_mem(argv) in a thread of its own, under a time limit: (rc or
    the exception it raised, whether it ended)."""
    res = {}

    def go():
        try:
            res["rc"] = main_mem(argv, out, chunk_done_hook=hook)
        except BaseException as e:  # what the caller's thread sees
            res["rc"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout)
    return res.get("rc"), not t.is_alive()


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_main_mem_chunks_match_jax(world, monkeypatch, pe):
    """-K 1500: 40 reads of 150 bp in four chunks (SE), or 20 pairs in
    four chunks of five pairs (PE, two FASTQs); the SAM equals bwa_tpu's
    main_mem but for @PG, and the hook sees the same read counts."""
    from bwa_tpu.cli import main_mem as jax_main_mem
    from bwa_tpu_torch.cli import main_mem

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    d = world["dir"]
    if pe:
        r1, r2 = simulate_reads(world["genome"], 20, read_len=150, seed=91,
                                paired=True)
        fqs = [d / "pipe_1.fq", d / "pipe_2.fq"]
        write_fastq(fqs[0], r1)
        write_fastq(fqs[1], r2)
    else:
        fqs = [d / "pipe_se.fq"]
        write_fastq(fqs[0], simulate_reads(world["genome"], 40,
                                           read_len=150, seed=93,
                                           err_rate=0.02))
    args = ["-K", "1500", world["prefix"], *map(str, fqs)]
    outs, hooks = [], []
    for run, extra in ((jax_main_mem, []), (main_mem, ["--device", "cpu"])):
        out, seen = io.StringIO(), []
        rc, ended = _run(run, extra + args, out, hook=seen.append)
        assert ended and rc == 0
        outs.append([ln for ln in out.getvalue().splitlines()
                     if not ln.startswith("@PG")])
        hooks.append(seen)
    assert hooks[0] == [10, 10, 10, 10]
    assert hooks[1] == hooks[0]
    assert sum(not ln.startswith("@") for ln in outs[0]) >= 40
    assert outs[1] == outs[0]


def test_truncated_fastq_raises_in_caller(world, monkeypatch):
    """A gzip FASTQ cut in its third chunk: the reader thread's EOFError
    is raised by main_mem's caller, within the time limit."""
    from bwa_tpu_torch.cli import main_mem

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    d = world["dir"]
    rs = simulate_reads(world["genome"], 80, read_len=150, seed=95)
    plain = d / "trunc.fq"
    write_fastq(plain, rs)
    z = gzip.compress(plain.read_bytes())
    rec = len(plain.read_bytes()) // 80  # bytes a record
    # the first cut whose readable prefix ends inside chunk 3 (reads 20-29)
    for cut in range(len(z) // 10, len(z), 64):
        got = zlib.decompressobj(31).decompress(z[:cut])
        if 20 * rec < len(got) < 29 * rec:
            break
    else:
        raise AssertionError("no cut in the third chunk")
    gz = d / "trunc.fq.gz"
    gz.write_bytes(z[:cut])
    chunks = []
    rc, ended = _run(main_mem, ["--device", "cpu", "-K", "1500",
                                world["prefix"], str(gz)], io.StringIO(),
                     hook=chunks.append)
    assert ended, "main_mem hung on a truncated FASTQ"
    assert isinstance(rc, EOFError)
    assert len(chunks) <= 2


class _FailingOut(io.StringIO):
    """An output whose write fails from the n-th call on (a full disk)."""

    def __init__(self, n):
        super().__init__()
        self.n = n

    def write(self, s):
        self.n -= 1
        if self.n < 0:
            raise OSError(28, "No space left on device")
        return super().write(s)


def test_failing_output_raises_in_caller(world, monkeypatch):
    """The writer thread's error (the output fails after the header and
    15 records) is raised by main_mem's caller, within the time limit."""
    from bwa_tpu_torch.cli import main_mem

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    fq = world["dir"] / "fail.fq"
    write_fastq(fq, simulate_reads(world["genome"], 60, read_len=150,
                                   seed=97))
    out = _FailingOut(16)
    rc, ended = _run(main_mem, ["--device", "cpu", "-K", "1500",
                                world["prefix"], str(fq)], out)
    assert ended, "main_mem hung on a failing output"
    assert isinstance(rc, OSError) and rc.errno == 28
    assert out.getvalue().count("\n") >= 15
