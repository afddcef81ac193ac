"""The port's multi-host module (bwa_tpu_torch/parallel/multihost.py) on
the CPU: two hosts' shards merged equal one host's output and bwa_tpu's
one-host output (SE and PE), the seek path reads about its own share of
the input and gives the gzip streaming path's bytes, and two real
processes over gloo on 127.0.0.1 merge to one process's bytes.  The index
is the port's own (`index_build`); bwa_tpu loads the same files."""

import gzip
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CHUNK = 7_000  # -K: three batches of up to 70 reads (or 35 pairs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu_torch.index.build import index_build

    d = tmp_path_factory.mktemp("torch_multihost")
    g = random_genome(150_000, seed=17, n_contigs=2)
    write_fasta(d / "g.fa", g)
    write_fastq(d / "se.fq", simulate_reads(g, 200, read_len=100, seed=57,
                                            err_rate=0.01,
                                            indel_rate=0.001))
    r1, r2 = simulate_reads(g, 100, read_len=100, seed=58, paired=True)
    write_fastq(d / "pe_1.fq", r1)
    write_fastq(d / "pe_2.fq", r2)
    return dict(prefix=index_build(str(d / "g.fa")), se=d / "se.fq",
                pe=(d / "pe_1.fq", d / "pe_2.fq"))


def _opt(mod="bwa_tpu_torch"):
    import importlib

    o = importlib.import_module(f"{mod}.options").MemOptions()
    o.chunk_size = CHUNK
    o.n_threads = 1
    return o


def _fqs(world, pe):
    return (str(world["pe"][0]), str(world["pe"][1])) if pe \
        else (str(world["se"]), None)


def _merged(shard_dir, out):
    from bwa_tpu_torch.parallel.multihost import merge_shards

    merge_shards(str(shard_dir), str(out))
    return out.read_text()


@pytest.mark.parametrize("pe", [False, True])
def test_two_hosts_merge_equals_one_host_and_jax(world, tmp_path, pe):
    from bwa_tpu.parallel.multihost import align_shard as jax_shard
    from bwa_tpu_torch.parallel.multihost import align_shard

    fq1, fq2 = _fqs(world, pe)
    n = [align_shard(world["prefix"], fq1, fq2, h, 2, str(tmp_path / "two"),
                     opt=_opt(), device="cpu") for h in range(2)]
    assert n == [2, 1]  # three batches, dealt j % 2
    two = _merged(tmp_path / "two", tmp_path / "two.sam")
    align_shard(world["prefix"], fq1, fq2, 0, 1, str(tmp_path / "one"),
                opt=_opt(), device="cpu")
    assert two == _merged(tmp_path / "one", tmp_path / "one.sam")
    jax_native()
    jax_shard(world["prefix"], fq1, fq2, 0, 1, str(tmp_path / "jax"),
              opt=_opt("bwa_tpu"), engine_kind="tpu")
    assert two == _merged(tmp_path / "jax", tmp_path / "jax.sam")
    assert two.count("\n") >= 200


def test_seek_path_reads_about_its_share(world, tmp_path):
    """With the pre-scanned offset table each host reads well under the
    whole file (the two shares cover it), and the merged bytes equal the
    streaming path's on the gzipped input."""
    from bwa_tpu_torch.parallel import multihost
    from bwa_tpu_torch.parallel.multihost import (align_shard,
                                                  scan_batch_offsets)

    fq = world["se"]
    total = fq.stat().st_size
    offsets = scan_batch_offsets(_opt(), str(fq), None)
    assert len(offsets) == 3
    per_host = []
    for h in range(2):
        align_shard(world["prefix"], str(fq), None, h, 2,
                    str(tmp_path / "seek"), opt=_opt(), device="cpu",
                    offsets=offsets)
        per_host.append(multihost.last_bytes_read)
    for n in per_host:
        assert n < 0.75 * total, (n, total)
    assert sum(per_host) < 1.25 * total
    gz = tmp_path / "r.fq.gz"
    gz.write_bytes(gzip.compress(fq.read_bytes()))
    for h in range(2):
        align_shard(world["prefix"], str(gz), None, h, 2,
                    str(tmp_path / "gz"), opt=_opt(), device="cpu")
    assert _merged(tmp_path / "seek", tmp_path / "seek.sam") == \
        _merged(tmp_path / "gz", tmp_path / "gz.sam")


def test_two_gloo_processes_merge_equals_one_process(world, tmp_path):
    """Two `python -m bwa_tpu_torch.parallel.multihost --device cpu`
    processes with torchrun's variables over gloo on 127.0.0.1: host 0's
    merged file equals one process's output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, "-m", "bwa_tpu_torch.parallel.multihost",
            world["prefix"], str(world["se"]), "--device", "cpu",
            "--chunk-size", str(CHUNK)]
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        out = ["--out", str(tmp_path / "merged.sam")] if rank == 0 else []
        procs.append(subprocess.Popen(
            base + ["--shard-dir", str(tmp_path / "shards")] + out,
            env=dict(env, RANK=str(rank)), cwd=REPO,
            stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    solo = {k: v for k, v in env.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE")}
    one = subprocess.run(
        base + ["--shard-dir", str(tmp_path / "one"), "--out",
                str(tmp_path / "one.sam")],
        env=solo, cwd=REPO, capture_output=True, timeout=240)
    assert one.returncode == 0, one.stderr.decode()[-2000:]
    merged = (tmp_path / "merged.sam").read_text()
    assert merged == (tmp_path / "one.sam").read_text()
    assert merged.count("\n") >= 200
    assert sorted(p.name for p in (tmp_path / "shards").glob("batch*")) \
        == [f"batch{j:08d}.sam" for j in range(3)]
