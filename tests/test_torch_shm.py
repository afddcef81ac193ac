"""`shm` in the port on the CPU: stage, list, attach and destroy under a
temporary BWA_TPU_SHM_DIR; mem on the attached index (read-only memmaps,
uploaded as copies) equals the disk-loaded run; a staging made by either
package attaches in the other and gives bwa_tpu's SAM.  Tolerance: none,
bytes equal, @ lines aside."""

import io
import warnings

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

torch.set_num_threads(1)

SHM_LINE = "[M::bwa_idx_load_from_shm]"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()
    d = tmp_path_factory.mktemp("torch_shm")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    write_fastq(d / "r.fq", simulate_reads(g, 32, read_len=150, seed=37,
                                           err_rate=0.02))
    return dict(prefix=index_build(str(d / "g.fa")), fq=str(d / "r.fq"))


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BWA_TPU_SHM_DIR", str(tmp_path))
    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    return tmp_path


def _mem(world, capsys, jax=False):
    """(SAM, stderr) of mem through one package's CLI, in process; the
    port's on the CPU, with any torch warning an error (a read-only
    memmap wrapped by torch.from_numpy warns)."""
    if jax:
        from bwa_tpu.cli import main
        extra = []
    else:
        from bwa_tpu_torch.cli import main
        extra = ["--device", "cpu"]
    out = io.StringIO()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        assert main(["mem", *extra, world["prefix"], world["fq"]],
                    out_fp=out) == 0
    return out.getvalue(), capsys.readouterr().err


def _records(sam: str) -> list[str]:
    return [ln for ln in sam.splitlines() if not ln.startswith("@")]


def test_shm_stage_list_attach_destroy(world, shm_dir, capsys):
    from bwa_tpu_torch import shm
    from bwa_tpu_torch.cli import main
    from bwa_tpu_torch.index.fmindex import FMIndex

    disk, err = _mem(world, capsys)
    assert SHM_LINE not in err
    assert main(["shm", world["prefix"]]) == 0
    assert shm.shm_test(world["prefix"])
    assert main(["shm", "-l"]) == 0
    name, size = capsys.readouterr().out.split("\n")[0].split("\t")
    assert name == "g.fa" and int(size) > 0
    assert main(["shm", world["prefix"]]) == 0
    assert "already in shared memory" in capsys.readouterr().err
    assert main(["shm", "-l", world["prefix"]]) == 1  # -l with an index

    fm = FMIndex.load(world["prefix"])
    assert SHM_LINE in capsys.readouterr().err
    disk_fm = FMIndex.load_from_disk(world["prefix"])
    for nm in ("ckpt", "words", "ssa", "pac"):
        a = getattr(fm, nm)
        assert isinstance(a, np.memmap) and not a.flags.writeable
        assert np.array_equal(a, getattr(disk_fm, nm)), nm
    assert fm.bnt.contigs == disk_fm.bnt.contigs
    via_shm, err = _mem(world, capsys)
    assert SHM_LINE in err
    assert via_shm == disk

    assert main(["shm", "-d"]) == 0
    assert not shm.shm_test(world["prefix"])
    assert not list(shm_dir.iterdir())
    again, err = _mem(world, capsys)
    assert SHM_LINE not in err and again == disk


@pytest.mark.parametrize("stager", ["jax", "port"])
def test_staging_attaches_in_the_other_package(world, shm_dir, capsys,
                                               stager):
    """A staging by bwa_tpu.shm attaches in the port, and the port's in
    bwa_tpu; mem then gives bwa_tpu's disk-loaded SAM in both."""
    from bwa_tpu import shm as jax_shm
    from bwa_tpu_torch import shm

    want, _ = _mem(world, capsys, jax=True)
    stage = jax_shm.shm_stage if stager == "jax" else shm.shm_stage
    assert stage(world["prefix"]) == 0
    port, err = _mem(world, capsys)
    assert SHM_LINE in err
    jax, err = _mem(world, capsys, jax=True)
    assert SHM_LINE in err
    assert _records(port) == _records(jax) == _records(want)
    assert _records(want)
    assert shm.shm_destroy() == 0
