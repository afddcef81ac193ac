"""BWA-backtrack end to end on the CPU: the .sai and SAM bytes of the
port's `aln`, `samse` and `sampe` (bwa_tpu_torch.cli) equal the JAX
package's (bwa_tpu.cli), both run in process through their cli.main.  The
port's `aln` runs with its default native search and with the device
search's plain version (BWA_TPU_ALN=device, --device cpu); the JAX
package's with its default, the native search."""

import io
import random

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

torch.set_num_threads(1)

COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build
    from bwa_tpu_torch.io.bam import write_bam

    jax_native()
    d = tmp_path_factory.mktemp("torch_aln")
    g = random_genome(200_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    # indel-heavy, higher error, 60 bp: gap states, the exact-match walk
    # and the seed region are all exercised
    write_fastq(d / "se.fq", simulate_reads(g, 200, read_len=60, seed=41,
                                            err_rate=0.03, indel_rate=0.01))
    # pairs with discordant (swapped) and garbled (rescued) mates, as
    # tests/test_backtrack.py::test_sampe_sam_hard makes them
    a, b = simulate_reads(g, 100, read_len=60, seed=43, err_rate=0.03,
                          indel_rate=0.01, paired=True, insert_mean=250,
                          insert_std=30)
    rnd = random.Random(5)
    for i in range(0, 30, 3):
        b[i], b[i + 1] = b[i + 1], b[i]
    b = [(n, s, q) if i % 7 else
         (n, bytes(rnd.choice(b"ACGT") for _ in range(len(s))), q)
         for i, (n, s, q) in enumerate(b)]
    a = [(f"p{i}", s, q) for i, (_, s, q) in enumerate(a)]
    b = [(f"p{i}", s, q) for i, (_, s, q) in enumerate(b)]
    write_fastq(d / "pe1.fq", a)
    write_fastq(d / "pe2.fq", b)
    # a few of tests/test_bam_input.py's BAM records
    r1, r2 = simulate_reads(g, 8, read_len=50, seed=77, err_rate=0.01,
                            indel_rate=0.002, paired=True, insert_mean=250,
                            insert_std=30)
    rng = np.random.default_rng(5)
    recs = []
    for (n1, s1, q1), (n2, s2, q2) in zip(r1, r2):
        f1, f2 = 0x1 | 0x40, 0x1 | 0x80
        if rng.random() < 0.5:
            f1 |= 0x10
            s1, q1 = s1.translate(COMP)[::-1], q1[::-1]
        if rng.random() < 0.5:
            f2 |= 0x10
            s2, q2 = s2.translate(COMP)[::-1], q2[::-1]
        recs.append((f1, n1, s1.decode(), q1.decode()))
        recs.append((f2, n2, s2.decode(), q2.decode()))
    recs.append((0, "solo", "ACGT" * 12 + "AC", "I" * 50))
    write_bam(d / "r.bam", recs, targets=[("ctg0", 100226)])
    return dict(prefix=prefix, dir=d)


@pytest.fixture(autouse=True)
def small_caps(monkeypatch):
    """The JAX package's cap ladder for the device search's plain version,
    whose step costs grow with the stack's cap (the results do not)."""
    monkeypatch.setenv("BWA_TPU_ALN_CAPS", "64,128,256")


def _run(pkg, args, binary):
    if pkg == "jax":
        from bwa_tpu.cli import main
    else:
        from bwa_tpu_torch.cli import main
    out = io.BytesIO() if binary else io.StringIO()
    assert main(list(args), out_fp=out) == 0
    return out.getvalue()


def _aln(world, extra, fq, search, monkeypatch):
    """(port .sai, JAX .sai) of `aln extra prefix fq`."""
    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    monkeypatch.delenv("BWA_TPU_ALN", raising=False)
    args = ["aln", *extra, world["prefix"], str(world["dir"] / fq)]
    want = _run("jax", args, True)
    if search == "device":
        monkeypatch.setenv("BWA_TPU_ALN", "device")
    mine = _run("torch", args[:1] + ["--device", "cpu"] + args[1:], True)
    monkeypatch.delenv("BWA_TPU_ALN", raising=False)
    return mine, want


def _nopg(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


def _sai(world, name, data):
    p = world["dir"] / name
    p.write_bytes(data)
    return str(p)


@pytest.mark.parametrize("search", ["native", "device"])
@pytest.mark.parametrize("extra", [[], ["-n", "6"], ["-o", "2"], ["-N"],
                                   ["-l", "20"], ["-q", "20"]],
                         ids=["default", "n6", "o2", "N", "l20", "q20"])
def test_aln_sai_bytes(world, monkeypatch, extra, search):
    mine, want = _aln(world, extra, "se.fq", search, monkeypatch)
    assert len(want) > 1000
    assert mine == want


@pytest.mark.parametrize("search", ["native", "device"])
def test_aln_bam_sai_bytes(world, monkeypatch, search):
    for extra in (["-b"], ["-b", "-1"], ["-b", "-2"], ["-b", "-0"]):
        mine, want = _aln(world, extra, "r.bam", search, monkeypatch)
        assert mine == want, extra


def test_samse_sam(world, monkeypatch):
    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    _, sai = _aln(world, [], "se.fq", "native", monkeypatch)
    sai = _sai(world, "se.sai", sai)
    fq = str(world["dir"] / "se.fq")
    for extra in ([], ["-n", "3"],
                  ["-r", "@RG\\tID:rg1\\tSM:s1"]):
        args = ["samse", *extra, world["prefix"], sai, fq]
        want = _run("jax", args, False)
        assert want.count("\n") > 200
        assert _nopg(_run("torch", args, False)) == _nopg(want), extra


def test_sampe_sam(world, monkeypatch):
    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    sais = [_sai(world, f"pe{i}.sai",
                 _aln(world, [], f"pe{i}.fq", "native", monkeypatch)[1])
            for i in (1, 2)]
    fqs = [str(world["dir"] / f"pe{i}.fq") for i in (1, 2)]
    for extra in ([], ["-s"], ["-n", "0", "-N", "0"], ["-a", "150"],
                  ["-A"]):
        args = ["sampe", *extra, world["prefix"], *sais, *fqs]
        want = _run("jax", args, False)
        assert want.count("\n") > 200
        assert _nopg(_run("torch", args, False)) == _nopg(want), extra
    # the Python spec of the paired finalize (BWA_TPU_SAMPE=spec) of each
    # package against the JAX package's native one
    want = _run("jax", ["sampe", world["prefix"], *sais, *fqs], False)
    monkeypatch.setenv("BWA_TPU_SAMPE", "spec")
    assert _nopg(_run("torch", ["sampe", world["prefix"], *sais, *fqs],
                      False)) == _nopg(want)


def test_samse_sampe_bam(world, monkeypatch):
    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    bam = str(world["dir"] / "r.bam")
    s1 = _sai(world, "b1.sai",
              _aln(world, ["-b", "-1"], "r.bam", "native", monkeypatch)[1])
    s2 = _sai(world, "b2.sai",
              _aln(world, ["-b", "-2"], "r.bam", "native", monkeypatch)[1])
    for args in (["samse", world["prefix"], s1, bam],
                 ["sampe", world["prefix"], s1, s2, bam, bam]):
        want = _run("jax", args, False)
        assert _nopg(_run("torch", args, False)) == _nopg(want), args[0]


def test_cli_usage(capsys):
    """The three commands are in the usage text; a short argument list
    prints the command's usage and exits 1."""
    from bwa_tpu_torch.cli import main

    assert main([]) == 1
    err = capsys.readouterr().err
    assert all(f"\n         {c} " in err for c in ("aln", "samse", "sampe"))
    for cmd in ("aln", "samse", "sampe"):
        assert main([cmd]) == 1
        assert "Usage:" in capsys.readouterr().err
