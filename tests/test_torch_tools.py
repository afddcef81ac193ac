"""The index tools and script equivalents on the CPU: each subcommand of the
port's CLI (bwa_tpu_torch.cli) against bwa_tpu's (bwa_tpu.cli), both run in
process.  File bytes of fa2pac, pac2bwt, pac2bwtgen, bwtupdate and bwt2sa;
stdout of maxk, pemerge, xa2multi and qualfa2fq; the bwtsw2 and dbwtsw
aliases.  Tolerance: none."""

import io
import shutil
import sys

import pytest

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()
    d = tmp_path_factory.mktemp("torch_tools")
    g = random_genome(120_000, seed=11, n_contigs=2, with_ns=True)
    write_fasta(d / "g.fa", g)
    reads = simulate_reads(g, 16, read_len=120, seed=23, err_rate=0.02)
    with open(d / "q.fa", "w") as f:
        for name, seq, _ in reads:
            f.write(f">{name}\n{seq.decode()}\n")
    with open(d / "q.qual", "w") as f:
        for name, _, qual in reads:
            f.write(f">{name}\n" + " ".join(str(c - 33) for c in qual)
                    + "\n")
    # overlapping pairs (insert shorter than two reads) and distant ones
    a, b = simulate_reads(g, 24, read_len=100, seed=29, err_rate=0.01,
                          paired=True, insert_mean=150, insert_std=20)
    a2, b2 = simulate_reads(g, 8, read_len=100, seed=31, err_rate=0.01,
                            paired=True, insert_mean=500, insert_std=40)
    write_fastq(d / "m1.fq", a + a2)
    write_fastq(d / "m2.fq", b + b2)
    return dict(prefix=index_build(str(d / "g.fa")), dir=d)


def _both(args, capsys, stdin=None, monkeypatch=None):
    """(bwa_tpu's, the port's) exit code and stdout for one command."""
    from bwa_tpu.cli import main as jax_main
    from bwa_tpu_torch.cli import main

    outs = []
    for run in (jax_main, main):
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        rc = run([str(a) for a in args])
        outs.append((rc, capsys.readouterr().out))
    return outs


def test_index_file_tools_match_jax(world, tmp_path, capsys):
    """fa2pac -> pac2bwt / pac2bwtgen -> bwtupdate -> bwt2sa, each step's
    file bytes equal between the packages (each package runs the chain on
    its own files)."""
    from bwa_tpu.cli import main as jax_main
    from bwa_tpu_torch.cli import main

    fa = world["dir"] / "g.fa"
    out = {}
    for tag, run in (("jax", jax_main), ("port", main)):
        d = tmp_path / tag
        d.mkdir()
        p = d / "p"
        assert run(["fa2pac", str(fa), str(p)]) == 0
        assert run(["pac2bwt", f"{p}.pac", f"{p}.bwt"]) == 0
        assert run(["pac2bwtgen", f"{p}.pac", f"{p}.gen.bwt"]) == 0
        shutil.copy(f"{p}.bwt", f"{p}.upd.bwt")
        assert run(["bwtupdate", f"{p}.upd.bwt"]) == 0
        assert run(["bwt2sa", f"{p}.upd.bwt", f"{p}.sa"]) == 0
        assert run(["bwt2sa", "-i", "16", f"{p}.upd.bwt",
                    f"{p}.16.sa"]) == 0
        out[tag] = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
    capsys.readouterr()
    assert sorted(out["port"]) == ["p.16.sa", "p.amb", "p.ann", "p.bwt",
                                   "p.gen.bwt", "p.pac", "p.sa",
                                   "p.upd.bwt"]
    for name, data in out["jax"].items():
        assert out["port"][name] == data, name
    # the chain rebuilds the index's own .bwt and .sa
    assert out["port"]["p.upd.bwt"] == \
        (world["dir"] / "g.fa.bwt").read_bytes()
    assert out["port"]["p.sa"] == (world["dir"] / "g.fa.sa").read_bytes()


@pytest.mark.parametrize("flags", [[], ["-s"]], ids=["default", "self"])
def test_maxk_matches_jax(world, capsys, flags):
    (rj, oj), (rp, op) = _both(["maxk", *flags, world["prefix"],
                                world["dir"] / "q.fa"], capsys)
    assert rj == rp == 0
    assert op == oj and len(op.splitlines()) == 256


@pytest.mark.parametrize("flags", [[], ["-m"], ["-u"], ["-T", "20"]],
                         ids=["default", "m", "u", "T20"])
def test_pemerge_matches_jax(world, capsys, flags):
    d = world["dir"]
    (rj, oj), (rp, op) = _both(["pemerge", *flags, d / "m1.fq",
                                d / "m2.fq"], capsys)
    assert rj == rp == 0
    assert op == oj and op


def test_xa2multi_matches_jax(world, capsys, monkeypatch):
    """bwa_tpu's mem SAM plus a record with two XA hits, from a file and
    from stdin."""
    from bwa_tpu.cli import main as jax_main

    d = world["dir"]
    sam = io.StringIO()
    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    fq = d / "q.fq"
    g = random_genome(120_000, seed=11, n_contigs=2, with_ns=True)
    write_fastq(fq, simulate_reads(g, 16, read_len=120, seed=23,
                                   err_rate=0.02))
    assert jax_main(["mem", "-h", "5", world["prefix"], str(fq)],
                    out_fp=sam) == 0
    text = sam.getvalue()
    text += ("r_xa\t0\tctg0\t101\t0\t20M\t*\t0\t0\t" + "A" * 20 + "\t"
             + "I" * 20 + "\tNM:i:0\t"
             + "XA:Z:ctg1,-501,20M,1;ctg0,+7001,20M,0;\n")
    (d / "xa.sam").write_text(text)
    (rj, oj), (rp, op) = _both(["xa2multi", d / "xa.sam"], capsys)
    assert rj == rp == 0 and op == oj
    assert len(op.splitlines()) > len(text.splitlines())  # XA expanded
    (rj, oj), (rp, op) = _both(["xa2multi"], capsys, stdin=text,
                               monkeypatch=monkeypatch)
    assert rj == rp == 0 and op == oj


def test_qualfa2fq_matches_jax(world, capsys):
    d = world["dir"]
    (rj, oj), (rp, op) = _both(["qualfa2fq", d / "q.fa", d / "q.qual"],
                               capsys)
    assert rj == rp == 0
    assert op == oj and op.startswith("@")


@pytest.mark.parametrize("cmd", ["bwtsw2", "dbwtsw", "bwasw"])
def test_bwasw_aliases(capsys, cmd):
    """`bwtsw2`/`dbwtsw` dispatch to bwasw (main.c:107-109): no arguments
    give bwasw's usage and rc 1 in both packages, not "unrecognized"."""
    from bwa_tpu.cli import main as jax_main
    from bwa_tpu_torch.cli import main

    errs = []
    for run in (jax_main, main):
        assert run([cmd]) == 1
        errs.append(capsys.readouterr().err)
    for err in errs:
        assert "unrecognized" not in err and "bwasw [options]" in err
