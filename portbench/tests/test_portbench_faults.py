"""A whole run on the CPU (the port's plain kernels, a 200 kb genome):
correct with the program as it is, and not correct with the timed path
broken underneath in each way a `mem` cell can be broken; the control
(the reference with 8-bit scores) reads above the cell's limit while the
reference in the program's place reads nothing.  Nothing of JAX, and
nothing of the JAX package, is loaded."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELL = "chr1_pe150"  # its limits; the configuration and mix are tiny


def tiny(bench_cell_of):
    def cell_of(bench, name):
        wl, ce, cfg, mix = bench_cell_of(bench, name)
        cfg = dict(cfg, name="portbench_test_200k", genome_length=200_000)
        mix = dict(mix, args=["-K", "15000"], pool_bases=30_000,
                   sample={"count": 400, "longest": 0})
        return wl, ce, cfg, mix
    return cell_of


def one_run(monkeypatch, capsys, breakage=None, seconds=6):
    from portbench import run

    monkeypatch.setattr(run, "cell_of", tiny(run.cell_of))
    if breakage is not None:
        breakage(monkeypatch)
    rc = run.run(["--workload", CELL, "--seed", str(2**32 + 11),
                  "--seconds", str(seconds), "--trace", "0"],
                 device="cpu", check_card=False)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def _wrap(monkeypatch, owner, attr, change):
    real = getattr(owner, attr)

    def broken(*a, **k):
        return change(real, *a, **k)

    monkeypatch.setattr(owner, attr, broken)


def state_unchanged(monkeypatch):
    """A chunk's reads leave as they came: no record filled in."""
    from bwa_tpu_torch.mem import pipeline

    _wrap(monkeypatch, pipeline, "process_seqs", lambda real, *a, **k: None)


def half_left_out(monkeypatch):
    """Only the first half of each chunk is aligned."""
    from bwa_tpu_torch.mem import pipeline

    def half(real, opt, engine, fm, reads, *a, **k):
        return real(opt, engine, fm, reads[:len(reads) // 2], *a, **k)

    _wrap(monkeypatch, pipeline, "process_seqs", half)


def answer_altered(monkeypatch):
    """Every eighth record's position moved by one where the finalize
    writes it."""
    from bwa_tpu_torch.mem import native_fin

    def moved(real, *a, **k):
        sams = real(*a, **k)
        out = []
        for i, s in enumerate(sams):
            if i % 8 == 0 and s:
                f = s.split("\t")
                f[3] = str(int(f[3]) + 1)
                s = "\t".join(f)
            out.append(s)
        return out

    for attr in ("finalize_se_arrays", "finalize_pe_arrays"):
        _wrap(monkeypatch, native_fin, attr, moved)


def test_sound_run_is_correct(monkeypatch, capsys):
    import sys

    r = one_run(monkeypatch, capsys)
    assert r["correct"], r["checks"]
    assert r["checks"]["records_differing_share"]["value"] == 0
    assert r["metrics"]["mem_bases_per_s"]["value"] > 0
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "bwa_tpu")]


@pytest.mark.parametrize("breakage", [state_unchanged, half_left_out,
                                      answer_altered])
def test_broken_timed_path_is_not_correct(monkeypatch, capsys, breakage):
    r = one_run(monkeypatch, capsys, breakage)
    assert not r["correct"], r["checks"]


def test_control_reads_above_the_limit():
    from portbench import control, run

    bench = run.load_benchmark()
    limit = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json")
                       .read_text())["records_differing_share"]
    orig = run.cell_of
    try:
        run.cell_of = tiny(orig)
        for seed, v in control.readings(CELL, [1, 2, 3], 8, bench):
            assert v["differing"] / v["checked"] > 10 * limit
        (_, exact), = control.readings(CELL, [4], None, bench)
        assert exact["differing"] == 0
    finally:
        run.cell_of = orig
