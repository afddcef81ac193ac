"""BENCHMARK.json's cells, configurations, mixes and metrics resolve by
name to files of their own, and keep the contract's naming rules."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_cells_resolve_by_name():
    from portbench import run

    b = bench()
    for wl in b["workloads"]:
        w, ce, cfg, mix = run.cell_of(b, wl["name"])
        assert cfg["name"] == ce["name"] == w["config"]
        assert mix["entry"] == "mem"
        assert (ROOT / "portbench" / "entries" / f"{mix['entry']}.py").exists()
        limits = json.loads((ROOT / "portbench" / "limits"
                             / f"{wl['name']}.json").read_text())
        assert 0 <= limits["records_differing_share"] < 1
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = {m["name"] for m in run.metrics_of(b, w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_of(b, w, "per_layer")


def test_metric_readers_load_by_name():
    from portbench import run

    for m in bench()["per_layer"]:
        mod = run.load_reader(m["name"])
        assert callable(mod.read)
        assert m["moves"] in {e["name"] for e in bench()["end_to_end"]}


def test_names_units_and_files():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/") and (ROOT / f).exists()
    setup = next(m for m in b["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(b)) < 64 * 1024
