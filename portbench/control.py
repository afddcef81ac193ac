#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference put in
the program's place with every alignment score held in 8-bit saturating
integers (ksw's first SIMD pass), judged by the same comparison as a
run.  It has to read above the cell's limit on every seed.

    python3 portbench/control.py --workload <name> --seeds 1,2,3

Makes each seed's pool and sample as a run of the cell does, and prints
one JSON line a seed: the records compared, those that differ and their
share.  Needs no card and does not run the program.
"""

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BITS = 8  # the control's saturating width


def readings(workload: str, seeds, bits: int | None = BITS, bench=None):
    """(seed, judge's verdict) of the control on each seed."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import run

    bench = bench or run.load_benchmark()
    _, _, cfg, mix = run.cell_of(bench, workload)
    entry = importlib.import_module(f"portbench.entries.{mix['entry']}")
    for seed in seeds:
        cell = entry.Cell(cfg, mix, seed, "cpu")
        cell.make_inputs()
        yield seed, cell.judge(cell.control_answers(bits), log=sys.stderr)


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    for seed, v in readings(a.workload, seeds):
        v["share"] = v["differing"] / max(v["checked"], 1)
        print(json.dumps(dict(workload=a.workload, seed=seed, bits=BITS,
                              **v)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
