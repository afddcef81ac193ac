"""The deployment's reference: a genome made from the configuration's own
seed, and the port's index of it, built once into a fixed directory of
the checkout (build/portbench/<config>/) and loaded from there after."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def genome_codes(cfg: dict) -> np.ndarray:
    """The genome's codes (0-3) from the configuration's seed: uniform
    random sequence, one contig."""
    if cfg["contigs"] != 1:
        raise ValueError("the generator makes one contig")
    rng = np.random.default_rng(int(cfg["sequence_seed"]))
    return rng.integers(0, 4, int(cfg["genome_length"]), dtype=np.uint8)


def _write_fasta(path: Path, name: str, codes: np.ndarray) -> None:
    width = 70
    acgt = np.frombuffer(b"ACGT", np.uint8)
    full = len(codes) // width * width
    rows = np.empty((full // width, width + 1), np.uint8)
    rows[:, :width] = acgt[codes[:full]].reshape(-1, width)
    rows[:, width] = ord("\n")
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(rows.tobytes())
        if full < len(codes):
            f.write(acgt[codes[full:]].tobytes() + b"\n")


def index_prefix(cfg: dict, codes: np.ndarray) -> tuple[str, float | None]:
    """The index's prefix, built by the port's `index` when its stamp is
    missing: (prefix, seconds the build took, or None when it was there)."""
    d = ROOT / "build" / "portbench" / cfg["name"]
    fa = d / "genome.fa"
    stamp = d / "index.json"
    want = {k: cfg[k] for k in ("contigs", "genome_length", "sequence_seed",
                                "contig_name")}
    if stamp.exists() and json.loads(stamp.read_text()) == want:
        return str(fa), None
    d.mkdir(parents=True, exist_ok=True)
    stamp.unlink(missing_ok=True)
    t0 = time.perf_counter()
    _write_fasta(fa, cfg["contig_name"], codes)
    from bwa_tpu_torch.index.build import index_build

    index_build(str(fa))
    stamp.write_text(json.dumps(want))
    return str(fa), time.perf_counter() - t0
