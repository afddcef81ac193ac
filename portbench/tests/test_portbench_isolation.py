"""The harness and its reference load nothing of JAX or of the JAX
package, the reference nothing of the program; a measuring run without
a card exits non-zero and prints no result."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "bwa_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = loaded("import portbench.reference.mem, portbench.traffic, "
                  "portbench.genome, portbench.control")
    assert not tops & (BANNED | {"bwa_tpu_torch"})


def test_harness_loads_nothing_of_jax():
    tops = loaded("import portbench.run, portbench.entries.mem, "
                  "portbench.trace\nfrom portbench import run\n"
                  "[run.load_reader(m['name']) for m in "
                  "run.load_benchmark()['per_layer']]\n"
                  "import bwa_tpu_torch.cli, bwa_tpu_torch.mem.pipeline")
    assert not tops & BANNED


def test_run_without_a_card_exits_nonzero():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "chr1_pe150",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    assert p.returncode != 0
    assert "{" not in p.stdout
