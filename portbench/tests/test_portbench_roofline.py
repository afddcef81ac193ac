"""Each roofline's work function gives the bound PERF.md recorded from
the counts recorded there (NVIDIA H100 peaks)."""

import pytest

from portbench import run
from portbench.peaks import bound_s


def test_k1_se_bound():
    k1 = run.load_reader("k1_roofline")
    # mem_se_150bp's K1 launch: B=2048 L=386, 2,006,940 lane steps,
    # R = 4 occtab rows (32 text words), 8,589,120 bytes -> 0.04847 ms
    _, ops = k1.work(0, 0, 0, 0, 0, 2_006_940, 32)
    assert ops == 810_803_760
    assert bound_s(8_589_120, ops) * 1e3 == pytest.approx(0.04847, abs=5e-6)


def test_k8_bound():
    k8 = run.load_reader("k8_roofline")
    # 24,576 x 192 codes, 547,480 two-end and 3,114,344 one-end
    # extensions, 32 text words -> 0.02590 ms (operations)
    nbytes, ops = k8.work(24_576 * 192, 0, 24_576, 547_480, 3_114_344,
                          24_576 * 192, 32)
    assert ops == 433_288_312
    assert bound_s(nbytes, ops) * 1e3 == pytest.approx(0.02590, abs=5e-6)
