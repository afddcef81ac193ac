"""The plain reference: its DP agrees with the port's native ksw on
random gapped inputs (extension and global alignment, both scorings),
and its records clip, reverse and pair as bwa's do."""

import numpy as np
import pytest

from portbench.reference import mem as ref

ILLUMINA = dict(match=1, mismatch=4, gap_open=6, gap_extend=1,
                clip_penalty=5, band_width=100, zdrop=100, min_seed_len=19)
PACBIO = dict(ILLUMINA, mismatch=1, gap_open=1, clip_penalty=0,
              min_seed_len=17)


@pytest.mark.parametrize("scoring", [ILLUMINA, PACBIO])
def test_dp_matches_the_native_ksw(scoring):
    from bwa_tpu_torch.ops.ksw_host import ksw_extend2, ksw_global2

    sc = ref.Scoring(scoring)
    mat = sc.mat.astype(np.int8)
    rng = np.random.default_rng(7)
    for _ in range(300):
        L = int(rng.integers(5, 250))
        t = rng.integers(0, 4, L + 20).astype(np.uint8)
        q = t[:L].copy()
        m = rng.random(L) < rng.choice([0.02, 0.05, 0.15])
        q[m] = (q[m] + rng.integers(1, 4, int(m.sum()))) % 4
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(1, len(q) - 1))
            q = (np.insert(q, p, rng.integers(0, 4)) if rng.random() < .5
                 else np.delete(q, p)).astype(np.uint8)
        w, h0 = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        assert tuple(ref.extend(sc, q, t, w, sc.pen_clip5, h0)) == tuple(
            ksw_extend2(q, t, mat, sc.o_del, sc.e_del, sc.o_ins, sc.e_ins,
                        w, sc.pen_clip5, sc.zdrop, h0))
        tt = t[:len(q) + int(rng.integers(-3, 4))]
        w = max(w, abs(len(tt) - len(q)) + 3)
        s, cig = ref.global2(sc, q, tt, w)
        s2, cig2 = ksw_global2(q, tt, mat, sc.o_del, sc.e_del, sc.o_ins,
                               sc.e_ins, w)
        assert (s, cig) == (s2, [tuple(c) for c in cig2])


def test_records_clip_reverse_and_pair():
    rng = np.random.default_rng(3)
    g = ref.Genome(rng.integers(0, 4, 5000).astype(np.uint8))
    sc = ref.Scoring(ILLUMINA)
    q = g.fetch(1000, 1150).copy()
    q[-2:] = (q[-2:] + 1) % 4  # two mismatches at the 3' end: clipped
    r = ref.record_of(sc, g, q, 1000)
    assert (r["flag"], r["pos"], r["cigar"], r["NM"], r["AS"]) == (
        0, 1001, "148M2S", 0, 148)
    q1 = g.fetch(2000, 2150).copy()
    q1[-1] = (q1[-1] + 1) % 4  # one at the end: reaching it scores more
    r1 = ref.record_of(sc, g, q1, 2000)
    assert (r1["cigar"], r1["NM"]) == ("150M", 1)
    # the mate on the reverse strand: its origin in the doubled text
    o2 = 2 * g.l_pac - (2000 + 350)
    r2 = ref.record_of(sc, g, g.fetch(o2, o2 + 150), o2)
    assert r2["flag"] == ref.REV and r2["pos"] == 2000 + 350 - 150 + 1
    a, b = ref.pair_records(r1, r2, ref.insert_bounds(350, 40))
    assert a["flag"] == ref.PAIRED | ref.PROPER | ref.MREV | ref.READ1
    assert b["flag"] == ref.PAIRED | ref.PROPER | ref.REV | ref.READ2
    assert (a["tlen"], b["tlen"], a["pnext"]) == (350, -350, r2["pos"])
