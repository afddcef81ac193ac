"""The device aln search on the CPU: the port's plain gap machine and
width scan (bwa_tpu_torch/ops/gap_machine.py) against the JAX package's
ops/gap_machine.py on JAX CPU, and the port's aln_batch_device on a CPU
engine against bwa_tpu's native search, exactly."""

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

torch.set_num_threads(1)

N_READS = 64


@pytest.fixture(autouse=True)
def small_caps(monkeypatch):
    """The JAX package's cap ladder: a plain-version step costs the more
    the taller the stack (the results do not depend on the caps)."""
    monkeypatch.setenv("BWA_TPU_ALN_CAPS", "64,128,256")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()
    d = tmp_path_factory.mktemp("torch_gap")
    g = random_genome(200_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    # indel-heavy, higher error: gap states and the exact-match walk
    # (m == 0) are all exercised; 60 bp, so the seed region is active
    reads = simulate_reads(g, N_READS, read_len=60, seed=41, err_rate=0.03,
                           indel_rate=0.01)
    write_fastq(d / "r.fq", reads)
    return dict(prefix=index_build(str(d / "g.fa")), fq=d / "r.fq")


def _packed(mod, fq, opt):
    reader = mod.open_reads(opt.mode, str(fq))
    return mod.read_bt_packed(reader, 100000, opt.mode, opt.trim_qual)


def _jax_machine(prefix, fq, kw, cap, cap_a, max_steps):
    """bwa_tpu's cal_width_device and gap_machine over the reads, as its
    driver runs them (one bucket, every lane that is not skipped)."""
    import jax.numpy as jnp

    from bwa_tpu.aln import seqio
    from bwa_tpu.aln.batch_search import _init_state, _prep_chunk
    from bwa_tpu.aln.opts import GapOpt
    from bwa_tpu.engine import make_engine
    from bwa_tpu.index.fmindex import FMIndex
    from bwa_tpu.ops import gap_machine as jgm

    opt = GapOpt(**kw)
    fm = FMIndex.load(prefix)
    idx = make_engine(fm, "tpu").idx
    cdt = fm.coord_dtype
    pk = _packed(seqio, fq, opt)
    L, md, mg, orig, qc, seed_en, use_seed, swin, skip = _prep_chunk(pk, opt)
    lens = pk.lens.astype(np.int32)
    wb0 = jgm.cal_width_device(idx, jnp.asarray(orig.astype(np.int32)),
                               jnp.asarray(lens))
    sb = (jgm.cal_width_device(idx, jnp.asarray(swin.astype(np.int32)),
                               jnp.asarray(np.full(pk.n, swin.shape[1],
                                                   np.int32)))
          if use_seed else jnp.zeros((pk.n, 1, 2), cdt))
    state = _init_state(idx, cdt, opt, lens, md, mg, wb0, cap, cap_a, ~skip)
    i32 = np.int32
    scalars = (i32(opt.s_mm), i32(opt.s_gapo), i32(opt.s_gape),
               i32(opt.max_gape), i32(opt.max_seed_diff),
               i32(opt.max_entries), i32(opt.max_del_occ),
               i32(opt.indel_end_skip), i32(opt.max_top2),
               i32(opt.seed_len), i32(max_steps))
    out = jgm.gap_machine(
        state, idx, jnp.asarray(qc), jnp.asarray(lens), jnp.asarray(md),
        jnp.asarray(mg), jnp.asarray(seed_en), sb, *scalars, cap=cap,
        cap_a=cap_a, use_seed=use_seed, f_gape=bool(opt.mode & 0x01),
        f_nonstop=bool(opt.mode & 0x02), f_loggap=bool(opt.mode & 0x04))
    d = {k: np.asarray(v) for k, v in zip(jgm.GAP_KEYS, out)}
    d["steps"] = np.asarray([int(d["steps"])], np.int32)
    return np.asarray(wb0), np.asarray(sb), d


def _torch_machine(prefix, fq, kw, cap, cap_a, max_steps):
    from bwa_tpu_torch.aln import seqio
    from bwa_tpu_torch.aln.batch_search import _prep_chunk
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.ops import gap_machine as gm

    opt = GapOpt(**kw)
    idx = make_engine(FMIndex.load(prefix), "cpu").idx
    pk = _packed(seqio, fq, opt)
    L, md, mg, orig, qc, seed_en, use_seed, swin, skip = _prep_chunk(pk, opt)
    t = torch.from_numpy
    lens = t(pk.lens.astype(np.int32))
    wb0 = gm.cal_width_plain(idx, t(orig))
    sb = (gm.cal_width_plain(idx, t(swin)) if use_seed
          else torch.zeros((pk.n, 1, 2), dtype=idx["cdt"]))
    out = gm.gap_machine(
        idx, t(qc), lens, t(md), t(mg), t(seed_en), sb, wb0, t(~skip),
        tuple(getattr(opt, k) for k in gm.SCALARS), cap=cap, cap_a=cap_a,
        use_seed=use_seed, f_gape=bool(opt.mode & 0x01),
        f_nonstop=bool(opt.mode & 0x02), f_loggap=bool(opt.mode & 0x04),
        max_steps=max_steps)
    return wb0.numpy(), sb.numpy(), {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("kw,cap,cap_a,max_steps", [
    (dict(), 64, 32, 200000),                 # default options
    (dict(), 8, 2, 120),                      # the forced ladder's caps
    (dict(max_entries=20), 64, 32, 200000),   # the stack-size stop
], ids=["default", "ladder", "max_entries"])
def test_plain_machine_matches_jax(world, kw, cap, cap_a, max_steps):
    """cal_width_plain and gap_machine_plain against bwa_tpu's
    cal_width_device and gap_machine on every output of every lane, the
    overflowing ones included."""
    jw, js, jd = _jax_machine(world["prefix"], world["fq"], kw, cap, cap_a,
                              max_steps)
    tw, ts, td = _torch_machine(world["prefix"], world["fq"], kw, cap,
                                cap_a, max_steps)
    assert np.array_equal(tw, jw), "width table differs"
    assert np.array_equal(ts, js), "seed-region width table differs"
    for k in ("aln_m", "aln_kl", "n_aln", "n_stk", "ovf", "done_step",
              "steps"):
        assert td[k].dtype.itemsize == jd[k].dtype.itemsize, k
        assert np.array_equal(td[k], jd[k]), k
    # what each case drives: at cap 64 most lanes overflow (the driver's
    # next rungs take them) beside lanes with hits; at cap 8 most; with
    # -m 20 the stack-size stop ends lanes before they overflow
    if "max_entries" in kw:
        assert (jd["n_stk"] > 20).any() and not jd["ovf"].any()
    elif cap == 8:
        assert jd["ovf"].sum() > N_READS // 2
    else:
        assert jd["ovf"].any() and (jd["n_aln"] > 0).any()


def _batches(prefix, fq, kw):
    from bwa_tpu.aln import seqio as jseqio
    from bwa_tpu.aln.driver import _aln_batch_native
    from bwa_tpu.aln.opts import GapOpt as JGapOpt
    from bwa_tpu.index.fmindex import FMIndex as JFMIndex
    from bwa_tpu_torch.aln import seqio
    from bwa_tpu_torch.aln.batch_search import aln_batch_device
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex

    opt = GapOpt(**kw)
    fm = FMIndex.load(prefix)
    dev = aln_batch_device(fm, make_engine(fm, "cpu"), _packed(seqio, fq, opt),
                           opt)
    jopt = JGapOpt(**kw)
    nat = _aln_batch_native(JFMIndex.load(prefix),
                            _packed(jseqio, fq, jopt), jopt)
    return dev, nat


def _assert_equal(dev, nat, hits=True):
    assert np.array_equal(dev[0], nat[0]), "per-read aln counts differ"
    assert np.array_equal(dev[1], nat[1]), "aln records differ"
    assert (dev[0].sum() > 0) == hits  # -m 20 stops every search early


@pytest.mark.parametrize("kw", [
    dict(),                                     # default options
    dict(fnr=0.0, max_diff=2),                  # -n 2 (integer max_diff)
    dict(max_gapo=2, max_gape=3),               # gap-heavy
    dict(seed_len=20, max_seed_diff=1),         # tighter seed region
    dict(mode=0x02 | 0x04, fnr=0.0, max_diff=2),  # LOGGAP, no GAPE
    # -N: NONSTOP disables the best-first stop and max_diff narrowing
    dict(mode=0x03 | 0x10, fnr=0.0, max_diff=2, max_top2=0x7FFFFFFF),
    dict(trim_qual=20),                         # -q read trimming
    dict(s_mm=2, s_gapo=5, s_gape=2),           # -M/-O/-E rescaling
    dict(indel_end_skip=2, max_del_occ=3),      # -i/-d gate variants
    dict(max_entries=20),                       # the stack-size stop
], ids=["default", "n2", "gaps", "seed20", "loggap", "nonstop", "trim",
        "scores", "gates", "max_entries"])
def test_aln_batch_device_matches_native(world, kw):
    _assert_equal(*_batches(world["prefix"], world["fq"], kw),
                  hits="max_entries" not in kw)


def test_aln_batch_device_cap_ladder(world, monkeypatch):
    """Tiny caps force every rung: machine retry + host-spec fallback."""
    from bwa_tpu_torch.aln import batch_search

    monkeypatch.setenv("BWA_TPU_ALN_CAPS", "8,16")
    monkeypatch.setenv("BWA_TPU_ALN_CAPA", "2")
    monkeypatch.setenv("BWA_TPU_ALN_MAX_STEPS", "120")
    runs = []
    real = batch_search._run_lanes

    def spy(*a, **k):
        out = real(*a, **k)
        runs.append((len(a[2]), int(out[2].sum())))
        return out

    monkeypatch.setattr(batch_search, "_run_lanes", spy)
    _assert_equal(*_batches(world["prefix"], world["fq"], {}))
    # two rungs, the second on the first's overflowing lanes only, and
    # reads left for the host spec
    assert len(runs) == 2 and runs[1][0] == runs[0][1] and runs[1][1] > 0


def test_aln_batch_device_scratch_split(world, monkeypatch):
    """A rung whose lanes x cap x slot bytes pass SCRATCH_BYTES runs in
    several launches of at most that much scratch; the results are those
    of the native search."""
    from bwa_tpu_torch.aln import batch_search
    from bwa_tpu_torch.ops import gap_machine as gm

    # the launches' slots: 60 bp reads, int32 coordinates, compact records
    slot = gm.slot_bytes(torch.int32)
    monkeypatch.setattr(batch_search, "SCRATCH_BYTES", 64 * slot * 24)
    runs = []
    real = batch_search._run_lanes

    def spy(*a, **k):
        out = real(*a, **k)
        runs.append((a[7], len(a[2])))
        return out

    monkeypatch.setattr(batch_search, "_run_lanes", spy)
    _assert_equal(*_batches(world["prefix"], world["fq"], {}))
    first = [m for cap, m in runs if cap == 64]
    assert len(first) == -(-N_READS // 24) and max(first) == 24
    assert all(cap * m * slot <= 64 * slot * 24 for cap, m in runs)
    assert {cap for cap, _ in runs} >= {64, 128}


def test_int64_coords():
    """int64 coordinates (2*l_pac+2 >= 2^31 on GRCh38-scale genomes),
    forced on a small in-memory index: the plain machine's results equal
    bwa_tpu's host spec read for read."""
    import types

    from bwa_tpu.aln.batch_search import _host_fallback
    from bwa_tpu.aln.opts import GapOpt as JGapOpt
    from bwa_tpu.index.fmindex import FMIndex as JFMIndex
    from bwa_tpu.ops.fm_host import HostFM as JHostFM
    from bwa_tpu_torch.aln.batch_search import _prep_chunk, aln_batch_device
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.ops.fm import BatchedFMEngine

    jax_native()
    rng = np.random.default_rng(17)
    fwd = rng.integers(0, 4, 60000, dtype=np.uint8)
    jfm = JFMIndex.build_in_memory(fwd)
    fm = FMIndex(primary=jfm.primary, L2=jfm.L2, seq_len=jfm.seq_len,
                 ckpt=jfm.ckpt.astype(np.int64), words=jfm.words,
                 sa_intv=jfm.sa_intv, ssa=jfm.ssa.astype(np.int64),
                 bnt=jfm.bnt, pac=jfm.pac)
    eng = BatchedFMEngine(fm, device="cpu")
    dv = eng.dev
    dv.coord_dtype = np.int64
    dv.L2, dv.ckpt, dv.ssa = (t.to(torch.int64)
                              for t in (dv.L2, dv.ckpt, dv.ssa))
    eng.idx = dv.tree()
    assert eng.idx["cdt"] == torch.int64
    n, L = 48, 60
    starts = rng.integers(0, len(fwd) - L, n)
    reads = fwd[starts[:, None] + np.arange(L)].copy()
    muts = rng.random((n, L)) < 0.03
    reads[muts] = (reads[muts] + rng.integers(1, 4, int(muts.sum()))) % 4
    reads[0, 5] = 4  # one ambiguous base
    pk = types.SimpleNamespace(
        n=n, lens=np.full(n, L, np.int32),
        codes_off=np.arange(n + 1, dtype=np.int64) * L,
        codes_flat=reads.reshape(-1))
    opt = GapOpt()
    out_n, rows = aln_batch_device(fm, eng, pk, opt)
    _, md, mg, orig, _, _, _, _, skip = _prep_chunk(pk, opt)
    host = JHostFM(jfm)
    off = 0
    for i in range(n):
        exp = np.zeros((0, 8), np.int64)
        if not skip[i]:
            alns = _host_fallback(host, JGapOpt(), orig[i], L, md[i], mg[i])
            exp = np.array([[a.n_mm, a.n_gapo, a.n_gape, a.score, a.n_ins,
                             a.n_del, a.k, a.l] for a in alns],
                           np.int64).reshape(-1, 8)
        assert np.array_equal(rows[off:off + out_n[i]], exp), \
            f"read {i} differs"
        off += out_n[i]
    assert out_n.sum() > n // 2


def test_score_lists_bound():
    """K7's stack keeps one list a score up to the most a pushed entry can
    have, (max md + 1) * s_mm + max mg * s_gapo + max_gape * s_gape, or up
    to the key's SCORE_CAP; negative penalties are refused.  K7 slots are
    32-byte packed records with either coordinate type, and in the
    wide-record variant 48 bytes with int32 coordinates and 64 with
    int64."""
    from bwa_tpu_torch.aln.opts import GapOpt
    from bwa_tpu_torch.ops import gap_machine as gm

    opt = GapOpt()
    scal = tuple(getattr(opt, k) for k in gm.SCALARS)
    assert gm.score_lists(5, 1, scal) == \
        6 * opt.s_mm + opt.s_gapo + opt.max_gape * opt.s_gape + 1
    big = (10**6,) + scal[1:]
    assert gm.score_lists(5, 1, big) == gm.SCORE_CAP + 1
    with pytest.raises(ValueError):
        gm.score_lists(5, 1, (-1,) + scal[1:])
    assert (gm.slot_bytes(torch.int32), gm.slot_bytes(torch.int64)) == \
        (32, 32)
    assert (gm.slot_bytes(torch.int32, wide=True),
            gm.slot_bytes(torch.int64, wide=True)) == (48, 64)
