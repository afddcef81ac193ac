"""The port's mesh (bwa_tpu_torch/parallel/mesh.py) on the CPU: eight CPU
shards against the JAX package's shard_map mesh on the eight JAX CPU
devices that tests/conftest.py provides, and against the port's own
single-device engine: the sharded seeding step's outputs, SE and PE SAM
bytes, aln .sai bytes, the dry run, and make_engine's meshing rule."""

import io
import types

import numpy as np
import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta
from test_torch_jax_native import jax_native

torch.set_num_threads(1)

N_SHARDS = 8


@pytest.fixture(autouse=True)
def small_caps(monkeypatch):
    """The JAX package's aln cap ladder (the plain gap machine's step costs
    the more the taller the stack; results do not depend on the caps)."""
    monkeypatch.setenv("BWA_TPU_ALN_CAPS", "64,128,256")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()
    d = tmp_path_factory.mktemp("torch_mesh")
    g = random_genome(150_000, seed=11, n_contigs=2)
    write_fasta(d / "g.fa", g)
    return dict(prefix=index_build(str(d / "g.fa")), genome=g)


@pytest.fixture(scope="module")
def engines(world):
    """The port's mesh engine (eight CPU shards), its single-device engine
    and bwa_tpu's engine, which is meshed over the eight JAX CPU devices."""
    from bwa_tpu.engine import make_engine as jax_engine
    from bwa_tpu.index.fmindex import FMIndex as JFMIndex
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.parallel.mesh import make_mesh

    fm = FMIndex.load(world["prefix"])
    jfm = JFMIndex.load(world["prefix"])
    mesh = make_mesh(devices=["cpu"] * N_SHARDS)
    jeng = jax_engine(jfm, "tpu")
    assert jeng.mesh is not None and jeng.mesh.devices.size == N_SHARDS
    return dict(fm=fm, jfm=jfm, mesh=make_engine(fm, "cpu", mesh=mesh),
                one=make_engine(fm, "cpu"), jax=jeng)


def _codes(rs):
    from bwa_tpu_torch.index.pack import NT4_TABLE

    return [NT4_TABLE[np.frombuffer(s, np.uint8)] for _, s, _ in rs]


def _lanes(world, tagged):
    """A bucket as collect_seeds_dispatch gets it: 80 bp reads two a lane
    (128 lanes), or 600 bp reads each sharded over several lanes.  (The
    plain machine's shards run one after another here, each as many steps
    as its longest lane.)"""
    from bwa_tpu_torch.mem.batch_seed import _pack_bucket
    from bwa_tpu_torch.options import MemOptions

    opt = MemOptions()
    if tagged:
        opt.apply_mode("pacbio")
        rs = simulate_reads(world["genome"], 12, read_len=600, seed=6,
                            err_rate=0.05, indel_rate=0.01)
    else:
        rs = simulate_reads(world["genome"], 200, read_len=80, seed=5,
                            err_rate=0.02)
    q, lens, _, _, _, cs, shard, _ = _pack_bucket(opt, _codes(rs), 24)
    return opt, q, lens, cs, shard


def _count_seed_calls(monkeypatch):
    """Each fm_machine.seed_machine call's lane count, in order."""
    from bwa_tpu_torch.ops import fm_machine

    calls = []
    real = fm_machine.seed_machine

    def counted(idx, q, *a, **kw):
        calls.append(int(q.shape[0]))
        return real(idx, q, *a, **kw)

    monkeypatch.setattr(fm_machine, "seed_machine", counted)
    return calls


@pytest.mark.parametrize("tagged", [False, True])
def test_machine_sharded_matches_jax_mesh(world, engines, monkeypatch,
                                          tagged):
    """machine_sharded over eight CPU shards: sorted seeds, seed_n, ovf,
    done_step and steps equal bwa_tpu.parallel.mesh.machine_sharded's, one
    machine a shard.  bwa_tpu's loop runs BWA_TPU_SEED_UNROLL steps an
    iteration (a TPU dispatch tactic that rounds its step count up), so
    it runs one step an iteration here."""
    import jax.numpy as jnp

    from bwa_tpu.parallel.mesh import machine_sharded as jax_sharded
    from bwa_tpu_torch.parallel.mesh import machine_sharded

    opt, q, lens, cs, shard = _lanes(world, tagged)
    assert q.shape[0] % N_SHARDS == 0 and (shard is not None) == tagged
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    consts = (opt.min_seed_len, split_len, opt.split_width,
              opt.max_mem_intv)
    kw = dict(cap=16, cap_s=cs, use_p3=bool(opt.max_mem_intv > 0),
              tagged=tagged)
    lane = tuple(np.asarray(a, np.int32) for a in shard) if tagged else ()
    monkeypatch.setenv("BWA_TPU_SEED_UNROLL", "1")
    jfn = jax_sharded(engines["jax"].idx, engines["jax"].mesh, *consts, **kw)
    want = [np.asarray(x) for x in jfn(
        jnp.asarray(q), jnp.asarray(lens), *map(jnp.asarray, lane))]
    calls = _count_seed_calls(monkeypatch)
    fn = machine_sharded(engines["mesh"].trees, engines["mesh"].mesh,
                         *consts, **kw)
    got = fn(q, lens, *lane)
    assert calls == [q.shape[0] // N_SHARDS] * N_SHARDS
    assert got[0].shape == want[0].shape
    for g, w, name in zip(got[:4], want[:4],
                          ("seeds", "seed_n", "ovf", "done_step")):
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), name
    assert got[4] == int(np.asarray(want[4]).reshape(-1)[0])
    assert (want[1] > 0).any()


def test_collect_seeds_off_mesh_when_lanes_do_not_divide(world, engines,
                                                        monkeypatch):
    """A bucket of 12 lanes, which 8 does not divide, runs once on the mesh
    engine's first device, equal to the single-device engine's (the SAM
    tests below take the sharded path)."""
    opt, q, lens, cs, _ = _lanes(world, False)
    want = engines["one"].collect_seeds(q[:12], lens[:12], opt, cs)
    calls = _count_seed_calls(monkeypatch)
    got = engines["mesh"].collect_seeds(q[:12], lens[:12], opt, cs)
    assert calls == [12]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _sam(mod, eng, fm, rs, pe):
    """SAM of reads rs through process_seqs of package `mod` on eng."""
    import importlib

    pipe = importlib.import_module(f"{mod}.mem.pipeline")
    types_ = importlib.import_module(f"{mod}.mem.types")
    options = importlib.import_module(f"{mod}.options")
    opt = options.MemOptions()
    if pe:
        opt.flag |= options.MEM_F_PE
    reads = [types_.Read(name=n, seq=s, qual=q) for n, s, q in rs]
    pipe.process_seqs(opt, eng, fm, reads, 0, None, None)
    return "".join(r.sam for r in reads)


@pytest.mark.parametrize("pe", [False, True])
def test_mesh_sam_equals_single_and_jax(world, engines, monkeypatch, pe):
    """SE (64 x 100 bp) and PE (32 pairs) SAM bytes: the port's mesh
    engine, its single-device engine and bwa_tpu's meshed engine agree."""
    from bwa_tpu_torch.parallel.dryrun import _pe_batch

    if pe:
        b2a = np.frombuffer(b"ACGTN", np.uint8)
        q = _pe_batch(engines["fm"], 32)
        rs = [(f"p{i // 2}", b2a[r].tobytes(), b"I" * len(r))
              for i, r in enumerate(q)]
    else:
        rs = simulate_reads(world["genome"], 64, read_len=100, seed=19,
                            err_rate=0.01)
    want = _sam("bwa_tpu", engines["jax"], engines["jfm"], rs, pe)
    assert want.count("\n") >= len(rs)
    assert _sam("bwa_tpu_torch", engines["one"], engines["fm"], rs,
                pe) == want
    calls = _count_seed_calls(monkeypatch)
    assert _sam("bwa_tpu_torch", engines["mesh"], engines["fm"], rs,
                pe) == want
    assert len(calls) >= N_SHARDS and calls.count(calls[0]) >= N_SHARDS


def _sai(mod, fm, eng, pk, fn):
    import importlib

    opts = importlib.import_module(f"{mod}.aln.opts")
    sai = importlib.import_module(f"{mod}.aln.sai")
    gopt = opts.GapOpt()
    out_n, rows = fn(fm, eng, pk, gopt)
    b = io.BytesIO()
    sai.SaiWriter(b, gopt).write_batch_raw(out_n, rows)
    return b.getvalue()


def test_mesh_aln_sai_equals_single_and_jax(world, engines, monkeypatch):
    """aln_batch_device .sai bytes of 32 x 60 bp reads: the port's mesh
    engine (K7's plain version a shard, 4 lanes each), its single engine
    and bwa_tpu's meshed engine (gap_machine_sharded) agree."""
    from bwa_tpu.aln.batch_search import aln_batch_device as jax_aln
    from bwa_tpu_torch.aln.batch_search import aln_batch_device
    from bwa_tpu_torch.ops import gap_machine as gm

    rng = np.random.default_rng(3)
    code2 = np.concatenate([engines["fm"].pac_codes,
                            3 - engines["fm"].pac_codes[::-1]])
    n, L = 32, 60
    st = rng.integers(0, engines["fm"].l_pac - L, n)
    reads = code2[st[:, None] + np.arange(L)].copy()
    mut = rng.random((n, L)) < 0.03
    reads[mut] = (reads[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    pk = types.SimpleNamespace(
        n=n, lens=np.full(n, L, np.int32),
        codes_off=np.arange(n + 1, dtype=np.int64) * L,
        codes_flat=reads.reshape(-1))
    want = _sai("bwa_tpu", engines["jfm"], engines["jax"], pk, jax_aln)
    assert _sai("bwa_tpu_torch", engines["fm"], engines["one"], pk,
                aln_batch_device) == want
    lanes = []
    real = gm.gap_machine
    monkeypatch.setattr(gm, "gap_machine", lambda idx, q, *a, **k: (
        lanes.append(int(q.shape[0])), real(idx, q, *a, **k))[1])
    assert _sai("bwa_tpu_torch", engines["fm"], engines["mesh"], pk,
                aln_batch_device) == want
    assert lanes[:N_SHARDS] == [n // N_SHARDS] * N_SHARDS


def test_dryrun_multichip_cpu_shards():
    from bwa_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(N_SHARDS, "cpu")


def test_pestat_allgather_joins_in_shard_order():
    from bwa_tpu_torch.parallel.mesh import make_mesh, pestat_allgather

    mesh = make_mesh(devices=["cpu"] * 4)
    parts = [torch.tensor([[s, 10 * s + j] for j in range(s + 1)],
                          dtype=torch.int32) for s in range(4)]
    got = pestat_allgather(mesh)(parts)
    assert torch.equal(got, torch.cat(parts))
    with pytest.raises(ValueError):
        pestat_allgather(mesh)(parts[:3])


def test_make_engine_meshes_only_many_cards(world, monkeypatch):
    """make_engine meshes a "cuda" engine only with more than one card
    visible and BWA_TPU_MESH not off; "cpu" and a named card never."""
    from bwa_tpu_torch import engine
    from bwa_tpu_torch.engine import make_engine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.parallel.mesh import make_mesh

    fm = FMIndex.load(world["prefix"])
    assert make_engine(fm, "cpu").mesh is None
    monkeypatch.setenv("BWA_TPU_MESH", "off")
    assert make_engine(fm, "cpu").mesh is None
    assert not engine.auto_mesh("cuda")
    monkeypatch.delenv("BWA_TPU_MESH")
    # a host with two cards, as make_engine sees it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert engine.auto_mesh("cuda")
    assert not engine.auto_mesh("cuda:1") and not engine.auto_mesh("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert not engine.auto_mesh("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for n in (None, 2):
        with pytest.raises(RuntimeError):
            make_mesh(n)
    mesh = make_mesh(devices=["cpu", "cpu"])
    eng = make_engine(fm, "cpu", mesh=mesh)
    assert eng.mesh is mesh and len(eng.trees) == 1
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"])
