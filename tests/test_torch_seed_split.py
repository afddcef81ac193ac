"""The seeding routes off the default path, in plain PyTorch, against the
JAX package on its CPU backend, tolerance 0 (integers throughout):

  * the split route's machines, smem_machine (pass 1, pass 2 from pass 1's
    rows) and seed3_machine, whose kernel is K12 (K1's state mode with a
    stage range), at default and tiny caps, int32 and int64 coordinates;
  * segment in segments on a typed state (the plain version of K13 on
    its plain dict), the state held field by field after each segment;
  * engine.collect_seeds under BWA_TPU_SEED_MACHINE=split and
    BWA_TPU_SEED_COMPACT, last_done and last_steps included, the latter on
    about 1,080 lanes compacted twice; and where bwa_tpu's compaction stops
    short (a run-out segment after the first: its int32 step budget
    wraps), the port's runs out and equals the unified route;
  * mem SE, PE and -5 through process_seqs under each route, SAM equal to
    bwa_tpu's under the same environment; lane-sharded -x pacbio reads
    fail under each route as bwa_tpu's do, -x pacbio -5 completes.

bwa_tpu's machine loop runs BWA_TPU_SEED_UNROLL steps an iteration (a TPU
dispatch tactic that rounds its step counts up): the module runs it one
step an iteration, on a genome of its own so that no program traced
another way is reused.  The kernels are held to these plain versions in
test_torch_cuda.py."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datagen import random_genome, simulate_reads, write_fasta
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)

CONSTS = (19, 28, 10, 20)  # min_seed_len, split_len, split_width, max_intv
ROUTES = {"split": ("BWA_TPU_SEED_MACHINE", "split"),
          "compact": ("BWA_TPU_SEED_COMPACT", "1")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build
    from bwa_tpu.index.fmindex import FMIndex as JFM
    from bwa_tpu.index.fmindex import DeviceFMIndex as JDev
    from bwa_tpu.ops.fm import BatchedFMEngine as JEngine
    from bwa_tpu_torch.index.fmindex import FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE
    from bwa_tpu_torch.ops.fm import BatchedFMEngine

    jax_native()  # built once, under a lock, before index_build
    saved = {k: os.environ.get(k) for k in ("BWA_TPU_SEED_UNROLL",
                                            "BWA_TPU_MESH")}
    os.environ["BWA_TPU_SEED_UNROLL"] = "1"
    d = tmp_path_factory.mktemp("torch_seed_split")
    g = random_genome(110_000, seed=47, n_contigs=2)
    # a 4 kb stretch of contig 1 again at the end of contig 2, 1% of its
    # bases changed: reads from it re-seed in pass 2
    rng = np.random.default_rng(3)
    rep = np.frombuffer(g[0][1][10_000:14_000], np.uint8).copy()
    at = rng.choice(rep.size, 40, replace=False)
    rep[at] = np.frombuffer(b"ACGT", np.uint8)[
        (np.searchsorted(np.frombuffer(b"ACGT", np.uint8), rep[at]) + 1) % 4]
    g = [g[0], (g[1][0], g[1][1] + rep.tobytes())]
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    os.environ["BWA_TPU_MESH"] = "off"  # one JAX device: no shard_map
    jeng = JEngine(JFM.load(prefix))
    os.environ.pop("BWA_TPU_MESH")
    if saved["BWA_TPU_MESH"] is not None:
        os.environ["BWA_TPU_MESH"] = saved["BWA_TPU_MESH"]
    fm = FMIndex.load(prefix)

    def codes(n, length, seed):
        return [NT4_TABLE[np.frombuffer(s, np.uint8)] for _, s, _ in
                simulate_reads(g, n, read_len=length, seed=seed,
                               err_rate=0.02)]

    yield dict(prefix=prefix, genome=g, fm=fm, jeng=jeng, codes=codes,
               jt=JDev(JFM.load(prefix)).tree(),
               eng=BatchedFMEngine(fm, device="cpu"),
               short=codes(12, 150, 5) + [
                   NT4_TABLE[np.frombuffer(s, np.uint8)] for _, s, _ in
                   simulate_reads([("rep", g[0][1][10_000:14_000])], 12,
                                  read_len=150, seed=6, err_rate=0.01)])
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _mat(codes, L):
    q = np.full((len(codes), L), 4, np.uint8)
    ql = np.array([len(c) for c in codes], np.int32)
    for i, c in enumerate(codes):
        q[i, :len(c)] = c
    return q, ql


def _packed_pairs(codes, L):
    """pack_k=2 lanes: read i | N | read B2+i | N (mem/batch_seed.py)."""
    B2 = len(codes) // 2
    q = np.full((B2, 2 * (L + 1)), 4, np.uint8)
    ql = np.zeros(B2, np.int32)
    for r in range(2):
        for i in range(B2):
            c = codes[r * B2 + i]
            q[i, r * (L + 1):r * (L + 1) + len(c)] = c
            ql[i] = r * (L + 1) + len(c)
    return q, ql


def _i64(a):
    return (a.numpy() if torch.is_tensor(a) else np.asarray(a)) \
        .astype(np.int64)


def _tree64(tt):
    return dict(tt, cdt=torch.int64, L2=tt["L2"].long(),
                ckpt=tt["ckpt"].long())


def _jax_split(world, q, ql, cap, cap_s):
    """bwa_tpu's three machines, as its split route calls them."""
    from bwa_tpu.ops import fm_machine as jm
    from bwa_tpu.ops.fm import _next_valid_device

    qd, qld = jnp.asarray(q), jnp.asarray(ql)
    nv = _next_valid_device(qd, qld)
    c = [np.int32(v) for v in CONSTS]
    B = q.shape[0]
    s0 = jnp.zeros((B, cap_s, 5), jnp.int32)
    n0 = jnp.zeros(B, jnp.int32)
    p1 = jm.smem_machine(world["jt"], qd, qld, nv, *c[:3], s0, n0, n0,
                         cap=cap, cap_s=cap_s, pass2=False)
    p2 = jm.smem_machine(world["jt"], qd, qld, nv, *c[:3], p1[0], p1[1],
                         p1[1], cap=cap, cap_s=cap_s, pass2=True)
    p3 = jm.seed3_machine(world["jt"], qd, qld, nv, c[0], c[3], p2[0],
                          p2[1], cap_s=cap_s)
    return [[_i64(np.asarray(o)) for o in p] for p in (p1, p2, p3)]


def _torch_split(tt, q, ql, cap, cap_s):
    from bwa_tpu_torch.ops import fm_machine as tm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    qd, qld = torch.from_numpy(q), torch.from_numpy(ql)
    nv = _next_valid_device(qd, qld)
    B = q.shape[0]
    s0 = torch.zeros((B, cap_s, 5), dtype=tt["cdt"])
    n0 = torch.zeros(B, dtype=torch.int32)
    p1 = tm.smem_machine(tt, qd, qld, nv, *CONSTS[:3], s0, n0, n0, cap=cap,
                         cap_s=cap_s, pass2=False)
    p2 = tm.smem_machine(tt, qd, qld, nv, *CONSTS[:3], p1[0], p1[1], p1[1],
                         cap=cap, cap_s=cap_s, pass2=True)
    p3 = tm.seed3_machine(tt, qd, qld, nv, CONSTS[0], CONSTS[3], p2[0],
                          p2[1], cap_s=cap_s)
    return [[_i64(o) for o in p] for p in (p1, p2, p3)], \
        (p1[0].dtype, p3[0].dtype)


@pytest.mark.parametrize("cap,cap_s", [(16, 48), (2, 4)],
                         ids=["default_caps", "tiny_caps"])
def test_split_machines_match_jax(world, cap, cap_s):
    """Pass 1, pass 2 and pass 3 each equal bwa_tpu's output for output:
    the seeds as emitted (unsorted), seed_n, steps, and the SMEM passes'
    ovf and done_step; at int64 coordinates equal to the port's int32."""
    q, ql = _packed_pairs(world["short"], 192)
    want = _jax_split(world, q, ql, cap, cap_s)
    got, dts = _torch_split(world["eng"].idx, q, ql, cap, cap_s)
    for p, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(a, b, err_msg=f"pass {p + 1} "
                                                        f"output {i}")
    assert dts == (torch.int32, torch.int32)
    assert (want[1][1] > want[0][1]).any()  # pass 2 added seeds
    assert (want[2][1] > want[1][1]).any()  # and pass 3
    if cap < 10:
        assert want[0][3].any() and (want[1][1] > cap_s).any()
    got64, dts = _torch_split(_tree64(world["eng"].idx), q, ql, cap, cap_s)
    assert dts == (torch.int64, torch.int64)
    for g, w in zip(got64, got):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _jax_state(world, q, ql, cap, cap_s, sizes):
    """bwa_tpu's seed_machine_seg run in segments of `sizes` steps: its
    state after each, as a dict."""
    from bwa_tpu.ops import fm_machine as jm
    from bwa_tpu.ops.fm import _next_valid_device

    qd, qld = jnp.asarray(q), jnp.asarray(ql)
    nv = _next_valid_device(qd, qld)
    st = jm.seed_state_init(q.shape[0], cap, cap_s, jnp.int32)
    out = []
    for n in sizes:
        st = jm.seed_machine_seg(st, world["jt"], qd, qld, nv,
                                 *(np.int32(c) for c in CONSTS),
                                 jnp.int32(n), cap=cap, cap_s=cap_s,
                                 use_p3=True)
        out.append({k: np.asarray(v) for k, v in zip(jm.SEED_KEYS, st)})
    return out


@pytest.mark.parametrize("cap,cap_s", [(16, 48), (3, 8)],
                         ids=["default_caps", "tiny_caps"])
def test_segments_resume_exactly(world, cap, cap_s):
    """seed_machine_seg run in segments (of odd sizes: a segment ends
    inside backward rows) holds bwa_tpu's state field by field after each
    segment, stacks, seed store and qualification bits included; the last
    state's seeds equal one run to the end."""
    from bwa_tpu_torch.ops import fm_machine as tm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    q, ql = _packed_pairs(world["short"], 192)
    sizes = [37, 53, 101, 1, 64, 100_000]
    want = _jax_state(world, q, ql, cap, cap_s, sizes)
    tt = world["eng"].idx
    qd, qld = torch.from_numpy(q), torch.from_numpy(ql)
    nv = _next_valid_device(qd, qld)
    d = tm.typed_state(q.shape[0], cap, cap_s, tt["cdt"], "cpu")
    mid_row = 0
    for n, w in zip(sizes, want):
        d = tm.segment(d, tt, qd, qld, nv, *CONSTS, n, cap, cap_s, True)
        p = tm.plain_dict(d)
        for k in tm.SEG_FIELDS + ("stkA", "stkB", "seeds", "qmask",
                                  "steps"):
            np.testing.assert_array_equal(_i64(p[k]), _i64(w[k]),
                                          err_msg=f"{k} after {n} steps")
        mid_row += int(((w["phase"] == tm.P_BWD) & (w["j"] > 0)).sum())
    assert mid_row > 0  # some segment ended inside a backward row
    assert (want[-1]["phase"] == tm.P_DONE).all()
    one = tm.seed_machine_plain(tt, qd, qld, nv, *CONSTS, cap=cap,
                                cap_s=cap_s, use_p3=True)
    np.testing.assert_array_equal(_i64(d["seeds"]), _i64(one[0]))
    np.testing.assert_array_equal(_i64(d["steps"]), _i64(one[2]))


def _route_lanes(world):
    """About 1,080 one-read lanes that bwa_tpu's compaction at segments of 150
    steps runs to the end: 430 lanes done by step 150, 350 by 300 and 300
    by 450 (bwa_tpu's unified done_step), so that two compactions (to
    1,024 lanes, then 512) leave no lane to a segment after 256 lanes or a
    run-out, where bwa_tpu's step budget wraps."""
    from bwa_tpu.options import MemOptions as JOpt

    if "route_lanes" in world:
        return world["route_lanes"]
    codes = []
    for i, n in enumerate((30, 50, 70, 90, 110)):
        codes += world["codes"](500, n, 10 + i)
    q, ql = _mat(codes, 128)
    world["jeng"].collect_seeds(q, ql, JOpt(), 24)
    ds = world["jeng"].last_done[0]
    sel = np.concatenate([np.nonzero(ds <= 150)[0][:450],
                          np.nonzero((ds > 150) & (ds <= 300))[0][:350],
                          np.nonzero((ds > 300) & (ds <= 450))[0][:300]])
    sel = sel[np.random.default_rng(0).permutation(sel.size)]
    world["route_lanes"] = q[sel], ql[sel]
    return world["route_lanes"]


def _collect(eng, opt, q, ql, cap_s, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        return eng.collect_seeds(q, ql, opt, cap_s), eng.last_done, \
            eng.last_steps
    finally:
        for k in env:
            monkeypatch.delenv(k)


@pytest.mark.parametrize("route", ["split", "compact", "split_tiny_stack"])
def test_collect_seeds_routes_match_jax(world, monkeypatch, route):
    from bwa_tpu.options import MemOptions as JOpt
    from bwa_tpu_torch.options import MemOptions

    env = {"BWA_TPU_SEED_SEG": "150", "BWA_TPU_SEED_SEG2": "150"}
    if route == "split_tiny_stack":
        # a stack cap of 3 overflows lanes (their seed_n reads cap_s + 1);
        # the route takes BWA_TPU_STACK_CAP alone, not stack_cap
        env = {"BWA_TPU_STACK_CAP": "3"}
    env.update([ROUTES[route.split("_")[0]]])
    if route == "split_tiny_stack":
        q, ql = _packed_pairs(world["short"], 192)
    else:
        q, ql = _route_lanes(world)
    want = _collect(world["jeng"], JOpt(), q, ql, 24, env, monkeypatch)
    got = _collect(world["eng"], MemOptions(), q, ql, 24, env, monkeypatch)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(_i64(a), _i64(b))
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(_i64(a), _i64(b))
    assert got[2] == want[2]
    if route == "compact":
        levels = world["eng"].last_levels
        assert levels[0][0] > 1024 and \
            [lv[0] for lv in levels[1:]] == [1024, 512], levels
        unified = world["jeng"].collect_seeds(q, ql, JOpt(), 24)
        for a, b in zip(got[0], unified):
            np.testing.assert_array_equal(_i64(a), _i64(b))
    if route == "split_tiny_stack":
        assert (want[0][5] > 24).any()


def test_compaction_runs_out_where_bwa_tpu_stops(world, monkeypatch):
    """Segments of 100 steps: after two, more lanes run than a smaller
    launch holds, so the rest run out in place.  bwa_tpu's run-out adds
    its 0x7fffffff budget to the step count in int32, which wraps: it runs
    no step and its running lanes keep part of their seeds.  The port's
    runs out, and its seeds equal the unified route's."""
    from bwa_tpu.options import MemOptions as JOpt
    from bwa_tpu_torch.options import MemOptions

    q, ql = _route_lanes(world)
    env = dict([ROUTES["compact"]], BWA_TPU_SEED_SEG="100",
               BWA_TPU_SEED_SEG2="100")
    got = _collect(world["eng"], MemOptions(), q, ql, 24, env, monkeypatch)
    levels = world["eng"].last_levels
    assert levels[-1][2] == 0 and levels[-1][0] == levels[-2][0], levels
    unified = world["eng"].collect_seeds(q, ql, MemOptions(), 24)
    for a, b in zip(got[0], unified):
        np.testing.assert_array_equal(_i64(a), _i64(b))
    jax_compact = _collect(world["jeng"], JOpt(), q, ql, 24, env,
                           monkeypatch)
    assert (jax_compact[0][5] < unified[5]).any()  # bwa_tpu's stopped


def _sam(pkg, prefix, rs, mode=None, flag=0):
    """process_seqs' SAM of reads rs (interleaved when flag has
    MEM_F_PE) through package pkg ("jax": bwa_tpu, else the port on a CPU
    engine)."""
    if pkg == "jax":
        from bwa_tpu.engine import make_engine
        from bwa_tpu.index.fmindex import FMIndex
        from bwa_tpu.mem.pipeline import process_seqs
        from bwa_tpu.mem.types import Read
        from bwa_tpu.options import MemOptions
        dev = "tpu"
    else:
        from bwa_tpu_torch.engine import make_engine
        from bwa_tpu_torch.index.fmindex import FMIndex
        from bwa_tpu_torch.mem.pipeline import process_seqs
        from bwa_tpu_torch.mem.types import Read
        from bwa_tpu_torch.options import MemOptions
        dev = "cpu"
    fm = FMIndex.load(prefix)
    opt = MemOptions()
    opt.apply_mode(mode)
    opt.flag |= flag
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    process_seqs(opt, make_engine(fm, dev), fm, reads, 0, None, None)
    return "".join(r.sam for r in reads)


@pytest.mark.parametrize("kind", ["se", "pe", "primary5"])
@pytest.mark.parametrize("route", ["split", "compact"])
def test_mem_routes_match_jax(world, monkeypatch, route, kind):
    from bwa_tpu_torch.options import MEM_F_PE, MEM_F_PRIMARY5

    monkeypatch.setenv(*ROUTES[route])
    g = world["genome"]
    if kind == "pe":
        r1, r2 = simulate_reads(g, 24, read_len=150, seed=31, paired=True)
        rs = [r for pair in zip(r1, r2) for r in pair]
        flag = MEM_F_PE
    else:
        rs = simulate_reads(g, 40, read_len=150, seed=29, err_rate=0.01)
        flag = MEM_F_PRIMARY5 if kind == "primary5" else 0
    want = _sam("jax", world["prefix"], rs, flag=flag)
    assert want.count("\n") >= len(rs)
    assert _sam("torch", world["prefix"], rs, flag=flag) == want


@pytest.mark.parametrize("route", ["split", "compact"])
def test_pacbio_under_routes(world, monkeypatch, route):
    """-x pacbio long reads: their lane shards need the provenance column
    that these routes' seed store lacks, so bwa_tpu's demux fails
    (ValueError) and the port refuses them with a ValueError that names
    the route; with -5 (one read a lane, no shards) both complete with
    equal SAM."""
    from bwa_tpu_torch.options import MEM_F_PRIMARY5

    monkeypatch.setenv(*ROUTES[route])
    rs = simulate_reads(world["genome"], 2, read_len=700, seed=21,
                        err_rate=0.05, indel_rate=0.01)
    with pytest.raises(ValueError):
        _sam("jax", world["prefix"], rs, "pacbio")
    with pytest.raises(ValueError, match=ROUTES[route][0]):
        _sam("torch", world["prefix"], rs, "pacbio")
    want = _sam("jax", world["prefix"], rs, "pacbio", MEM_F_PRIMARY5)
    assert want.count("\n") >= 2
    assert _sam("torch", world["prefix"], rs, "pacbio",
                MEM_F_PRIMARY5) == want
