"""K1's state mode's typed state (ops/fm_machine.py: typed_state,
start_state, gather_state, plain_dict), on the CPU, where the same code
builds, starts, gathers and views a state as on the card:

  * a pass started on a typed state equals the plain version's start
    (_stage_state, seed_state_init) field for field, at each stage, at
    int32 and int64 coordinates, from a state left dirty by a run;
  * compaction's gather (one index_select a tensor) equals the per-field
    gather of the plain dict;
  * a typed state read as the plain dict and written back round-trips;
  * pass 2 with the seed store full at its entry reads the fixed job
    table, as bwa_tpu's smem_machine does (its pushes overwrite the last
    row of the live store, whose job it has not read yet), tolerance 0
    against bwa_tpu on its CPU backend."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datagen import random_genome, simulate_reads, write_fasta
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)

CDTS = {"int32": torch.int32, "int64": torch.int64}
# the fields of a state as the plain dict has them, all compared
FIELDS = ("stkA", "stkB", "seeds", "qmask", "steps")


def _dirty(st, seed):
    """Every field of the typed state st random (flags 0/1), in place, as
    a run might leave it."""
    from bwa_tpu_torch.ops import fm_machine as fmm

    g = torch.Generator().manual_seed(seed)
    for t in (st["ints"], st["coords"], st["stk"], st["seeds"],
              st["steps2"]):
        t.copy_(torch.randint(0, 1000, t.shape, generator=g))
    for k in ("cur_is_a", "rev_read", "ovf"):
        st[k].copy_(torch.randint(0, 2, st[k].shape, generator=g))
    st["qmask"].copy_(torch.randint(0, 2, st["qmask"].shape, generator=g)
                      .bool())
    st["sp"] = 1
    return fmm._views(st)


def _assert_plain_equal(got, want, what):
    from bwa_tpu_torch.ops import fm_machine as fmm

    for k in fmm.SEG_FIELDS + FIELDS:
        g, w = got[k], want[k]
        g = g if torch.is_tensor(g) else torch.tensor(g)
        w = w if torch.is_tensor(w) else torch.tensor(w)
        assert g.dtype == w.dtype, f"{what}: {k} {g.dtype} {w.dtype}"
        assert torch.equal(g, w), f"{what}: {k}"


@pytest.mark.parametrize("coords", ["int32", "int64"])
@pytest.mark.parametrize("stage", [0, 1, 2], ids=["pass1", "pass2",
                                                   "pass3"])
def test_start_matches_plain_start(stage, coords):
    """start_state on a dirty typed state: the plain version's start of
    that stage field for field (pass 3 on stacks of one entry), the seeds
    and seed_n kept, old_n = seed_n for pass 2; a fresh typed_state is
    seed_state_init's state."""
    from bwa_tpu_torch.ops import fm_machine as fmm

    B, cap, cap_s = 37, 16, 24
    cdt = CDTS[coords]
    fresh = fmm.typed_state(B, cap, cap_s, cdt, "cpu")
    _assert_plain_equal(fmm.plain_dict(fresh),
                        fmm.seed_state_init(B, cap, cap_s, "cpu"), "fresh")
    st = _dirty(fmm.typed_state(B, cap, cap_s, cdt, "cpu"), stage)
    seeds, seed_n = st["seeds"].clone(), st["seed_n"].clone()
    pcap = 1 if stage == fmm.S_P3 else cap
    fmm.start_state(st, stage, pcap)
    q = torch.zeros((B, 4), dtype=torch.uint8)
    want = fmm._stage_state({}, q, stage, pcap, cap_s, seeds, seed_n,
                            seed_n if stage == fmm.S_P2 else None)
    _assert_plain_equal(fmm.plain_dict(st), want, f"stage {stage}")
    assert st["seeds"].dtype == cdt and st["stk"].shape == (B, 2, pcap, 4)
    assert st["steps"].dtype == torch.int32 and int(st["steps"]) == 0


@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_gather_matches_plain_gather(coords):
    """gather_state (compaction's gather: the lanes still running, then
    lane 0 padded in) equals the plain dict's fields gathered one by one,
    as compaction gathered them before; rows=None copies."""
    from bwa_tpu_torch.ops import fm_machine as fmm

    B, cap, cap_s = 300, 8, 12
    st = _dirty(fmm.typed_state(B, cap, cap_s, CDTS[coords], "cpu"), 5)
    rows = torch.tensor([3, 17, 18, 250, 299] + [0] * 11)
    g = fmm.gather_state(st, rows)
    p = fmm.plain_dict(st)
    want = {k: v[rows] if torch.is_tensor(v) and v.dim() >= 1
            and v.shape[0] == B else v for k, v in p.items()}
    _assert_plain_equal(fmm.plain_dict(g), want, "gather")
    assert g["ints"].is_contiguous() and g["stk"].is_contiguous()
    c = fmm.gather_state(st)
    _assert_plain_equal(fmm.plain_dict(c), p, "copy")
    c["ints"].zero_()
    assert bool(st["ints"].any())  # a copy, not a view


@pytest.mark.parametrize("coords", ["int32", "int64"])
def test_plain_dict_round_trips(coords):
    """plain_dict gives int64 fields and bool flags; written into another
    typed state (as the CPU path does after a plain run) every base tensor
    and the step count come back equal."""
    from bwa_tpu_torch.ops import fm_machine as fmm

    B, cap, cap_s = 29, 4, 6
    cdt = CDTS[coords]
    st = _dirty(fmm.typed_state(B, cap, cap_s, cdt, "cpu"), 9)
    p = fmm.plain_dict(st)
    for k in fmm.SEG_FIELDS + ("stkA", "stkB", "seeds"):
        want = torch.bool if k in ("cur_is_a", "rev_read", "ovf") \
            else torch.int64
        assert p[k].dtype == want, k
    assert p["steps"] == int(st["steps"])
    back = fmm.typed_state(B, cap, cap_s, cdt, "cpu")
    fmm._store_plain(back, p)
    for k in ("ints", "coords", "stk", "seeds", "qmask"):
        assert torch.equal(back[k], st[k]), k
    assert torch.equal(back["steps"], st["steps"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build
    from bwa_tpu.index.fmindex import DeviceFMIndex as JDev
    from bwa_tpu.index.fmindex import FMIndex as JFM
    from bwa_tpu_torch.index.fmindex import DeviceFMIndex, FMIndex
    from bwa_tpu_torch.index.pack import NT4_TABLE

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_seed_state")
    g = random_genome(30_000, seed=61, n_contigs=1, with_ns=False)
    # 3 kb of it again at its end, 1% of the bases changed: reads from it
    # re-seed in pass 2
    rng = np.random.default_rng(3)
    rep = np.frombuffer(g[0][1][5_000:8_000], np.uint8).copy()
    at = rng.choice(rep.size, 30, replace=False)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rep[at] = acgt[(np.searchsorted(acgt, rep[at]) + 1) % 4]
    g = [(g[0][0], g[0][1] + rep.tobytes())]
    write_fasta(d / "g.fa", g)
    prefix = index_build(str(d / "g.fa"))
    reads = [NT4_TABLE[np.frombuffer(s, np.uint8)] for _, s, _ in
             simulate_reads([("rep", g[0][1][5_000:8_000])], 48,
                            read_len=150, seed=62, err_rate=0.04)]
    q = np.full((len(reads), 150), 4, np.uint8)
    ql = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        q[i, :len(r)] = r
    return dict(jt=JDev(JFM.load(prefix)).tree(), q=q, ql=ql,
                tt=DeviceFMIndex(FMIndex.load(prefix), device="cpu").tree())


def test_pass2_full_store_reads_fixed_jobs(world):
    """Reads of the repeat with 4% errors and a seed store of 2 rows: pass
    1 fills the store of most lanes, and pass 2 (smem_pass on the state
    pass 1 left) appends past it, each push overwriting the last row.  Its seeds,
    seed_n, steps, ovf and done_step equal bwa_tpu's pass 2, which reads
    its jobs from tables fixed at entry; read from the live store instead
    (the plain version without the fixed table), some lane's seeds
    differ, so the case is exercised."""
    from bwa_tpu.ops import fm_machine as jm
    from bwa_tpu.ops.fm import _next_valid_device as jnv
    from bwa_tpu_torch.ops import fm_machine as fmm
    from bwa_tpu_torch.ops.fm import _next_valid_device

    cap, cap_s, c = 16, 2, (19, 28, 10)
    q, ql = world["q"], world["ql"]
    B = q.shape[0]
    qj, qlj = jnp.asarray(q), jnp.asarray(ql)
    nvj = jnv(qj, qlj)
    cj = [np.int32(v) for v in c]
    s0, n0 = jnp.zeros((B, cap_s, 5), jnp.int32), jnp.zeros(B, jnp.int32)
    j1 = jm.smem_machine(world["jt"], qj, qlj, nvj, *cj, s0, n0, n0,
                         cap=cap, cap_s=cap_s, pass2=False)
    j2 = jm.smem_machine(world["jt"], qj, qlj, nvj, *cj, j1[0], j1[1],
                         j1[1], cap=cap, cap_s=cap_s, pass2=True)
    tt = world["tt"]
    qd, qld = torch.from_numpy(q), torch.from_numpy(ql)
    nv = _next_valid_device(qd, qld)
    st = fmm.typed_state(B, cap, cap_s, tt["cdt"], "cpu")
    fmm.smem_pass(st, tt, qd, qld, nv, *c, cap=cap, cap_s=cap_s,
                  pass2=False)
    entry = (st["seeds"].clone(), st["seed_n"].clone())
    full = entry[1] >= cap_s
    assert int(full.sum()) >= B // 2
    fmm.smem_pass(st, tt, qd, qld, nv, *c, cap=cap, cap_s=cap_s, pass2=True)
    got = (st["seeds"], st["seed_n"], st["steps"], st["ovf"] != 0,
           st["done_step"])
    for i, (a, b) in enumerate(zip(got, j2)):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64),
                                      err_msg=f"pass 2 output {i}")
    assert bool((full & (st["seed_n"] > entry[1])).any())
    # the same pass read from the live store (its qualification bits)
    d = fmm._stage_state(tt, qd, fmm.S_P2, cap, cap_s, *entry, entry[1])
    sd = d["seeds"]
    d["qmask"] = ((sd[:, :, 4] - sd[:, :, 3]) >= c[1]) & (sd[:, :, 2] <= c[2])
    live = fmm._plain_state(d, tt, qd, qld, nv, *c, 0, fmm.BIG_STEPS, cap,
                            cap_s, False, fmm.S_P2, None)
    assert not torch.equal(live["seeds"], st["seeds"].long())
