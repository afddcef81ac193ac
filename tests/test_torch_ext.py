"""The port's extension DP (plain band DP and the fused extension) against the
JAX package: ksw_batch.extend_batch and
ExtGatherEngine(..., interpret=True).run_fused / .run, exactly.  Kernel K2
is held to the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


def _mat(a, b):
    m = np.full((5, 5), -1, np.int8)
    for i in range(4):
        for j in range(4):
            m[i, j] = a if i == j else -b
    return m


def _mutate(rng, seq, sub, n_indel, max_len):
    """Substitutions plus n_indel insertions/deletions of 1..max_len bases."""
    s = seq.copy()
    m = rng.random(len(s)) < sub
    s[m] = rng.integers(0, 4, int(m.sum()))
    for _ in range(n_indel):
        pos = int(rng.integers(5, len(s) - 5))
        ln = int(rng.integers(1, max_len + 1))
        if rng.random() < 0.5:
            s = np.delete(s, np.arange(pos, min(pos + ln, len(s) - 1)))
        else:
            s = np.insert(s, pos, rng.integers(0, 4, ln))
    return s.astype(np.uint8)


# (o_del, e_del, o_ins, e_ins, zdrop, match, mismatch): mem defaults, the
# pacbio preset, and a tight z-drop
OPTS = [(6, 1, 6, 1, 100, 1, 4), (1, 1, 1, 1, 100, 1, 1),
        (6, 1, 6, 1, 6, 1, 4)]


def _problems(seed, N=20, Q=90, T=110):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 600)
    qs = np.full((N, Q), 4, np.uint8)
    ts = np.full((N, T), 4, np.uint8)
    ql = rng.integers(1, Q, N)
    tl = rng.integers(1, T, N)
    for n in range(N):
        s = int(rng.integers(0, 300))
        q = _mutate(rng, ref[s:s + 200], 0.05, 2, 6)[:ql[n]]
        ql[n] = len(q)
        qs[n, :ql[n]] = q
        ts[n, :tl[n]] = ref[s:s + tl[n]] if n % 4 else rng.integers(0, 4, tl[n])
    h0 = rng.integers(0, 40, N)
    h0[0] = 0
    ws = rng.integers(2, 50, N)
    return qs, ql, ts, tl, h0, ws


def _jax_extend_batch(qs, ql, ts, tl, mat, o, ws, h0):
    from bwa_tpu.ops.ksw_batch import extend_batch

    od, ed, oi, ei, zd = o[:5]
    out = extend_batch(jnp.asarray(qs), jnp.asarray(ql.astype(np.int32)),
                       jnp.asarray(ts), jnp.asarray(tl.astype(np.int32)),
                       jnp.asarray(mat.astype(np.int32)), od, ed, oi, ei,
                       jnp.asarray(ws.astype(np.int32)), 5, zd,
                       jnp.asarray(h0.astype(np.int32)),
                       max_tlen=ts.shape[1])
    return np.stack([np.asarray(x) for x in out], 1)


def extend_band(qs, qlens, ts, tlens, mat, o_del, e_del, o_ins, e_ins, ws,
                end_bonus, zdrop, h0s):
    """Host arrays through the plain band DP (ksw_band.band_rows), the band
    sized to the largest post-clamp w: extend_batch's signature."""
    from bwa_tpu_torch.ops.ext_gather import band_clamp
    from bwa_tpu_torch.ops.ksw_band import _band_for, band_rows

    N, Q = qs.shape
    T = ts.shape[1]
    w = band_clamp(qlens, ws, int(mat.max()), o_del, e_del, o_ins, e_ins,
                   end_bonus)
    P = _band_for(int(w.max(initial=1)))
    W = P // 2 - 1
    qpad = np.full((N, W + Q + P + T), 4, np.int64)
    qpad[:, W:W + Q] = qs
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
    out = band_rows(t(qpad[:, :P]), t(qpad[:, P - 1:P - 1 + T]), t(ts),
                    t(qlens), t(tlens), t(w), t(h0s), mat, P, W, o_del,
                    e_del, o_ins, e_ins, zdrop)
    return tuple(out[:, c].numpy() for c in range(6))


@pytest.mark.parametrize("o", OPTS)
def test_extend_batch_and_band_dp_match_jax(o):
    from bwa_tpu_torch.ops.ksw_batch import extend_batch

    qs, ql, ts, tl, h0, ws = _problems(sum(o))
    mat = _mat(o[5], o[6])
    want = _jax_extend_batch(qs, ql, ts, tl, mat, o, ws, h0)
    spec = np.stack(extend_batch(qs, ql, ts, tl, mat, *o[:4], ws, 5, o[4],
                                 h0), 1)
    band = np.stack(extend_band(qs, ql, ts, tl, mat, *o[:4], ws, 5, o[4],
                                h0), 1)
    np.testing.assert_array_equal(spec, want)
    np.testing.assert_array_equal(band, want)
    assert (want[:, 0] > want[:, 0].min()).any()


@pytest.mark.parametrize("w", [600, 1000])
def test_band_dp_wide_band_matches_jax(w):
    """Bands wider than 1024 slots (P = 1280 and 2048; kernel K2 gives
    each thread several slots there) on long problems whose best paths
    cross a 150-base insertion or a 250-base deletion."""
    rng = np.random.default_rng(w)
    N, Q, T = 3, 1000, 1100
    ref = rng.integers(0, 4, T).astype(np.uint8)
    ins = np.concatenate([ref[:300], rng.integers(0, 4, 150), ref[300:]])
    dele = np.concatenate([ref[:300], ref[550:]])
    qs = np.full((N, Q), 4, np.uint8)
    ql = np.zeros(N, np.int64)
    for n, q in enumerate((ins, dele, ref)):
        q = _mutate(rng, q, 0.03, 0, 1)[:Q]
        ql[n] = len(q)
        qs[n, :ql[n]] = q
    ts = np.tile(ref, (N, 1))
    tl = np.full(N, T)
    h0 = np.array([30, 20, 5])
    ws = np.full(N, w)
    o = (1, 1, 1, 1, 100)
    mat = _mat(1, 1)
    want = _jax_extend_batch(qs, ql, ts, tl, mat, o, ws, h0)
    band = np.stack(extend_band(qs, ql, ts, tl, mat, *o[:4], ws, 5, o[4],
                                h0), 1)
    np.testing.assert_array_equal(band, want)
    assert want[0, 5] >= 140 and want[1, 5] >= 240  # far off the diagonal


@pytest.fixture(scope="module")
def jobs():
    """A resident reference and read batch plus mem_chain2aln job rows
    (q_base, l_query, qbeg, slen, rbeg, rmax0, rmax1, h0) on both strands,
    with indels long enough to trigger the band-doubling retries."""
    from bwa_tpu_torch.index.pack import pack_codes

    rng = np.random.default_rng(17)
    l_pac = 4000
    ref = rng.integers(0, 4, l_pac).astype(np.uint8)
    pac = np.zeros(l_pac // 4 + 1, np.uint8)
    pac[:(l_pac + 3) // 4] = pack_codes(ref)[:(l_pac + 3) // 4]
    two = np.concatenate([ref, 3 - ref[::-1]])
    qflat, meta, pos = [], [], 0
    for r in range(8):
        s = int(rng.integers(0, 2 * l_pac - 500))
        half_end = l_pac if s < l_pac else 2 * l_pac
        s = min(s, half_end - 420)
        q = _mutate(rng, two[s:s + 400], 0.04, 3, 12)
        if r == 2:
            q[30:32] = 4
        ln = len(q)
        qflat.append(q)
        for k in range(3):
            qbeg = int(rng.integers(1, ln - 60)) if k else 0
            slen = int(rng.integers(15, 40))
            rbeg = s + qbeg
            rmax0 = max(half_end - l_pac, rbeg - qbeg - 100)
            rmax1 = min(half_end, rbeg + (ln - qbeg) + 100)
            meta.append([pos, ln, qbeg, slen, rbeg, rmax0, rmax1,
                         int(rng.integers(slen, 3 * slen))])
        pos += ln
    return pac, l_pac, np.concatenate(qflat), np.array(meta, np.int64)


def _opt(mode, w, zdrop):
    from bwa_tpu_torch.options import MemOptions

    opt = MemOptions()
    opt.apply_mode(mode)
    opt.w = w
    opt.zdrop = zdrop
    return opt


OPT_CASES = [(None, 8, 100), ("pacbio", 8, 30), ("pacbio", 100, 80)]


@pytest.mark.parametrize("mode,w,zdrop", OPT_CASES)
def test_run_fused_and_run_match_jax(jobs, mode, w, zdrop):
    from bwa_tpu.ops.ext_gather import ExtGatherEngine as JEngine
    from bwa_tpu_torch.ops.ext_gather import ExtGatherEngine, band_clamp

    pac, l_pac, qflat, meta = jobs
    opt = _opt(mode, w, zdrop)
    je = JEngine(pac, l_pac, np.int32, interpret=True)
    je.set_reads(qflat)
    te = ExtGatherEngine(pac, l_pac, np.int32, device="cpu")
    te.set_reads(qflat)
    want = je.run_fused(meta, opt)
    np.testing.assert_array_equal(te.run_fused(meta, opt), want)
    if w == 8:  # the indels push max_off past w/2 + w/4: retries ran
        assert (want[:, 5] == 2 * w).any() and (want[:, 11] == 2 * w).any()
    # one pass (the BWA_TPU_EXT_FUSED=0 path): right extensions
    n = len(meta)
    qe = meta[:, 2] + meta[:, 3]
    qlen = meta[:, 1] - qe
    keep = qlen > 0
    args = (meta[:, 0] + qe, np.ones(n, np.int32), qlen,
            meta[:, 4] + meta[:, 3], np.ones(n, np.int32),
            meta[:, 6] - (meta[:, 4] + meta[:, 3]),
            band_clamp(qlen, np.full(n, opt.w), int(opt.mat.max()),
                       opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                       opt.pen_clip3), meta[:, 7])
    args = tuple(a[keep] for a in args)
    rest = (opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    np.testing.assert_array_equal(te.run(*args, *rest), je.run(*args, *rest))

