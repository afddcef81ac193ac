"""The Python mem route on the CPU: single-end -5, BWA_TPU_FINALIZE=python
(SE and PE), `mem -p -5` and the library Aligner of the port
(bwa_tpu_torch) give bwa_tpu's SAM bytes and hits on JAX CPU, for the same
reads and index.  Tolerance: none."""

import io

import pytest
import torch

from datagen import random_genome, simulate_reads, write_fasta, write_fastq
from test_torch_jax_native import jax_native

# small tensors, several test workers per host: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from bwa_tpu.index.build import index_build

    jax_native()  # built once, under a lock, before index_build
    d = tmp_path_factory.mktemp("torch_mem_python")
    g = random_genome(150_000, seed=7, n_contigs=2)
    write_fasta(d / "g.fa", g)
    return dict(prefix=index_build(str(d / "g.fa")), genome=g, dir=d)


def _sam(pkg, prefix, rs, mode=None, primary5=False, pe=False, hook=None):
    """process_seqs of package pkg ("bwa_tpu" on its batched JAX engine,
    "bwa_tpu_torch" on a CPU engine) over reads rs (interleaved with pe);
    hook(engine) may wrap the port's engine first."""
    import importlib

    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    o = mod("options")
    fm = mod("index.fmindex").FMIndex.load(prefix)
    eng = mod("engine").make_engine(
        fm, "tpu" if pkg == "bwa_tpu" else "cpu")
    if hook is not None:
        hook(eng)
    opt = o.MemOptions()
    opt.apply_mode(mode)
    if primary5:
        opt.flag |= o.MEM_F_PRIMARY5 | o.MEM_F_KEEP_SUPP_MAPQ
    if pe:
        opt.flag |= o.MEM_F_PE
    Read = mod("mem.types").Read
    reads = [Read(name=n, seq=s, qual=q) for n, s, q in rs]
    mod("mem.pipeline").process_seqs(opt, eng, fm, reads, 0, None, None)
    return "".join(r.sam for r in reads)


def _both(prefix, rs, **kw):
    return (_sam("bwa_tpu", prefix, rs, **kw),
            _sam("bwa_tpu_torch", prefix, rs, **kw))


def _pairs(world, n, seed):
    r1, r2 = simulate_reads(world["genome"], n, read_len=150, seed=seed,
                            paired=True)
    return [r for pair in zip(r1, r2) for r in pair]


def test_mem_se_primary5_pacbio_matches_jax(world):
    rs = simulate_reads(world["genome"], 3, read_len=700, seed=21,
                        err_rate=0.05, indel_rate=0.03)
    want, got = _both(world["prefix"], rs, mode="pacbio", primary5=True)
    assert want.count("\n") >= 3
    assert got == want


def test_finalize_python_se_matches_jax_and_native(world, monkeypatch):
    """BWA_TPU_FINALIZE=python single-end: bwa_tpu's bytes, and the C++
    route's bytes for the same reads (both routes are byte-exact to bwa)."""
    rs = simulate_reads(world["genome"], 48, read_len=150, seed=51,
                        err_rate=0.01)
    native = _sam("bwa_tpu_torch", world["prefix"], rs)
    monkeypatch.setenv("BWA_TPU_FINALIZE", "python")
    want, got = _both(world["prefix"], rs)
    assert got == want
    assert got == native


def test_finalize_python_pe_matches_jax(world, monkeypatch):
    rs = _pairs(world, 32, 53)
    native = _sam("bwa_tpu_torch", world["prefix"], rs, pe=True)
    monkeypatch.setenv("BWA_TPU_FINALIZE", "python")
    want, got = _both(world["prefix"], rs, pe=True)
    assert want.count("\n") >= 64
    assert got == want
    assert got == native


def test_cli_mem_p_primary5_matches_jax(world, monkeypatch):
    """mem -p -5 on an interleaved file with unpaired reads between the
    pairs: the unpaired reads take the single-end -5 route, the pairs the
    PE finalize; the command lines' SAM bodies are equal."""
    from bwa_tpu.cli import main as jax_main
    from bwa_tpu_torch.cli import main

    monkeypatch.setenv("BWA_TPU_NO_DAEMON", "1")
    pairs = _pairs(world, 12, 57)
    single = simulate_reads(world["genome"], 6, read_len=150, seed=59)
    rs = pairs[:8] + single[:3] + pairs[8:16] + single[3:] + pairs[16:]
    fq = world["dir"] / "p5.fq"
    write_fastq(fq, rs)
    outs = []
    for run, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        out = io.StringIO()
        assert run(["mem", "-p", "-5", *extra, world["prefix"], str(fq)],
                   out_fp=out) == 0
        outs.append([ln for ln in out.getvalue().splitlines()
                     if not ln.startswith("@PG")])
    assert len(outs[0]) >= len(rs)
    assert outs[1] == outs[0]


def test_primary5_host_spec_fallback_matches_jax(world, monkeypatch):
    """-5 reads whose seeds overflow: four of eight lanes report overflow
    at the first launch and at every rung of the device ladder wider than
    it (the 96 rung repeats the first launch's cap and is skipped), so
    those four reads (and only they) are re-seeded by the host spec; the
    SAM is bwa_tpu's unforced SAM."""
    from bwa_tpu_torch.mem import batch_seed

    rs = simulate_reads(world["genome"], 8, read_len=150, seed=61)
    calls, host = [], []

    def hook(eng):
        real_wait = eng.collect_seeds_wait

        def wait(h):
            out = real_wait(h)
            cap = h[2]
            calls.append((cap, len(out[5])))
            sn = out[5].copy()
            sn[:4 if len(calls) == 1 else len(sn)] = cap + 1
            return out[:5] + (sn,) + out[6:]

        eng.collect_seeds_wait = wait

    real_host = batch_seed.host_reseed
    monkeypatch.setattr(batch_seed, "host_reseed",
                        lambda *a: host.append(1) or real_host(*a))
    got = _sam("bwa_tpu_torch", world["prefix"], rs, primary5=True,
               hook=hook)
    assert calls == [(96, 8), (256, 4)]
    assert len(host) == 4
    assert got == _sam("bwa_tpu", world["prefix"], rs, primary5=True)


def test_aligner_hits_match_jax(world):
    from bwa_tpu.api import Aligner as JaxAligner
    from bwa_tpu_torch.api import Aligner

    rs = simulate_reads(world["genome"], 12, read_len=150, seed=67,
                        err_rate=0.02)
    mine, ref = Aligner(world["prefix"], device="cpu"), \
        JaxAligner(world["prefix"])
    for _, seq, _ in rs:
        got = [vars(h) for h in mine.align(seq)]
        assert got == [vars(h) for h in ref.align(seq)]
        assert got and not got[0]["secondary"]
    if torch.cuda.is_available():
        assert Aligner(world["prefix"]).engine.device.type == "cuda"
    else:  # the default device is the card, and there is none
        with pytest.raises(RuntimeError):
            Aligner(world["prefix"])
