"""K1 (the seeding machine, csrc/seed_machine.cu) against its roofline:
the bound of every launch in the traced run, summed, over the kernel's
summed time.  A launch's work: each input and output once (the occtab,
the codes, the next-valid table, 16 bytes of bounds and 9 of flags a
lane, the seed store) and, per lane step as this run's reads took them
(done_step), two masks at 5 integer ops a text word at both ends over
nw/2 + 1 words, plus ~64 ops of state update."""

from portbench.peaks import bound_s, roofline

KERNEL = "seed_machine_kernel"


def work(occ_words, q_bytes, nv_words, lanes, seed_bytes, lane_steps, nw):
    """(bytes, integer ops) of one launch."""
    nbytes = (occ_words * 4 + q_bytes + nv_words * 4 + lanes * 16
              + seed_bytes + lanes * 9)
    return nbytes, lane_steps * (2 * 2 * 5 * (nw / 2 + 1) + 64)


def install(spans):
    import inspect

    import torch

    from bwa_tpu_torch.ops import cuda_kernels

    sig = inspect.signature(cuda_kernels.seed_machine)

    def count(a, k, _):
        p = sig.bind(*a, **k).arguments
        occ, q, nv, seeds = p["occtab"], p["q"], p["nv"], p["seeds"]
        return dict(occ_words=occ.numel(), q_bytes=q.numel(),
                    nv_words=0 if nv is None else nv.numel(),
                    lanes=q.shape[0],
                    seed_bytes=seeds.numel() * seeds.element_size(),
                    nw=occ.shape[1] - 4,
                    steps=p["done_step"].to(torch.int64).sum())

    spans.record(cuda_kernels, "seed_machine", "K1", count)


def read(ctx):
    recs = ctx.launches.get("K1", [])
    if not recs:
        return None
    b = sum(bound_s(*work(r["occ_words"], r["q_bytes"], r["nv_words"],
                          r["lanes"], r["seed_bytes"], int(r["steps"]),
                          r["nw"])) for r in recs)
    t = ctx.kernel_seconds(KERNEL)
    return roofline(b, t)
