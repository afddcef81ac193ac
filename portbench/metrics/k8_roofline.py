"""K8 (the trip probe, csrc/seed_machine.cu) against its roofline: every
launch's bound in the traced run, summed, over the kernel's summed
time.  A launch's work: the codes, the occtab and the counts once; one
base's count (5 integer ops a text word over nw/2 + 1 words) at both
ends where a position extends an interval of two rows or more, at one
end where it extends a one-row interval, and 16 ops at every position.
Which positions extend which intervals is counted after the window on
the launch's own rows, with the port's plain interval arithmetic."""

from portbench.peaks import bound_s, roofline

KERNEL = "probe_breaks_kernel"


def work(q_bytes, occ_words, rows, two, one, positions, nw):
    """(bytes, integer ops) of one launch."""
    return (q_bytes + occ_words * 4 + rows * 4,
            (2 * two + one) * 5 * (nw / 2 + 1) + positions * 16)


def ends(idx, q):
    """(positions extending an interval of two rows or more, positions
    extending a one-row interval) on the rows q."""
    import torch

    from bwa_tpu_torch.ops import fm as fm_ops

    B, L = q.shape
    i64 = torch.int64
    L2 = idx["L2"].to(i64)
    x1 = torch.ones(B, dtype=i64, device=q.device)
    x2 = torch.zeros(B, dtype=i64, device=q.device)
    started = torch.zeros(B, dtype=torch.bool, device=q.device)
    bidx = torch.arange(B, device=q.device)
    two = one = torch.zeros((), dtype=i64, device=q.device)
    for x in range(L):
        c = q[:, x].to(i64)
        good = c < 4
        ext = started & good
        one = one + (ext & (x2 == 1)).sum()
        two = two + (ext & (x2 != 1)).sum()
        cf = (3 - c).clamp(0, 3)
        o1 = fm_ops._occ4(idx, x1 - 1).to(i64)[bidx, cf]
        sz = fm_ops._occ4(idx, x1 - 1 + x2).to(i64)[bidx, cf] - o1
        ok = ext & (sz >= 1)
        _, s1, s2 = (v.to(i64) for v in fm_ops._set_intv(idx, c))
        restart = good & ~ok
        x1 = torch.where(ok, L2[cf] + 1 + o1, torch.where(restart, s1, x1))
        x2 = torch.where(ok, sz, torch.where(restart, s2, x2))
        started = good
    return int(two), int(one)


def install(spans):
    from bwa_tpu_torch.ops import fm as fm_ops

    def count(a, k, _):
        idx, q = a[0], a[1]
        return dict(idx=idx, q=q.clone())

    spans.record(fm_ops, "probe_breaks", "K8", count)


def read(ctx):
    recs = ctx.launches.get("K8", [])
    if not recs:
        return None
    b = 0.0
    for r in recs:
        idx, q = r["idx"], r["q"]
        occ = idx["occtab"]
        two, one = ends(idx, q)
        b += bound_s(*work(q.numel(), occ.numel(), q.shape[0], two, one,
                           q.numel(), occ.shape[1] - 4))
    return roofline(b, ctx.kernel_seconds(KERNEL))
