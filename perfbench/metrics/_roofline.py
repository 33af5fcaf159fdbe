"""The bucket kernels' share of their roofline, shared by the B2 and B2-w readers."""

from perfbench.harness.peaks import bound_s


def bucket_roofline(ctx, mode):
    """Σ bound / Σ device time of the bucket kernel's launches in the traced
    stretch, over every rank, in percent; None unless every launch there is
    one of ``mode``'s calls, as many as the work module counts."""
    bound = device = 0.0
    for summary, calls in zip(ctx["ranks"], ctx["bucket"]):
        if mode not in calls:
            return None
        train, evaluation = calls[mode]
        expected = ctx["steps"] * len(train) + ctx["evaluations"] * len(evaluation)
        launches = summary["kind_launches"].get("bucket_kernel", 0)
        if expected == 0 or launches != expected:
            return None
        bound += (ctx["steps"] * sum(bound_s(b, f) for b, f in train)
                  + ctx["evaluations"] * sum(bound_s(b, f) for b, f in evaluation))
        device += summary["kind_ns"]["bucket_kernel"] * 1e-9
    return 100.0 * bound / device
