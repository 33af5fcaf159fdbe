"""Device ms an epoch under the program's spans, shared by the span readers."""


def span_ms(ctx, *names, key="span_ns"):
    """Σ of ``key`` (``span_ns``, or ``idle_ns``) over ``names`` in each rank's
    ``spans`` summary (``harness/spans.py``), in ms an epoch, the largest
    over ranks; None where no rank opened any of the spans in the stretch."""
    ranks = [r.get("spans") for r in ctx["ranks"]]
    if ctx["steps"] == 0 or None in ranks or not any(
            s["instances"].get(n) for s in ranks for n in names):
        return None
    return max(sum(s[key].get(n, 0) for n in names) for s in ranks) * 1e-6 / ctx["steps"]
