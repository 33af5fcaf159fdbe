"""The model FLOPs of the traced stretch's training steps and evaluations
over its length × chips × the f32 peak, in percent."""

from perfbench.harness.peaks import PEAK_F32_FLOPS


def read(ctx):
    train, evaluation = ctx["flops"]
    work = ctx["steps"] * train + ctx["evaluations"] * evaluation
    seconds = max(r["window_ns"] for r in ctx["ranks"]) * 1e-9
    if work <= 0 or seconds <= 0 or not any(r["busy_ns"] for r in ctx["ranks"]):
        return None
    return 100.0 * work / (seconds * ctx["chips"] * PEAK_F32_FLOPS)
