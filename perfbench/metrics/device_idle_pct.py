"""The share of the traced stretch in which no device activity ran on any
stream (the union over streams), the largest over ranks, in percent."""


def read(ctx):
    if not any(r["busy_ns"] for r in ctx["ranks"]):
        return None  # nothing ran on a device
    return max(100.0 * (1.0 - r["busy_ns"] / r["window_ns"]) for r in ctx["ranks"])
