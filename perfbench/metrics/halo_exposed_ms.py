"""Device ms per epoch of NCCL's point-to-point kernels (the ring's hops)
that no compute kernel of the same rank overlaps, the waits on the slowest
peer included; the largest over ranks."""


def read(ctx):
    if ctx["steps"] == 0 or not any(r["kind_launches"].get("nccl_p2p") for r in ctx["ranks"]):
        return None
    return max(r["p2p_exposed_ns"] for r in ctx["ranks"]) * 1e-6 / ctx["steps"]
