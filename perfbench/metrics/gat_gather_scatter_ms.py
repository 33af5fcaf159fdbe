"""Device ms per epoch of the gather and segment kernels (the sharded GAT's
per-edge passes and ``dpv``), the largest over ranks."""


def read(ctx):
    ms = [(r["kind_ns"].get("gather", 0) + r["kind_ns"].get("segment_ops", 0)) * 1e-6
          for r in ctx["ranks"]]
    if ctx["steps"] == 0 or max(ms) == 0:
        return None
    return max(ms) / ctx["steps"]
