"""The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W) and the
least time a piece of work could take on it.  Copied from the port's
``chip_smoke.py``: each input read once and each output written once."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_s(n_bytes: float, n_flops: float) -> float:
    """Least seconds for work that moves ``n_bytes`` and does ``n_flops`` f32
    operations: the larger of the two over their peaks."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS)
