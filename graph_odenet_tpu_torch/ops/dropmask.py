"""Counter-based attention-dropout masks, regenerable in any edge order.

Counterpart of ``graph_odenet_tpu/ops/dropmask.py``, bit for bit.  The mask
of edge ``(s, r)`` and head ``h`` is a pure function of ``(s, r, h, seed)``:
a murmur3 finaliser over a mixed key.  So the forward kernel (CSR order),
the α/dlogit backward (CSR order) and the recompute-α dWh kernel (CSC
order) each regenerate it where they stand, and no ``[E, H]`` mask is
stored.  The CUDA kernels share ``csrc/dropmask.cuh``, which holds the same
constants.

PyTorch has few uint32 operations, so the plain version here holds the
32-bit words in int64 and keeps the low 32 bits after every multiply.  A
``seed`` is a Python int in ``[0, 2**32)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["keep24", "inv_keep", "hash_edge_head", "attention_dropout_scale", "draw_seed"]

K_SND = 0x9E3779B9
K_RCV = 0x85EBCA6B
K_HEAD = 0xC2B2AE35
F1 = 0x7FEB352D
F2 = 0x846CA68B
_M32 = 0xFFFFFFFF


def keep24(rate: float) -> int:
    """Keep threshold on the hash's top 24 bits."""
    return int(round((1.0 - rate) * (1 << 24)))


def inv_keep(rate: float) -> float:
    """``1 / (1 - rate)`` rounded as float32 division rounds it."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x * k mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, without overflow."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, F1)
    x = x ^ (x >> 15)
    x = _mul32(x, F2)
    return x ^ (x >> 16)


def hash_edge_head(seed: int, senders: torch.Tensor, receivers: torch.Tensor, heads: int):
    """32-bit hash per (edge, head), as int64 ``[E, H]`` in ``[0, 2**32)``."""
    s = _mul32(senders.to(torch.int64) & _M32, K_SND)
    r = _mul32(receivers.to(torch.int64) & _M32, K_RCV)
    h = _mul32(torch.arange(heads, dtype=torch.int64, device=senders.device), K_HEAD)
    x = (s ^ r)[:, None] ^ h[None, :] ^ (int(seed) & _M32)
    return _fmix(x)


def attention_dropout_scale(
    seed: int, senders: torch.Tensor, receivers: torch.Tensor, heads: int, rate: float
) -> torch.Tensor:
    """``[E, H]`` f32 α scale: ``1/(1-rate)`` where kept, 0 where dropped."""
    keep = (hash_edge_head(seed, senders, receivers, heads) >> 8) < keep24(rate)
    return torch.where(keep, inv_keep(rate), 0.0).to(torch.float32)


def draw_seed(generator: torch.Generator) -> int:
    """One dropout seed in ``[0, 2**32)`` from a CPU generator (no device sync)."""
    return int(torch.randint(0, 1 << 32, (), generator=generator, dtype=torch.int64))
