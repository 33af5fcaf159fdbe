"""Flax parameter trees of the JAX package to torch ``state_dict``s.

Takes the nested mapping of numpy arrays that ``jax.tree.map(np.asarray,
params)`` gives for GCN, ResGCN or GCNODE, for example for GCNODE::

    {GCNLayer_0: {Dense_0: {kernel [in, out]}, bias},
     ODEBlock_0: {dynamics: {GCNLayer_0: {Dense_0: {kernel}, bias}}},
     GCNLayer_1: ...}

and returns the ``state_dict`` of the port's model of the same kind.  A
flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear.weight`` is its
transpose.  Only numpy is read, so this module needs no JAX.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["params_from_flax"]


def _module_name(flax_name: str, in_dynamics: bool) -> str:
    if flax_name == "Dense_0":
        return "linear"
    if flax_name == "ODEBlock_0":
        return "odeblock"
    if flax_name == "dynamics":
        return "dynamics"
    m = re.fullmatch(r"GCNLayer_(\d+)", flax_name)
    if m and in_dynamics and m.group(1) == "0":
        return "layer"
    if m and not in_dynamics:
        return f"layers.{m.group(1)}"
    raise KeyError(f"no torch counterpart for flax module {flax_name!r}")


def params_from_flax(tree: Mapping) -> dict:
    """Flax params (nested mapping of numpy arrays) -> torch ``state_dict``."""
    out = {}

    def walk(node: Mapping, prefix: str, in_dynamics: bool):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(
                    value, prefix + _module_name(name, in_dynamics) + ".",
                    in_dynamics or name == "dynamics",
                )
            elif name == "kernel":
                kernel = np.asarray(value, dtype=np.float32)
                out[prefix + "weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
            elif name == "bias":
                out[prefix + "bias"] = torch.from_numpy(np.array(value, dtype=np.float32))
            else:
                raise KeyError(f"no torch counterpart for flax parameter {prefix}{name}")

    walk(tree, "", False)
    return out
