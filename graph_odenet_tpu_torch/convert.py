"""Flax parameter trees of the JAX package to torch ``state_dict``s.

Takes the nested mapping of numpy arrays that ``jax.tree.map(np.asarray,
params)`` gives for GCN, ResGCN, GCNODE, GAT, ResGAT or GATODE, for example
for GCNODE and GATODE::

    {GCNLayer_0: {Dense_0: {kernel [in, out]}, bias},
     ODEBlock_0: {dynamics: {GCNLayer_0: {Dense_0: {kernel}, bias}}},
     GCNLayer_1: ...}

    {GATLayer_0: {DenseGeneral_0: {kernel [in, H, F]}, attn_src [1, H, F],
                  attn_dst [1, H, F]},
     ODEBlock_0: {dynamics: {GATLayer_0: {...}}},
     GATLayer_1: ...}

and returns the ``state_dict`` of the port's model of the same kind.  A
flax ``Dense`` kernel is ``[in, out]`` and a ``DenseGeneral`` kernel
``[in, H, F]``; a torch ``Linear.weight`` is ``[H·F, in]``, the kernel
flattened to ``[in, H·F]`` and transposed.

``params_from_sharded`` takes the flat dict of the JAX package's
edge-parallel GCN-ODE (``parallel.sharded_gcn.init_params``: ``w_in``,
``b_in``, ``w_dyn``, ``b_dyn``, ``w_out``, ``b_out``), which the port's
``ShardedGCNODE`` keeps by name and layout; ``params_from_sharded_gat`` the
nine arrays of its edge-parallel GAT-ODE (``parallel.sharded_gat
.init_gatode_params``), likewise kept by ``ShardedGATODE``.  Only numpy is
read, so this module needs no JAX.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["params_from_flax", "params_from_sharded", "params_from_sharded_gat"]

_SHARDED_GCN = ("w_in", "b_in", "w_dyn", "b_dyn", "w_out", "b_out")
_SHARDED_GAT = tuple(f"{p}_{layer}" for layer in ("enc", "dyn", "out") for p in ("w", "a_src", "a_dst"))


def _module_name(flax_name: str, in_dynamics: bool) -> str:
    if flax_name in ("Dense_0", "DenseGeneral_0"):
        return "linear"
    if flax_name == "ODEBlock_0":
        return "odeblock"
    if flax_name == "dynamics":
        return "dynamics"
    m = re.fullmatch(r"(?:GCN|GAT)Layer_(\d+)", flax_name)
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
                kernel = kernel.reshape(kernel.shape[0], -1)
                out[prefix + "weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
            elif name in ("bias", "attn_src", "attn_dst"):
                out[prefix + name] = torch.from_numpy(np.array(value, dtype=np.float32))
            else:
                raise KeyError(f"no torch counterpart for flax parameter {prefix}{name}")

    walk(tree, "", False)
    return out


def _flat_params(params: Mapping, names: tuple) -> dict:
    if sorted(params) != sorted(names):
        raise KeyError(f"expected the parameters {names}, got {sorted(params)}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)) for k in names}


def params_from_sharded(params: Mapping) -> dict:
    """JAX sharded GCN-ODE params (mapping of numpy arrays) -> ``ShardedGCNODE`` ``state_dict``."""
    return _flat_params(params, _SHARDED_GCN)


def params_from_sharded_gat(params: Mapping) -> dict:
    """JAX sharded GAT-ODE params (mapping of numpy arrays) -> ``ShardedGATODE`` ``state_dict``."""
    return _flat_params(params, _SHARDED_GAT)
