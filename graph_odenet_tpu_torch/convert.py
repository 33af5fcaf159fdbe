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

``params_from_interaction`` takes the tree of an ``InteractionNetwork``
(``{MLP_0: {Dense_i: {kernel, bias}}, MLP_1: ...}``: the relation MLP, then
the object MLP) or of an ``INODE`` (``{core: {...}}``) and returns the
``state_dict`` of the port's module of the same kind.

``params_from_sharded`` takes the flat dict of the JAX package's
edge-parallel GCN-ODE (``parallel.sharded_gcn.init_params``: ``w_in``,
``b_in``, ``w_dyn``, ``b_dyn``, ``w_out``, ``b_out``), which the port's
``ShardedGCNODE`` keeps by name and layout; ``params_from_sharded_gat`` the
nine arrays of its edge-parallel GAT-ODE (``parallel.sharded_gat
.init_gatode_params``), likewise kept by ``ShardedGATODE``.  Only numpy is
read, so this module needs no JAX.

Every leaf keeps its dtype.  A bfloat16 leaf (``param_dtype=bfloat16``)
arrives as a numpy array of ``ml_dtypes``' bfloat16, which
``torch.from_numpy`` refuses: it is widened to float32, which is exact, and
rounded back with ``.to(torch.bfloat16)``, which is exact too.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = [
    "params_from_flax", "params_from_interaction", "params_from_sharded", "params_from_sharded_gat",
]

_SHARDED_GCN = ("w_in", "b_in", "w_dyn", "b_dyn", "w_out", "b_out")
_SHARDED_GAT = tuple(f"{p}_{layer}" for layer in ("enc", "dyn", "out") for p in ("w", "a_src", "a_dst"))


def _tensor(value, transpose: bool = False) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype (bf16 through float32)."""
    bf16 = getattr(value, "dtype", None) is not None and value.dtype.name == "bfloat16"
    a = np.asarray(value, dtype=np.float32) if bf16 else np.asarray(value)
    if transpose:
        a = a.reshape(a.shape[0], -1).T
    t = torch.from_numpy(np.array(a, order="C"))
    return t.to(torch.bfloat16) if bf16 else t


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
                out[prefix + "weight"] = _tensor(value, transpose=True)
            elif name in ("bias", "attn_src", "attn_dst"):
                out[prefix + name] = _tensor(value)
            else:
                raise KeyError(f"no torch counterpart for flax parameter {prefix}{name}")

    walk(tree, "", False)
    return out


_INTERACTION_MODULES = {"core": "core", "MLP_0": "relation_mlp", "MLP_1": "object_mlp"}


def params_from_interaction(tree: Mapping) -> dict:
    """Flax ``InteractionNetwork`` or ``INODE`` params -> the port's ``state_dict``."""
    out = {}

    def walk(node: Mapping, prefix: str):
        for name, value in node.items():
            m = re.fullmatch(r"Dense_(\d+)", name)
            if m:
                out[f"{prefix}layers.{m.group(1)}.weight"] = _tensor(value["kernel"], transpose=True)
                out[f"{prefix}layers.{m.group(1)}.bias"] = _tensor(value["bias"])
            elif name in _INTERACTION_MODULES:
                walk(value, f"{prefix}{_INTERACTION_MODULES[name]}.")
            else:
                raise KeyError(f"no torch counterpart for flax module {prefix}{name}")

    walk(tree, "")
    return out


def _flat_params(params: Mapping, names: tuple) -> dict:
    if sorted(params) != sorted(names):
        raise KeyError(f"expected the parameters {names}, got {sorted(params)}")
    return {k: _tensor(params[k]) for k in names}


def params_from_sharded(params: Mapping) -> dict:
    """JAX sharded GCN-ODE params (mapping of numpy arrays) -> ``ShardedGCNODE`` ``state_dict``."""
    return _flat_params(params, _SHARDED_GCN)


def params_from_sharded_gat(params: Mapping) -> dict:
    """JAX sharded GAT-ODE params (mapping of numpy arrays) -> ``ShardedGATODE`` ``state_dict``."""
    return _flat_params(params, _SHARDED_GAT)
