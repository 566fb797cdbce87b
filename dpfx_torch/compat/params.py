"""Weight bridge between a flax params tree and the port's state dict.

The port's module names equal the flax tree's, so the map is mechanical:
a Dense ``kernel [in, out]`` is a Linear ``weight [out, in]`` (transposed);
every other leaf (``bias``, ActNorm ``log_scale``) keeps its name and value.
Paths join with ``.`` in the state dict and ``/`` in a flattened flax tree
(the ``.npz`` layout that ``dpfx_torch.checkpoint`` reads).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": array} -> nested dict."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params tree (with or without the top ``params`` level, arrays
    as numpy) -> the port's state dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, a in flatten_tree(tree).items():
        *parents, leaf = path.split("/")
        if leaf == "kernel":
            sd[".".join(parents + ["weight"])] = torch.from_numpy(np.ascontiguousarray(a.T))
        else:
            sd[".".join(parents + [leaf])] = torch.from_numpy(np.array(a))
    return sd


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> ``{"params": {...}}`` of numpy arrays."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in state_dict.items():
        *parents, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            flat["/".join(parents + ["kernel"])] = np.ascontiguousarray(a.T)
        else:
            flat["/".join(parents + [leaf])] = a
    return {"params": unflatten_tree(flat)}


@torch.no_grad()
def randomize_(model: nn.Module, seed: int = 0, scale: float = 0.05) -> nn.Module:
    """Add ``scale * N(0, 1)`` to every parameter, seeded. Moves the
    zero-initialised ``out`` layers off the identity: a parity check on
    identity couplings would pass whatever the flow math did."""
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.add_((scale * torch.randn(p.shape, generator=g)).to(p.device))
    return model
