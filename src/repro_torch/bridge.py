"""Carry a JAX DiT-MoE parameter tree over to the port.

``from_jax_params`` takes the tree ``repro.models.dit_moe.init_dit`` builds,
with its leaves as numpy arrays (``jax.device_get`` gives that), and returns
the same tree of torch tensors.  Every leaf keeps its shape and its (in,
out) layout, so nothing is transposed on the way.  This module imports
neither JAX nor the JAX package: it reads numpy arrays only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device

TOP_KEYS = ("patch_embed", "pos_embed", "t_mlp1", "t_mlp2", "class_embed",
            "final_mod", "final_out", "final_norm", "blocks")
BLOCK_KEYS = ("ln1", "ln2", "attn", "moe", "adaln")


def _convert(node, device, path: str):
    if isinstance(node, dict):
        return {k: _convert(v, device, f"{path}.{k}") for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, f"{path}[{i}]") for i, v in enumerate(node)]
    arr = np.asarray(node)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"{path}: leaf of dtype {arr.dtype} is not numeric "
                        f"(bf16 leaves must be cast to float32 first)")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_params(tree: Dict[str, Any],
                    device: Optional[str] = None) -> Dict[str, Any]:
    """numpy tree of ``repro.models.dit_moe.init_dit`` -> port params on
    ``device`` (``cuda`` unless given)."""
    missing = [k for k in TOP_KEYS if k not in tree]
    if missing:
        raise KeyError(f"not a DiT-MoE param tree: missing {missing}")
    for i, blk in enumerate(tree["blocks"]):
        missing = [k for k in BLOCK_KEYS if k not in blk]
        if missing:
            raise KeyError(f"block {i}: missing {missing}")
    return _convert(tree, resolve_device(device), "params")


def leaves(tree) -> Dict[str, torch.Tensor]:
    """Flat {path: leaf} view of a param tree (either framework's), in a
    fixed order."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = node
    walk(tree, "")
    return out
