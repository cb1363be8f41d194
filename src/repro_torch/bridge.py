"""Carry a JAX parameter tree over to the port.

``from_jax_params`` takes the tree ``repro.models.dit_moe.init_dit``,
``repro.models.rwkv6.init_rwkv6`` or ``repro.models.dense.init_lm`` (the
dense and MoE LMs) builds, with its leaves as numpy arrays
(``jax.device_get`` gives that), and returns the same tree of torch
tensors.  Every leaf keeps its shape, its dtype and its (in, out) layout,
so nothing is transposed on the way; bf16 leaves cross bit for bit.  This
module imports neither JAX nor the JAX package: it reads numpy arrays
only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device

TOP_KEYS = ("patch_embed", "pos_embed", "t_mlp1", "t_mlp2", "class_embed",
            "final_mod", "final_out", "final_norm", "blocks")
BLOCK_KEYS = ("ln1", "ln2", "attn", "moe", "adaln")
RWKV6_TOP_KEYS = ("embed", "layers", "final_norm", "unembed")
RWKV6_LAYER_KEYS = ("ln1", "ln2", "mix", "mix_lora_a", "mix_lora_b", "wr",
                    "wk", "wv", "wg", "wo", "decay_base", "decay_lora_a",
                    "decay_lora_b", "bonus_u", "ln_x", "cm_mix", "cm_k",
                    "cm_v", "cm_r")
LM_TOP_KEYS = ("embed", "layers", "final_norm")
LM_LAYER_KEYS = ("ln1", "ln2", "attn")
LM_ATTN_KEYS = ("wq", "wk", "wv", "wo")


def _convert(node, device, path: str):
    if isinstance(node, dict):
        return {k: _convert(v, device, f"{path}.{k}") for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, f"{path}[{i}]") for i, v in enumerate(node)]
    arr = np.asarray(node)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        # numpy has no bf16 of its own: reinterpret the 16-bit patterns
        bits = torch.from_numpy(np.array(arr.view(np.int16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"{path}: leaf of dtype {arr.dtype} is not numeric")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_params(tree: Dict[str, Any],
                    device: Optional[str] = None) -> Dict[str, Any]:
    """numpy tree of ``repro.models.dit_moe.init_dit``,
    ``repro.models.rwkv6.init_rwkv6`` or ``repro.models.dense.init_lm`` ->
    port params on ``device`` (``cuda`` unless given).  An LM tree is told
    by its layer keys: an ``attn`` block (with ``mlp`` or ``moe``) is the
    dense/MoE LM's, anything else is checked as RWKV-6's."""
    if "layers" in tree and "attn" in tree["layers"]:
        _require(tree, LM_TOP_KEYS, "not a dense/MoE LM param tree")
        layer = tree["layers"]
        _require(layer, LM_LAYER_KEYS, "layers")
        _require(layer["attn"], LM_ATTN_KEYS, "layers.attn")
        if ("mlp" in layer) == ("moe" in layer):
            raise KeyError("layers: a dense/MoE LM layer holds one of 'mlp' "
                           "and 'moe'")
    elif "layers" in tree:
        _require(tree, RWKV6_TOP_KEYS, "not an RWKV-6 param tree")
        _require(tree["layers"], RWKV6_LAYER_KEYS, "layers")
    else:
        _require(tree, TOP_KEYS, "not a DiT-MoE param tree")
        for i, blk in enumerate(tree["blocks"]):
            _require(blk, BLOCK_KEYS, f"block {i}")
    return _convert(tree, resolve_device(device), "params")


def _require(node, keys, what: str) -> None:
    missing = [k for k in keys if k not in node]
    if missing:
        raise KeyError(f"{what}: missing {missing}")


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
