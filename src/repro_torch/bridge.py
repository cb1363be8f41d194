"""Carry a JAX parameter tree over to the port.

``from_jax_params`` takes the tree ``repro.models.dit_moe.init_dit``,
``repro.models.rwkv6.init_rwkv6``, ``repro.models.dense.init_lm`` (the
dense and MoE LMs), ``repro.models.zamba2.init_zamba2``,
``repro.models.encdec.init_encdec`` or ``repro.models.vlm.init_vlm``
builds, with its leaves as numpy arrays
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

from repro_torch.common import sharding as shard_lib
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
VLM_CROSS_KEYS = ("ln1", "ln2", "attn", "mlp", "gate_attn", "gate_mlp")
ZAMBA2_TOP_KEYS = ("embed", "mamba", "shared_attn", "final_norm", "unembed")
ZAMBA2_MAMBA_KEYS = ("ln", "w_xz", "conv", "w_bcdt", "A_log", "D", "dt_bias",
                     "w_out")
ZAMBA2_SHARED_KEYS = ("ln1", "attn", "ln2", "mlp")
ENCDEC_TOP_KEYS = ("enc_layers", "enc_norm", "dec_layers", "embed",
                   "final_norm", "unembed")
ENCDEC_ENC_KEYS = ("ln1", "ln2", "attn", "mlp")
ENCDEC_DEC_KEYS = ("ln1", "ln_x", "ln2", "attn", "xattn", "mlp")


def _convert(node, device, path: str, mesh=None, names=()):
    if isinstance(node, dict):
        return {k: _convert(v, device, f"{path}.{k}", mesh, names + (str(k),))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, f"{path}[{i}]", mesh, names + (str(i),))
                for i, v in enumerate(node)]
    arr = np.asarray(node)
    if mesh is not None:
        # this rank's slice of the leaf's spec over "model", cut before the
        # leaf leaves numpy, so only the slice is copied and moved
        spec = shard_lib.param_spec("/".join(names), arr.shape, mesh)
        if "model" in spec:
            dim, n = spec.index("model"), mesh.shape["model"]
            k = arr.shape[dim] // n
            arr = np.take(arr, range(mesh.rank_in("model") * k,
                                     (mesh.rank_in("model") + 1) * k), axis=dim)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        # numpy has no bf16 of its own: reinterpret the 16-bit patterns
        bits = torch.from_numpy(np.array(arr.view(np.int16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"{path}: leaf of dtype {arr.dtype} is not numeric")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_params(tree: Dict[str, Any], device: Optional[str] = None,
                    mesh=None) -> Dict[str, Any]:
    """numpy tree of one of the JAX package's ``init_*`` (module docstring)
    -> port params on ``device`` (``cuda`` unless given).  ``mesh`` (a
    training mesh): each leaf cut to this rank's slice of its
    ``param_spec`` over ``model`` first, the tree
    ``common/sharding.shard_lm_params`` makes of the whole one (the
    reference dry run's placement, tensor parallelism).  The tree is told
    by its keys: ``mamba`` is zamba2's, ``enc_layers`` the encoder-decoder's;
    a ``layers`` stack with an ``attn`` block (with ``mlp`` or ``moe``) is
    the dense/MoE LM's, the VLM's when it also has ``cross``; any other
    ``layers`` is checked as RWKV-6's, and a tree without one as DiT-MoE's."""
    if "mamba" in tree:
        _require(tree, ZAMBA2_TOP_KEYS, "not a zamba2 param tree")
        _require(tree["mamba"], ZAMBA2_MAMBA_KEYS, "mamba")
        _require(tree["shared_attn"], ZAMBA2_SHARED_KEYS, "shared_attn")
        _require(tree["shared_attn"]["attn"], LM_ATTN_KEYS, "shared_attn.attn")
    elif "enc_layers" in tree:
        _require(tree, ENCDEC_TOP_KEYS, "not an encoder-decoder param tree")
        _require(tree["enc_layers"], ENCDEC_ENC_KEYS, "enc_layers")
        _require(tree["dec_layers"], ENCDEC_DEC_KEYS, "dec_layers")
        for stack in ("enc_layers", "dec_layers"):
            _require(tree[stack]["attn"], LM_ATTN_KEYS, f"{stack}.attn")
        _require(tree["dec_layers"]["xattn"], LM_ATTN_KEYS, "dec_layers.xattn")
    elif "layers" in tree and "attn" in tree["layers"]:
        _require(tree, LM_TOP_KEYS, "not a dense/MoE LM param tree")
        layer = tree["layers"]
        _require(layer, LM_LAYER_KEYS, "layers")
        _require(layer["attn"], LM_ATTN_KEYS, "layers.attn")
        if ("mlp" in layer) == ("moe" in layer):
            raise KeyError("layers: a dense/MoE LM layer holds one of 'mlp' "
                           "and 'moe'")
        if "cross" in tree:
            _require(tree["cross"], VLM_CROSS_KEYS, "cross")
            _require(tree["cross"]["attn"], LM_ATTN_KEYS, "cross.attn")
    elif "layers" in tree:
        _require(tree, RWKV6_TOP_KEYS, "not an RWKV-6 param tree")
        _require(tree["layers"], RWKV6_LAYER_KEYS, "layers")
    else:
        _require(tree, TOP_KEYS, "not a DiT-MoE param tree")
        for i, blk in enumerate(tree["blocks"]):
            _require(blk, BLOCK_KEYS, f"block {i}")
    return _convert(tree, resolve_device(device), "params", mesh)


def _require(node, keys, what: str) -> None:
    missing = [k for k in keys if k not in node]
    if missing:
        raise KeyError(f"{what}: missing {missing}")


def leaves(tree) -> Dict[str, torch.Tensor]:
    """Flat {path: leaf} view of a param tree (either framework's), in a
    fixed order."""
    out: Dict[str, Any] = {}
    _leaves_walk(tree, "", out)
    return out


def _leaves_walk(node, path: str, out: Dict[str, Any]) -> None:
    # not a closure: one that calls itself is a reference cycle, which
    # would keep ``out`` and its leaves alive until the next collection
    if isinstance(node, dict):
        for k in sorted(node):
            _leaves_walk(node[k], f"{path}.{k}" if path else k, out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _leaves_walk(v, f"{path}[{i}]", out)
    else:
        out[path] = node
