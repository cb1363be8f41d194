"""Config registry of the port: every config of the JAX package's
registry, under the same names: DiT-MoE-XL and DiT-MoE-G (the paper's two
models), rwkv6-3b, the dense and MoE LMs (gemma2-9b, qwen3-moe-30b-a3b,
qwen3-32b, stablelm-12b, deepseek-67b, dbrx-132b), zamba2-7b (hybrid),
llama-3.2-vision-11b (vlm) and seamless-m4t-large-v2 (audio).

``get_config`` / ``get_smoke`` raise ``KeyError`` for a name no registry
has.
"""
from importlib import import_module

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-67b": "deepseek_67b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-32b": "qwen3_32b",
    "zamba2-7b": "zamba2_7b",
    "dbrx-132b": "dbrx_132b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "dit-moe-xl": "dit_moe_xl",
    "dit-moe-g": "dit_moe_g",
}

# the ten assigned LM architectures (the reference's dry-run sweep)
ASSIGNED_ARCHS = list(_MODULES)[:10]


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown config {name!r} (known: {sorted(_MODULES)})")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()


def list_configs():
    return list(_MODULES)
