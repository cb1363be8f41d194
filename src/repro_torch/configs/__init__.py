"""Config registry of the port: the configs it can run so far, DiT-MoE-XL
and DiT-MoE-G (the paper's two models), rwkv6-3b and the dense and MoE
LMs (gemma2-9b, qwen3-moe-30b-a3b, qwen3-32b, stablelm-12b, deepseek-67b,
dbrx-132b).

``get_config`` / ``get_smoke`` take the JAX package's registry names; a
name the JAX package has but the port does not yet raises and points at
ROADMAP.md A.12 (other model families).
"""
from importlib import import_module

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-67b": "deepseek_67b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-32b": "qwen3_32b",
    "dbrx-132b": "dbrx_132b",
    "dit-moe-xl": "dit_moe_xl",
    "dit-moe-g": "dit_moe_g",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"config {name!r} is not ported yet (ported: "
                       f"{sorted(_MODULES)}); see ROADMAP.md A.12")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()


def list_configs():
    return list(_MODULES)
