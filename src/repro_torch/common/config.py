"""Model configuration: the port's copy of ``repro.common.config.ModelConfig``.

One flat :class:`ModelConfig` covers every architecture family of the JAX
package; the fields are kept identical so configs compare field-equal
across the two packages.  The JAX package's TPU hardware constants are not
carried over: the port measures its card instead of modelling a TPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | dit_moe
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # derived if 0: d_model // num_heads

    # --- attention variants -------------------------------------------------
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_pattern: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    post_norm: bool = False
    embed_scale: bool = False
    act: str = "silu"                # silu | gelu

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    hybrid_attn_every: int = 0

    # --- VLM / audio frontends ------------------------------------------------
    num_image_tokens: int = 0
    cross_attn_every: int = 0
    num_audio_frames: int = 0
    encoder_layers: int = 0

    # --- DiT-MoE (the paper's model) -----------------------------------------
    patch_tokens: int = 0
    num_classes: int = 0
    in_channels: int = 0

    # --- serving variants -----------------------------------------------------
    long_context_window: int = 0

    # --- misc ------------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
