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
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.num_heads == 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d = self.d_model
        n_q = self.num_heads * self.head_dim
        n_kv = self.num_kv_heads * self.head_dim
        attn = d * n_q + 2 * d * n_kv + n_q * d if self.num_heads else 0
        if self.is_moe:
            ffn = 3 * d * self.expert_d_ff * self.num_experts
            ffn += 3 * d * self.expert_d_ff * self.num_shared_experts
            ffn += d * self.num_experts            # router
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "ssm":                    # rwkv6-style blocks
            attn = 6 * d * d                        # r,k,v,g,o + decay projections
            ffn = 2 * d * self.d_ff + d * d
        if self.family == "hybrid":
            # mamba blocks have no MLP; the attention block (attn + MLP) is
            # weight-SHARED across all its insertion points (zamba2)
            inner = self.ssm_expand * d
            mamba = d * (2 * inner) + inner * d + inner * (2 * self.ssm_state)
            k = max(self.hybrid_attn_every, 1)
            n_mamba = self.num_layers - (self.num_layers // k
                                         if self.hybrid_attn_every else 0)
            shared_attn = 4 * d * d + 3 * d * self.d_ff
            return int(n_mamba * mamba + shared_attn + 2 * self.vocab_size * d)
        per_layer = attn + ffn
        total = self.num_layers * per_layer + 2 * self.vocab_size * d
        if self.encoder_layers:
            total += self.encoder_layers * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        n_q = self.num_heads * self.head_dim
        n_kv = self.num_kv_heads * self.head_dim
        attn = d * n_q + 2 * d * n_kv + n_q * d if self.num_heads else 0
        ffn = 3 * d * self.expert_d_ff * (self.experts_per_token
                                          + self.num_shared_experts)
        per_layer = attn + ffn + d * self.num_experts
        return int(self.num_layers * per_layer + 2 * self.vocab_size * d)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
