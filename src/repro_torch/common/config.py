"""Configuration: the port's copy of ``repro.common.config``.

One flat :class:`ModelConfig` covers every architecture family of the JAX
package; the fields are kept identical so configs compare field-equal
across the two packages.  :class:`ShapeConfig` and :data:`INPUT_SHAPES`
are the reference's assigned input shapes.  :data:`HW` holds the card's
peaks in place of the reference's TPU v5e ones: NVIDIA's data-sheet
values for the H100 SXM5 80GB, which the dry run's roofline and the
kernels' bounds divide by (modelled figures, not measurements).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


# ---------------------------------------------------------------------------
# hardware peaks (H100 SXM5 80GB data sheet, dense, at the 700 W limit; used
# by the roofline and the kernels' bounds, not by the runtime)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class _HW:
    peak_flops_bf16: float = 989e12     # data sheet: BF16 tensor cores, dense
    peak_flops_tf32: float = 495e12     # data sheet: TF32 tensor cores, dense
    peak_flops_fp32: float = 67e12      # data sheet: FP32 outside the tensor cores
    hbm_bw: float = 3.35e12             # data sheet: HBM3 bytes/s
    hbm_bytes: float = 80e9             # data sheet: 80 GB of HBM3 (the card's
                                        # total_memory: 85,017,493,504 B, chip_smoke.py 18d)
    nvlink_bw: float = 450e9            # data sheet: NVLink 4, 900 GB/s both ways
    devices_per_host: int = 8           # a DGX H100 / HGX H100 8-GPU host
    inter_host_bw: float = 50e9         # one 400 Gb/s NIC a GPU, as in a DGX H100


HW = _HW()


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


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}
