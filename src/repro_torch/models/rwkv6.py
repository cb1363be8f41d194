"""RWKV-6 "Finch" (Peng et al., arXiv:2404.05892), port of
``repro.models.rwkv6``: an attention-free RNN LM.

Data-dependent per-channel decay, token-shift mixing with LoRA-produced
interpolation weights, a bonus term u for the current token, and the RWKV
squared-ReLU channel-mix FFN.  Time mixing per head (DK x DK state S)::

    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(decay_t)).  The recurrence always goes through
:func:`repro_torch.kernels.ops.rwkv6_scan`: the hand-written kernel on the
card, its plain version on the CPU.  Prefill runs it over the prompt,
decode with T = 1 from the carried state; training differentiates
:func:`loss_fn`, whose recurrence then runs the backward kernel too.

Params are a plain dict in the JAX package's layout: ``layers`` holds one
tensor per leaf stacked over a leading layer axis, and the layers run in a
Python loop where the JAX package scans.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L

HEAD_DK = 64     # rwkv6 head size
LORA_MIX = 32
LORA_DECAY = 64


def _heads(cfg) -> int:
    return cfg.d_model // HEAD_DK


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_rwkv6(cfg, *, generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random params on ``generator.device`` in the layout of
    ``repro.models.rwkv6.init_rwkv6``, stacked by
    :func:`~repro_torch.models.layers.stack_layers`.  The
    draws differ from JAX's for the same seed; to run the reference's
    weights use :func:`repro_torch.bridge.from_jax_params`.
    ``generator`` None: the same tree of ``meta`` tensors."""
    g, dev = generator, L.init_device(generator)
    d, H, f = cfg.d_model, _heads(cfg), cfg.d_ff

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def dense(shape, scale=None):
        return L.dense_init(g, shape, scale=scale, dtype=dtype)

    def one_layer():
        return {
            "ln1": L.rmsnorm_init(d, dev),
            "ln2": L.rmsnorm_init(d, dev),
            # token-shift mix coefficients (static part) for r,k,v,w,g
            "mix": const((5, d), 0.5),
            # data-dependent mix LoRA
            "mix_lora_a": dense((d, LORA_MIX)),
            "mix_lora_b": dense((LORA_MIX, 5 * d), scale=0.01),
            "wr": dense((d, d)),
            "wk": dense((d, d)),
            "wv": dense((d, d)),
            "wg": dense((d, d)),
            "wo": dense((d, d)),
            # data-dependent decay LoRA (Finch): w_t from the shifted input
            "decay_base": const((d,), -6.0),
            "decay_lora_a": dense((d, LORA_DECAY)),
            "decay_lora_b": dense((LORA_DECAY, d), scale=0.01),
            "bonus_u": const((H, HEAD_DK), 0.5),
            "ln_x": L.rmsnorm_init(d, dev),                   # group-norm stand-in
            # channel mix (squared relu)
            "cm_mix": const((2, d), 0.5),
            "cm_k": dense((d, f)),
            "cm_v": dense((f, d)),
            "cm_r": dense((d, d)),
        }

    layers = L.stack_layers(one_layer, cfg.num_layers)
    return {
        "embed": dense((cfg.vocab_size, d), scale=0.02),
        "layers": layers,
        "final_norm": L.rmsnorm_init(d, dev),
        "unembed": dense((cfg.vocab_size, d), scale=d ** -0.5),
    }


# ---------------------------------------------------------------------------
# time mixing
# ---------------------------------------------------------------------------
def _shift(x: torch.Tensor, x_first: torch.Tensor) -> torch.Tensor:
    """The sequence shifted right by one, ``x_first`` at position 0."""
    return torch.cat([x_first[:, None], x[:, :-1]], dim=1)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it: 1 / (1 + exp(-x)) with each
    op rounded to x's dtype (``torch.sigmoid`` rounds once, which moves
    about a third of bf16 outputs by one ulp)."""
    return 1 / (1 + torch.exp(-x))


def _mix_inputs(p, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token-shift interpolation with data-dependent LoRA weights.

    x, x_prev: (B, T, d).  Returns the five mixed streams (r, k, v, w, g
    inputs) as (B, T, 5, d)."""
    B, T, d = x.shape
    dd = torch.tanh(x @ p["mix_lora_a"]) @ p["mix_lora_b"]
    mix = torch.clamp(p["mix"][None, None] + dd.reshape(B, T, 5, d), 0.0, 1.0)
    return x[:, :, None, :] * mix + x_prev[:, :, None, :] * (1.0 - mix)


def _rkvwg(p, x, x_prev, cfg):
    """r, k, v (B, T, H, DK) in the param dtype, logw (B, T, H, DK) f32 and
    the gate g (B, T, d)."""
    B, T, d = x.shape
    H = _heads(cfg)
    m = _mix_inputs(p, x, x_prev)
    r = (m[:, :, 0] @ p["wr"]).reshape(B, T, H, HEAD_DK)
    k = (m[:, :, 1] @ p["wk"]).reshape(B, T, H, HEAD_DK)
    v = (m[:, :, 2] @ p["wv"]).reshape(B, T, H, HEAD_DK)
    lora = torch.tanh(m[:, :, 3] @ p["decay_lora_a"]) @ p["decay_lora_b"]
    # the reference's ``(base + lora).astype(f32)``: XLA adds in f32 and does
    # not round the sum to bf16 (an ulp there is 0.03 at decay ~ -6)
    decay = p["decay_base"].to(torch.float32)[None, None] + lora.to(torch.float32)
    logw = -torch.exp(decay)                                 # <= 0
    gate = m[:, :, 4] @ p["wg"]
    g = gate * _sigmoid(gate)                                # jax.nn.silu
    return r, k, v, logw.reshape(B, T, H, HEAD_DK), g


def _time_mix_scan(p, x, x_first, S0, cfg):
    """The RWKV-6 recurrence over (B, T, d).

    x_first: (B, d) token-shift input for position 0 (zeros at the start
    of a sequence, the previous token's activations when continuing from
    state).  S0: (B, H, DK, DK) f32.  Returns (out, S_T, x_last)."""
    B, T, d = x.shape
    r, k, v, logw, g = _rkvwg(p, x, _shift(x, x_first), cfg)
    # (B, T, H, DK) -> (B, H, T, DK) views: the kernel reads through strides
    out, S = ops.rwkv6_scan(*(a.permute(0, 2, 1, 3) for a in (r, k, v, logw)),
                            p["bonus_u"], S0)
    out = out.permute(0, 2, 1, 3).reshape(B, T, d)
    out = L.rmsnorm(p["ln_x"], out.to(x.dtype))          # default eps, as in JAX
    return (out * g) @ p["wo"], S, x[:, -1]


def _channel_mix(p, x, x_first):
    x_prev = _shift(x, x_first)
    mk, mr = p["cm_mix"][0], p["cm_mix"][1]
    xk = x * mk + x_prev * (1 - mk)
    xr = x * mr + x_prev * (1 - mr)
    h = torch.square(torch.relu(xk @ p["cm_k"]))
    return _sigmoid(xr @ p["cm_r"]) * (h @ p["cm_v"]), x[:, -1]


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
def init_state(cfg, batch: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, Any]:
    """Zero recurrent state: S f32; the token-shift states bf16 whatever
    the param dtype, as in the JAX package; ``pos`` counts tokens."""
    dev = resolve_device(device)
    n, H, d = cfg.num_layers, _heads(cfg), cfg.d_model
    return {
        "S": torch.zeros((n, batch, H, HEAD_DK, HEAD_DK), dtype=torch.float32,
                         device=dev),
        "tm_x": torch.zeros((n, batch, d), dtype=torch.bfloat16, device=dev),
        "cm_x": torch.zeros((n, batch, d), dtype=torch.bfloat16, device=dev),
        "pos": 0,
    }


def forward(params, tokens: torch.Tensor, cfg, *, state=None):
    """Teacher-forced logits (B, T, V); also returns the final state."""
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    if state is None:
        state = init_state(cfg, B, x.device)
    S_out, tm_out, cm_out = [], [], []
    for i, p in enumerate(L.unstack_layers(params["layers"], cfg.num_layers)):
        h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
        tm, S, tm_x = _time_mix_scan(p, h, state["tm_x"][i].to(h.dtype),
                                     state["S"][i], cfg)
        # ln2 normalises the f32 sum: XLA feeds the reference's rmsnorm
        # (``x.astype(f32)`` of a bf16 add) the unrounded sum
        x32 = x.to(torch.float32) + tm.to(torch.float32)
        x = x32.to(x.dtype)
        h = L.rmsnorm(p["ln2"], x32, eps=cfg.norm_eps).to(x.dtype)
        cm, cm_x = _channel_mix(p, h, state["cm_x"][i].to(h.dtype))
        x = x + cm
        S_out.append(S)
        tm_out.append(tm_x)
        cm_out.append(cm_x)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = x @ params["unembed"].T
    # the token-shift state is carried in bf16 whatever the param dtype
    new_state = {"S": torch.stack(S_out),
                 "tm_x": torch.stack(tm_out).to(torch.bfloat16),
                 "cm_x": torch.stack(cm_out).to(torch.bfloat16),
                 "pos": state["pos"] + T}
    return logits, new_state


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy of ``batch`` (tokens, labels).
    Differentiable: with grad enabled and params that require it, the
    recurrence goes through ``ops.RWKV6ScanFn`` (its backward kernel on the
    card) and the rest through PyTorch's autograd
    (``launch/train.lm_train_step``)."""
    logits, _ = forward(params, batch["tokens"], cfg)
    ce = L.softmax_cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce}


def prefill(params, tokens: torch.Tensor, cfg):
    """Logits of the last prompt position (B, V) and the state after it."""
    logits, state = forward(params, tokens, cfg)
    return logits[:, -1], state


def decode_step(params, token: torch.Tensor, state, cfg):
    """O(1) per-token decode from the recurrent state: token (B,) ->
    (logits (B, V), new state)."""
    logits, new_state = forward(params, token[:, None], cfg, state=state)
    return logits[:, 0], new_state
