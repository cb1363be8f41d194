"""Public wrappers of the port's CUDA kernels.

Each wrapper takes the tensors of the JAX package's kernel wrapper
(``repro.kernels.ops``).  For a tensor on the CPU it runs the plain
PyTorch version in :mod:`repro_torch.kernels.ref`; for a CUDA tensor it
launches the hand-written kernel or raises — there is no fallback.  It
checks device, dtype, shape and contiguity, allocates every output and
scratch with ``torch.empty``, launches on the current stream and raises
if ``cudaGetLastError`` reports a fault.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do not
count), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.compress.ref import INT8_EPS
from repro_torch.kernels import ref
from repro_torch.kernels.build import library

LAUNCHES: Dict[str, int] = {"expert_ffn": 0, "flash_attention": 0,
                            "residual_int8": 0, "rwkv6_scan": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}
MAX_HEAD_DIM = 256
RWKV6_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_cuda(name: str, tensors) -> int:
    """Common checks; returns the dtype code."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} is not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
    return _DTYPES[dtype]


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """buf (E, C, d); w_gate/w_up (E, d, f); w_down (E, f, d) -> (E, C, d)."""
    if buf.device.type == "cpu":
        return ref.expert_ffn_ref(buf, w_gate, w_up, w_down, act=act)
    if buf.device.type != "cuda":
        raise ValueError(f"expert_ffn: unsupported device {buf.device}")
    if act not in _ACTS:
        raise ValueError(f"expert_ffn: unknown activation {act!r}")
    code = _check_cuda("expert_ffn", (buf, w_gate, w_up, w_down))
    if buf.dim() != 3 or w_gate.dim() != 3:
        raise ValueError("expert_ffn: buf and weights must be 3-D")
    E, C, d = buf.shape
    f = w_gate.shape[-1]
    if (tuple(w_gate.shape) != (E, d, f) or tuple(w_up.shape) != (E, d, f)
            or tuple(w_down.shape) != (E, f, d)):
        raise ValueError(f"expert_ffn: shapes {tuple(buf.shape)}, "
                         f"{tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not agree")
    for t in (buf, w_gate, w_up, w_down):
        if not t.is_contiguous():
            raise ValueError("expert_ffn: inputs must be contiguous")
    if f > 65535 * 64 or d > 65535 * 128:
        raise ValueError(f"expert_ffn: widths d={d}, f={f} exceed the grid")
    lib = library()
    h = torch.empty((E, C, f), dtype=torch.float32, device=buf.device)
    out = torch.empty_like(buf)
    err = lib.dice_expert_ffn(
        buf.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        h.data_ptr(), out.data_ptr(), E, C, d, f, _ACTS[act], code,
        buf.device.index or 0, _stream(buf.device))
    _raise_on("expert_ffn", err)
    LAUNCHES["expert_ffn"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, Dh); k, v (B, Sk, KVH, Dh) -> (B, Sq, H, Dh), read
    through strides (the head dim must be contiguous).  ``out``, a
    (B, Sq, H, Dh) tensor or view with a contiguous head dim, receives the
    result in place of a new tensor (the kernel writes through its
    strides)."""
    if out is not None and (tuple(out.shape) != tuple(q.shape)
                            or out.dtype != q.dtype or out.device != q.device
                            or out.stride(-1) != 1):
        raise ValueError(f"flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype} on its device, head dim contiguous")
    if q.device.type == "cpu":
        o = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    code = _check_cuda("flash_attention", (q, k, v))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, H, Dh)")
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, KVH, Dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not agree")
    if KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention: {H} heads over {KVH} kv heads")
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {Dh} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H={B * H} exceeds the grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             f"contiguous")
    lib = library()
    o = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device) \
        if out is None else out
    err = lib.dice_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Sk, H, KVH, Dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window is not None),
        int(window) if window is not None else 0,
        int(softcap is not None),
        float(softcap) if softcap is not None else 0.0,
        code, q.device.index or 0, _stream(q.device))
    _raise_on("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return o


def residual_int8(value: torch.Tensor, base: torch.Tensor, *,
                  eps: float = INT8_EPS):
    """(N, d) payload + residual base -> (q int8 (N, d), scale f32 (N, 1),
    recon (N, d) value.dtype)."""
    if value.device.type == "cpu":
        return ref.residual_int8_ref(value, base, eps=eps)
    if value.device.type != "cuda":
        raise ValueError(f"residual_int8: unsupported device {value.device}")
    code = _check_cuda("residual_int8", (value, base))
    if value.dim() != 2 or tuple(base.shape) != tuple(value.shape):
        raise ValueError(f"residual_int8: value {tuple(value.shape)} and base "
                         f"{tuple(base.shape)} must be the same (N, d)")
    if not (value.is_contiguous() and base.is_contiguous()):
        raise ValueError("residual_int8: inputs must be contiguous")
    N, d = value.shape
    lib = library()
    q = torch.empty((N, d), dtype=torch.int8, device=value.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=value.device)
    recon = torch.empty_like(value)
    err = lib.dice_residual_int8(
        value.data_ptr(), base.data_ptr(), q.data_ptr(), scale.data_ptr(),
        recon.data_ptr(), N, d, float(eps), code, value.device.index or 0,
        _stream(value.device))
    _raise_on("residual_int8", err)
    LAUNCHES["residual_int8"] += 1
    return q, scale, recon


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """RWKV-6 recurrence.  r, k, v, logw (B, H, T, DK), read through
    strides (the last dim must be contiguous); u (H, DK); s0 (B, H, DK, DK).
    Returns (out (B, H, T, DK) f32, S_T (B, H, DK, DK) f32).

    On the card: r/k/v share one dtype (f32 or bf16), logw and u are f32 or
    that dtype, s0 is f32, and DK is one of ``RWKV6_HEAD_DIMS``; any T >= 1.
    """
    if r.dim() != 4:
        raise ValueError("rwkv6_scan: r, k, v, logw must be (B, H, T, DK)")
    B, H, T, DK = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} differs "
                             f"from r {tuple(r.shape)}")
    if tuple(u.shape) != (H, DK) or tuple(s0.shape) != (B, H, DK, DK):
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} / s0 "
                         f"{tuple(s0.shape)} do not fit r {tuple(r.shape)}")
    if T < 1:
        raise ValueError("rwkv6_scan: T must be at least 1")
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    for t in (k, v, logw, u, s0):
        if t.device != r.device:
            raise ValueError(f"rwkv6_scan: tensors on different devices "
                             f"({t.device} vs {r.device})")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan: r/k/v dtypes {r.dtype}, {k.dtype}, "
                        f"{v.dtype} (one of float32, bfloat16)")
    for name, t in (("logw", logw), ("u", u)):
        if t.dtype not in (torch.float32, r.dtype):
            raise TypeError(f"rwkv6_scan: {name} dtype {t.dtype} (float32 "
                            f"or {r.dtype})")
    if s0.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan: s0 dtype {s0.dtype} (float32)")
    if DK not in RWKV6_HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {DK} not in {RWKV6_HEAD_DIMS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan: {name}'s last dim must be contiguous")
    if not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("rwkv6_scan: u and s0 must be contiguous")
    if B * H > 2**31 - 1:
        raise ValueError(f"rwkv6_scan: B*H={B * H} exceeds the grid")
    lib = library()
    out = torch.empty((B, H, T, DK), dtype=torch.float32, device=r.device)
    s_T = torch.empty((B, H, DK, DK), dtype=torch.float32, device=r.device)
    err = lib.dice_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_T.data_ptr(),
        B, H, T, DK, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logw.stride()[:3], _DTYPES[r.dtype], _DTYPES[logw.dtype],
        _DTYPES[u.dtype], r.device.index or 0, _stream(r.device))
    _raise_on("rwkv6_scan", err)
    LAUNCHES["rwkv6_scan"] += 1
    return out, s_T
