"""Public wrappers of the port's CUDA kernels.

Each wrapper takes the tensors of the JAX package's kernel wrapper
(``repro.kernels.ops``).  For a tensor on the CPU it runs the plain
PyTorch version in :mod:`repro_torch.kernels.ref`; for a CUDA tensor it
launches the hand-written kernel or raises — there is no fallback.  It
checks device, dtype, shape and contiguity, allocates every output and
scratch with ``torch.empty``, launches on the current stream and raises
if ``cudaGetLastError`` reports a fault.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do not
count), so a run can show that its path went through the kernels;
``FLASH_SHAPES`` and ``FLASH_BWD_SHAPES`` split ``flash_attention``'s and
``flash_attention_bwd``'s by (B, Sq, Sk, H, KVH, Dh, causal, window,
softcap), ``FLASH_BWD_OFFSETS`` the same for its launches at a query
offset, ``FFN_BWD_SHAPES`` ``expert_ffn_bwd``'s by (E, C, d, f, dtype).

Training: ``expert_ffn``, ``flash_attention`` and ``rwkv6_scan`` go
through the ``torch.autograd.Function``s :class:`ExpertFFNFn`,
:class:`FlashAttentionFn` and :class:`RWKV6ScanFn` when grad is enabled
and an input requires it; their backward runs the backward kernels
(``expert_ffn_bwd``, ``flash_attention_bwd``, ``rwkv6_scan_bwd``) on the
card and their plain versions on the CPU.
Otherwise the forward path is the serving one, unchanged.

Given ``meta`` tensors (the dry run, :mod:`repro_torch.launch.dryrun`)
every wrapper runs neither the kernel nor its plain version (flash's
plain version would hold the (B, H, Sq, Sk) scores the kernel never
does): it allocates on ``meta`` each output and scratch buffer it
allocates on the card, through the same ``_*_buffers`` function as its
CUDA branch, and records the kernel's work in
:data:`repro_torch.kernels.cost.LEDGER` (the ``_*_costed`` functions).
``LAUNCHES`` and the ``*_SHAPES`` counts do not move.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compress.ref import INT8_EPS
from repro_torch.kernels import cost, ref
from repro_torch.kernels.build import library

LAUNCHES: Dict[str, int] = {"expert_ffn": 0, "flash_attention": 0,
                            "residual_int8": 0, "rwkv6_scan": 0,
                            "expert_ffn_bwd": 0, "flash_attention_bwd": 0,
                            "rwkv6_scan_bwd": 0}
FLASH_SHAPES: Dict[tuple, int] = {}
FLASH_BWD_SHAPES: Dict[tuple, int] = {}
FLASH_BWD_OFFSETS: Dict[tuple, int] = {}
FFN_BWD_SHAPES: Dict[tuple, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}
MAX_HEAD_DIM = 256
_INT32_MAX = 2 ** 31 - 1
RWKV6_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in (FLASH_SHAPES, FLASH_BWD_SHAPES, FLASH_BWD_OFFSETS, FFN_BWD_SHAPES):
        counts.clear()


def _count(counts: Dict[tuple, int], key: tuple) -> None:
    counts[key] = counts.get(key, 0) + 1


def _flash_shape(q, k, causal, window, softcap) -> tuple:
    """The key of ``FLASH_SHAPES`` and ``FLASH_BWD_SHAPES``: (B, Sq, Sk, H,
    KVH, Dh, causal, window, softcap)."""
    B, Sq, H, Dh = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], Dh, bool(causal), window, softcap)


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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _costed(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` takes the dry run's branch (``t`` on
    ``meta``): the card's buffers, the work in the cost ledger, no
    launch."""
    return t.device.type == "meta"


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """buf (E, C, d); w_gate/w_up (E, d, f); w_down (E, f, d) -> (E, C, d).
    With grad enabled and an input that requires it, through
    :class:`ExpertFFNFn`."""
    if _needs_grad(buf, w_gate, w_up, w_down):
        return ExpertFFNFn.apply(buf, w_gate, w_up, w_down, act)
    return _expert_ffn_fwd(buf, w_gate, w_up, w_down, act)


def _check_expert_shapes(name, buf, w_gate, w_up, w_down):
    if buf.dim() != 3 or w_gate.dim() != 3:
        raise ValueError(f"{name}: buf and weights must be 3-D")
    E, C, d = buf.shape
    f = w_gate.shape[-1]
    if (tuple(w_gate.shape) != (E, d, f) or tuple(w_up.shape) != (E, d, f)
            or tuple(w_down.shape) != (E, f, d)):
        raise ValueError(f"{name}: shapes {tuple(buf.shape)}, "
                         f"{tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not agree")
    if f > 65535 * 64 or d > 65535 * 128:
        raise ValueError(f"{name}: widths d={d}, f={f} exceed the grid")
    return E, C, d, f


def _expert_ffn_fwd(buf, w_gate, w_up, w_down, act):
    if _costed(buf):
        return _expert_ffn_costed(buf, w_gate, w_up, w_down)
    if buf.device.type == "cpu":
        return ref.expert_ffn_ref(buf, w_gate, w_up, w_down, act=act)
    if buf.device.type != "cuda":
        raise ValueError(f"expert_ffn: unsupported device {buf.device}")
    if act not in _ACTS:
        raise ValueError(f"expert_ffn: unknown activation {act!r}")
    code = _check_cuda("expert_ffn", (buf, w_gate, w_up, w_down))
    E, C, d, f = _check_expert_shapes("expert_ffn", buf, w_gate, w_up, w_down)
    for t in (buf, w_gate, w_up, w_down):
        if not t.is_contiguous():
            raise ValueError("expert_ffn: inputs must be contiguous")
    lib = library()
    h, out = _expert_ffn_buffers(buf, f)
    err = lib.dice_expert_ffn(
        buf.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        h.data_ptr(), out.data_ptr(), E, C, d, f, _ACTS[act], code,
        buf.device.index or 0, _stream(buf.device))
    _raise_on("expert_ffn", err)
    LAUNCHES["expert_ffn"] += 1
    return out


def _expert_ffn_buffers(buf, f: int):
    """(h, out): what an ``expert_ffn`` launch writes, on buf's device: the
    f32 hidden scratch (E, C, f) and the output."""
    E, C, _ = buf.shape
    return (torch.empty((E, C, f), dtype=torch.float32, device=buf.device),
            torch.empty_like(buf))


def _expert_ffn_costed(buf, w_gate, w_up, w_down):
    """:func:`_expert_ffn_fwd` on ``meta``: its buffers, its work in the
    ledger."""
    E, C, d, f = _check_expert_shapes("expert_ffn", buf, w_gate, w_up, w_down)
    h, out = _expert_ffn_buffers(buf, f)
    del h
    cost.record("expert_ffn", cost.expert_ffn_flops(E, C, d, f),
                cost.nbytes(buf, w_gate, w_up, w_down, out))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    k_pos: Optional[torch.Tensor] = None,
                    one_sided_window: bool = False,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, Dh); k, v (B, Sk, KVH, Dh) -> (B, Sq, H, Dh), read
    through strides (the head dim must be contiguous).  ``out``, a
    (B, Sq, H, Dh) tensor or view with a contiguous head dim, receives the
    result in place of a new tensor (the kernel writes through its
    strides).  With grad enabled and an input that requires it, through
    :class:`FlashAttentionFn` (``out`` then raises).

    KV-cache masks: query row i sits at position ``q_offset + i``; key
    slot j at ``k_pos[j]`` (int32 (Sk,) on q's device; negative marks an
    empty slot), else at j.  The window is the Pallas kernel's, symmetric
    when not causal, unless ``one_sided_window`` (``pq - pk < window``
    only, as ``layers.attention`` applies it)."""
    if _needs_grad(q, k, v):
        if out is not None:
            raise ValueError("flash_attention: out= cannot be combined with "
                             "grad (autograd needs a fresh output)")
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                      q_offset, k_pos, one_sided_window)
    return _flash_attention_fwd(q, k, v, causal=causal, window=window,
                                softcap=softcap, q_offset=q_offset,
                                k_pos=k_pos,
                                one_sided_window=one_sided_window,
                                out=out)[0]


def _check_masks(q, k, q_offset, k_pos, window) -> None:
    """The KV-cache mask arguments the kernel takes: positions and the
    window in int32, ``k_pos`` an int32 (Sk,) vector on q's device."""
    if not isinstance(q_offset, int) or q_offset < 0 \
            or q_offset + q.shape[1] > _INT32_MAX:
        raise ValueError(f"flash_attention: q_offset {q_offset!r} must be an "
                         f"int in [0, 2^31 - Sq]")
    if window is not None and not 0 <= window <= _INT32_MAX:
        raise ValueError(f"flash_attention: window {window} not in "
                         f"[0, 2^31 - 1]")
    if k_pos is not None and (k_pos.dtype != torch.int32
                              or tuple(k_pos.shape) != (k.shape[1],)
                              or k_pos.device != q.device
                              or not k_pos.is_contiguous()):
        raise ValueError(f"flash_attention: k_pos must be a contiguous int32 "
                         f"({k.shape[1]},) tensor on {q.device}, not "
                         f"{k_pos.dtype} {tuple(k_pos.shape)} on "
                         f"{k_pos.device}")


def _flash_attention_fwd(q, k, v, *, causal=False, window=None, softcap=None,
                         q_offset=0, k_pos=None, one_sided_window=False,
                         out=None, want_lse: bool = False):
    """(o, lse, o32).  With ``want_lse`` (no ring-cache key positions
    ``k_pos``: what the backward takes; a ``q_offset`` is fine) ``lse`` is
    the (B, H, Sq) f32 row log-sum-exp of the scaled, capped, masked
    logits and ``o32`` the output unrounded in f32 (``o`` itself for f32
    inputs), the backward's D = rowsum(dO * O); else both are None.  The
    kernel's output is the same with or without them."""
    if want_lse and k_pos is not None:
        raise ValueError("flash_attention: the log-sum-exp is kept only "
                         "without ring-cache key positions (k_pos)")
    if out is not None and (tuple(out.shape) != tuple(q.shape)
                            or out.dtype != q.dtype or out.device != q.device
                            or out.stride(-1) != 1):
        raise ValueError(f"flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype} on its device, head dim contiguous")
    if q.dim() == 4 and k.dim() == 4:
        _check_masks(q, k, q_offset, k_pos, window)
    if _costed(q):
        return _flash_attention_costed(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            k_pos=k_pos, one_sided_window=one_sided_window, out=out,
            want_lse=want_lse)
    if q.device.type == "cpu":
        o32, lse = ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, k_pos=k_pos, one_sided_window=one_sided_window,
            stats=True)
        o = o32.to(q.dtype)
        if not want_lse:
            o32 = lse = None
        elif q.dtype == torch.float32:
            o32 = o
        return (o if out is None else out.copy_(o)), lse, o32
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
    o, lse, o32 = _flash_buffers(q, out, want_lse)
    err = lib.dice_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        0 if o32 is None or o32 is o else o32.data_ptr(),
        0 if k_pos is None else k_pos.data_ptr(), q_offset,
        B, Sq, Sk, H, KVH, Dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window is not None),
        int(window) if window is not None else 0,
        int(not causal and not one_sided_window),
        int(softcap is not None),
        float(softcap) if softcap is not None else 0.0,
        code, q.device.index or 0, _stream(q.device))
    _raise_on("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    _count(FLASH_SHAPES, _flash_shape(q, k, causal, window, softcap))
    return o, lse, o32


def _flash_pairs(q, k, causal, window, q_offset, k_pos, one_sided_window):
    return cost.kept_pairs(q.shape[1], k.shape[1], causal=bool(causal),
                           window=window, q_offset=q_offset,
                           one_sided_window=one_sided_window,
                           k_pos_given=k_pos is not None)


def _flash_buffers(q, out, want_lse: bool):
    """(o, lse, o32): what a ``flash_attention`` launch writes, on q's
    device: the output (``out`` when given) and, with ``want_lse``, the
    (B, H, Sq) f32 log-sum-exp and the f32 output (``o`` itself for f32
    inputs), else None."""
    B, Sq, H, Dh = q.shape
    o = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device) \
        if out is None else out
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    o32 = None
    if want_lse:
        o32 = o if q.dtype == torch.float32 else torch.empty(
            (B, Sq, H, Dh), dtype=torch.float32, device=q.device)
    return o, lse, o32


def _flash_attention_costed(q, k, v, *, causal, window, q_offset, k_pos,
                            one_sided_window, out, want_lse):
    """:func:`_flash_attention_fwd` on ``meta``: its buffers, its work in
    the ledger."""
    B, Sq, H, Dh = q.shape
    o, lse, o32 = _flash_buffers(q, out, want_lse)
    pairs = _flash_pairs(q, k, causal, window, q_offset, k_pos, one_sided_window)
    cost.record("flash_attention", cost.flash_flops(B, H, Dh, pairs),
                cost.nbytes(q, k, v, o, lse, None if o32 is o else o32))
    return o, lse, o32


# ---------------------------------------------------------------------------
# backward kernels and the autograd wiring
# ---------------------------------------------------------------------------
def expert_ffn_bwd(buf: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor, dy: torch.Tensor,
                   *, act: str = "silu"):
    """Gradients of :func:`expert_ffn` for the output gradient ``dy``
    (E, C, d): (dX, dWg, dWu, dWd) in the inputs' dtype, f32 or bf16 (the
    forward's ``G`` and ``U`` are recomputed inside, in f32; a bf16
    gradient is rounded once from its f32 sum)."""
    if _costed(buf):
        return _expert_ffn_bwd_costed(buf, w_gate, w_up, w_down, dy)
    if buf.device.type == "cpu":
        return ref.expert_ffn_bwd_ref(buf, w_gate, w_up, w_down, dy, act=act)
    if buf.device.type != "cuda":
        raise ValueError(f"expert_ffn_bwd: unsupported device {buf.device}")
    if act not in _ACTS:
        raise ValueError(f"expert_ffn_bwd: unknown activation {act!r}")
    code = _check_cuda("expert_ffn_bwd", (buf, w_gate, w_up, w_down, dy))
    E, C, d, f = _check_expert_shapes("expert_ffn_bwd", buf, w_gate, w_up,
                                      w_down)
    if tuple(dy.shape) != (E, C, d):
        raise ValueError(f"expert_ffn_bwd: dy {tuple(dy.shape)} is not "
                         f"{(E, C, d)}")
    for t in (buf, w_gate, w_up, w_down, dy):
        if not t.is_contiguous():
            raise ValueError("expert_ffn_bwd: inputs must be contiguous")
    if E == 0 or C == 0:                # no rows: zero gradients, no launch
        return _zero_ffn_grads(buf, f)
    lay = ffn_bwd_layout(E, C, d, f)
    args, scratch, stage, (dx, dwg, dwu, dwd) = _expert_ffn_bwd_buffers(
        lay, buf, w_gate, w_up, w_down, dy)
    lib = library()
    dp, fp = lay.d, lay.f
    err = lib.dice_expert_ffn_bwd(
        *(t.data_ptr() for t in args), scratch.data_ptr(),
        0 if stage is None else stage.data_ptr(), dx.data_ptr(),
        dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), E, C, dp, fp, lay.c,
        _ACTS[act], code, buf.device.index or 0, _stream(buf.device))
    _raise_on("expert_ffn_bwd", err)
    LAUNCHES["expert_ffn_bwd"] += 1
    _count(FFN_BWD_SHAPES, (E, C, d, f, str(buf.dtype)[6:]))
    return unstage_ffn_bwd_grads(lay, d, f, (dx, dwg, dwu, dwd))


def _zero_ffn_grads(buf, f: int):
    """``expert_ffn_bwd``'s gradients without rows (E or C zero): zeros,
    no launch."""
    E, C, d = buf.shape
    kw = dict(dtype=buf.dtype, device=buf.device)
    return (torch.zeros((E, C, d), **kw), torch.zeros((E, d, f), **kw),
            torch.zeros((E, d, f), **kw), torch.zeros((E, f, d), **kw))


def _expert_ffn_bwd_buffers(lay, buf, w_gate, w_up, w_down, dy):
    """(staged inputs, scratch, stage, (dx, dwg, dwu, dwd)): what an
    ``expert_ffn_bwd`` launch reads and writes at the layout's widths, on
    buf's device.  ``stage`` (bf16 only, else None) holds the five inputs
    widened to f32 by the kernel's first launch; the scratch holds G^T,
    U^T, H^T (then dG^T, dU^T)."""
    E, C = buf.shape[:2]
    args = stage_ffn_bwd_inputs(lay, buf, w_gate, w_up, w_down, dy)
    dp, fp = lay.d, lay.f
    kw = dict(dtype=buf.dtype, device=buf.device)
    f32 = dict(dtype=torch.float32, device=buf.device)
    scratch = torch.empty(lay.scratch, **f32)
    stage = (torch.empty((E * dp * (2 * C + 3 * fp),), **f32)
             if buf.dtype == torch.bfloat16 else None)
    grads = (torch.empty((E, C, dp), **kw), torch.empty((E, dp, fp), **kw),
             torch.empty((E, dp, fp), **kw), torch.empty((E, fp, dp), **kw))
    return args, scratch, stage, grads


def _expert_ffn_bwd_costed(buf, w_gate, w_up, w_down, dy):
    """:func:`expert_ffn_bwd` on ``meta``: its buffers, its work in the
    ledger."""
    E, C, d, f = _check_expert_shapes("expert_ffn_bwd", buf, w_gate, w_up,
                                      w_down)
    if E == 0 or C == 0:
        return _zero_ffn_grads(buf, f)
    lay = ffn_bwd_layout(E, C, d, f)
    args, scratch, stage, grads = _expert_ffn_bwd_buffers(
        lay, buf, w_gate, w_up, w_down, dy)
    del args, scratch, stage
    out = unstage_ffn_bwd_grads(lay, d, f, grads)
    cost.record("expert_ffn_bwd", cost.expert_ffn_bwd_flops(E, C, d, f),
                cost.nbytes(buf, w_gate, w_up, w_down, dy, *out))
    return out


class FFNBwdLayout(NamedTuple):
    """Widths the ``expert_ffn_bwd`` kernel runs at: d and f padded to
    multiples of 4 (TMA's 16-byte row strides of f32: the tensor maps read
    f32 operands only, bf16 inputs widened to f32 first), the scratch's
    capacity stride ``c`` (C padded to a multiple of 4) and the scratch's
    shape (3, E, f, c): G, U and H held transposed, C contiguous.
    ``staged``: d or f was padded, so the wrapper runs on zero-padded
    copies."""
    d: int
    f: int
    c: int
    staged: bool
    scratch: Tuple[int, int, int, int]


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def ffn_bwd_layout(E: int, C: int, d: int, f: int) -> FFNBwdLayout:
    dp, fp, cp = _up4(d), _up4(f), _up4(C)
    return FFNBwdLayout(dp, fp, cp, (dp, fp) != (d, f), (3, E, fp, cp))


def stage_ffn_bwd_inputs(lay: FFNBwdLayout, buf, w_gate, w_up, w_down, dy):
    """(buf, w_gate, w_up, w_down, dy) at the layout's widths: the inputs
    themselves, or copies zero-padded in d and f.  Padded rows and
    columns are zero, so G, U and H are zero there and every gradient
    element inside (d, f) is what it is unpadded.  An input whose first
    element is not 16-byte aligned (a view into a larger tensor), which
    TMA cannot read, is copied."""
    if not lay.staged:
        return tuple(t if t.device.type == "meta" or t.data_ptr() % 16 == 0
                     else t.clone() for t in (buf, w_gate, w_up, w_down, dy))
    d, f = buf.shape[-1], w_gate.shape[-1]
    pd, pf = lay.d - d, lay.f - f
    return (F.pad(buf, (0, pd)), F.pad(w_gate, (0, pf, 0, pd)),
            F.pad(w_up, (0, pf, 0, pd)), F.pad(w_down, (0, pd, 0, pf)),
            F.pad(dy, (0, pd)))


def unstage_ffn_bwd_grads(lay: FFNBwdLayout, d: int, f: int, grads):
    """(dX, dWg, dWu, dWd) at the layout's widths cut back to (d, f)."""
    if not lay.staged:
        return tuple(grads)
    dx, dwg, dwu, dwd = grads
    return (dx[..., :d].contiguous(), dwg[:, :d, :f].contiguous(),
            dwu[:, :d, :f].contiguous(), dwd[:, :f, :d].contiguous())


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention` from its
    unrounded f32 output ``o`` (B, Sq, H, Dh), its row log-sum-exp ``lse``
    (B, H, Sq) f32 (both from ``_flash_attention_fwd(want_lse=True)``)
    and the output gradient ``do``.  Causal or not, a one-sided ``window``
    (``pq - pk < window``, as ``layers.attention`` applies it) and a logit
    ``softcap`` or not, query row i at position ``pq = q_offset + i`` (the
    rank's rows of a sequence split over ``model``; key j at j), GQA (k and
    v (B, Sk, KVH, Dh); dk and dv come back in that shape, summed over each
    kv head's query heads), Sq and Sk free, f32 or bf16 (dq, dk, dv in that
    dtype, rounded once from f32), Dh up to ``MAX_HEAD_DIM``, on the card
    and on the CPU alike."""
    if window is not None and not 0 <= window <= _INT32_MAX:
        raise ValueError(f"flash_attention_bwd: window {window} not in "
                         f"[0, 2^31 - 1]")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention_bwd: softcap {softcap} must be > 0")
    if not isinstance(q_offset, int) or q_offset < 0 \
            or q_offset + q.shape[1] > _INT32_MAX:
        raise ValueError(f"flash_attention_bwd: q_offset {q_offset!r} must be "
                         f"an int in [0, 2^31 - Sq]")
    if _costed(q):
        return _flash_attention_bwd_costed(q, k, v, o, lse, do, causal, window,
                                           q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                           window=window, softcap=softcap,
                                           q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    code = _check_cuda("flash_attention_bwd", (q, k, v, do))
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (B, Sk, KVH, Dh) or tuple(v.shape) != tuple(k.shape)
            or tuple(o.shape) != tuple(q.shape)
            or tuple(do.shape) != tuple(q.shape)):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)} do not "
                         f"agree")
    if KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention_bwd: {H} heads over {KVH} kv heads")
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head_dim {Dh} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if o.dtype != torch.float32 or o.device != q.device:
        raise ValueError("flash_attention_bwd: o must be the forward's f32 "
                         "output on q's device")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 "
                         f"{(B, H, Sq)} on {q.device}")
    if B * H > 65535:
        raise ValueError(f"flash_attention_bwd: B*H={B * H} exceeds the grid")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name}'s head dim must "
                             f"be contiguous")
    lib = library()
    dq, dk, dv, delta = _flash_bwd_buffers(q, k)
    # the instances with the window and softcap masks are a launch of their
    # own (flash_attention_bwd_masked.cu): without them the kernels keep
    # the registers of the unmasked code
    entry = (lib.dice_flash_attention_bwd_masked
             if window is not None or softcap is not None else lib.dice_flash_attention_bwd)
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH, Dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], int(causal), q_offset, int(window is not None),
        int(window) if window is not None else 0, int(softcap is not None),
        float(softcap) if softcap is not None else 0.0, code,
        q.device.index or 0, _stream(q.device))
    _raise_on("flash_attention_bwd", err)
    LAUNCHES["flash_attention_bwd"] += 1
    _count(FLASH_BWD_SHAPES, _flash_shape(q, k, causal, window, softcap))
    if q_offset:
        _count(FLASH_BWD_OFFSETS, _flash_shape(q, k, causal, window, softcap))
    return dq, dk, dv


def _flash_bwd_buffers(q, k):
    """(dq, dk, dv, delta): what a ``flash_attention_bwd`` launch writes,
    on q's device; delta is the (B, H, Sq) f32 D = rowsum(dO * O)."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    return (torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device),
            torch.empty((B, Sk, KVH, Dh), dtype=q.dtype, device=q.device),
            torch.empty((B, Sk, KVH, Dh), dtype=q.dtype, device=q.device),
            torch.empty((B, H, Sq), dtype=torch.float32, device=q.device))


def _flash_attention_bwd_costed(q, k, v, o, lse, do, causal, window, q_offset):
    """:func:`flash_attention_bwd` on ``meta``: its buffers, its work in the
    ledger."""
    B, Sq, H, Dh = q.shape
    dq, dk, dv, delta = _flash_bwd_buffers(q, k)
    del delta
    pairs = _flash_pairs(q, k, causal, window, q_offset, None, True)
    cost.record("flash_attention_bwd", cost.flash_bwd_flops(B, H, Dh, pairs),
                cost.nbytes(q, k, v, o, lse, do, dq, dk, dv))
    return dq, dk, dv


class ExpertFFNFn(torch.autograd.Function):
    """``expert_ffn`` with its backward: the forward kernel and the
    ``expert_ffn_bwd`` kernel on the card, both plain versions on the CPU.
    Saves only the inputs; the backward recomputes ``G`` and ``U``."""

    @staticmethod
    def forward(ctx, buf, w_gate, w_up, w_down, act):
        ctx.act = act
        ctx.save_for_backward(buf, w_gate, w_up, w_down)
        return _expert_ffn_fwd(buf, w_gate, w_up, w_down, act)

    @staticmethod
    def backward(ctx, dy):
        buf, w_gate, w_up, w_down = ctx.saved_tensors
        grads = expert_ffn_bwd(buf, w_gate, w_up, w_down, dy.contiguous(),
                               act=ctx.act)
        return (*grads, None)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward kernel (which
    then also stores the row log-sum-exp and, for bf16, the output in
    f32) and the ``flash_attention_bwd`` kernel on the card, the plain
    versions on the CPU.  Saves q, k, v, the f32 output and the
    log-sum-exp.  Causal or not, with a one-sided window and a softcap or
    not, at a query offset or not (a sequence split over ranks); ring-cache
    key positions and the Pallas kernel's symmetric window (a window
    without ``causal`` or ``one_sided_window``), which training never
    passes, run the forward and raise in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset=0,
                k_pos=None, one_sided_window=False):
        symmetric = window is not None and not causal and not one_sided_window
        ctx.refused = ("ring-cache key positions (k_pos)" if k_pos is not None
                       else "the symmetric window" if symmetric else None)
        o, lse, o32 = _flash_attention_fwd(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, k_pos=k_pos, one_sided_window=one_sided_window,
            want_lse=ctx.refused is None)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o32, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.refused:
            raise NotImplementedError(
                f"flash_attention backward: {ctx.refused} not ported (training "
                f"passes none; ROADMAP.md A)")
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o32, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def residual_int8(value: torch.Tensor, base: torch.Tensor, *,
                  eps: float = INT8_EPS):
    """(N, d) payload + residual base -> (q int8 (N, d), scale f32 (N, 1),
    recon (N, d) value.dtype)."""
    if _costed(value):
        return _residual_int8_costed(value, base)
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
    q, scale, recon = _residual_int8_buffers(value)
    err = lib.dice_residual_int8(
        value.data_ptr(), base.data_ptr(), q.data_ptr(), scale.data_ptr(),
        recon.data_ptr(), N, d, float(eps), code, value.device.index or 0,
        _stream(value.device))
    _raise_on("residual_int8", err)
    LAUNCHES["residual_int8"] += 1
    return q, scale, recon


def _residual_int8_buffers(value):
    """(q, scale, recon): what a ``residual_int8`` launch writes, on
    value's device."""
    N, d = value.shape
    return (torch.empty((N, d), dtype=torch.int8, device=value.device),
            torch.empty((N, 1), dtype=torch.float32, device=value.device),
            torch.empty_like(value))


def _residual_int8_costed(value, base):
    """:func:`residual_int8` on ``meta``: its buffers, its work in the
    ledger."""
    N, d = value.shape
    q, scale, recon = _residual_int8_buffers(value)
    cost.record("residual_int8", cost.residual_int8_flops(N, d),
                cost.nbytes(value, base, q, scale, recon))
    return q, scale, recon


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """RWKV-6 recurrence.  r, k, v, logw (B, H, T, DK), read through
    strides (the last dim must be contiguous); u (H, DK); s0 (B, H, DK, DK).
    Returns (out (B, H, T, DK) f32, S_T (B, H, DK, DK) f32).

    On the card: r/k/v share one dtype (f32 or bf16), logw and u are f32 or
    that dtype, s0 is f32, and DK is one of ``RWKV6_HEAD_DIMS``; any T >= 1.
    With grad enabled and an input that requires it, through
    :class:`RWKV6ScanFn`; otherwise (serving) the kernel alone.
    """
    if _needs_grad(r, k, v, logw, u, s0):
        return RWKV6ScanFn.apply(r, k, v, logw, u, s0)
    return _rwkv6_scan_fwd(r, k, v, logw, u, s0)


def _check_rwkv6_shapes(name, r, k, v, logw, u, s0):
    if r.dim() != 4:
        raise ValueError(f"{name}: r, k, v, logw must be (B, H, T, DK)")
    B, H, T, DK = r.shape
    for arg, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} differs "
                             f"from r {tuple(r.shape)}")
    if tuple(u.shape) != (H, DK) or tuple(s0.shape) != (B, H, DK, DK):
        raise ValueError(f"{name}: u {tuple(u.shape)} / s0 "
                         f"{tuple(s0.shape)} do not fit r {tuple(r.shape)}")
    if T < 1:
        raise ValueError(f"{name}: T must be at least 1")
    return B, H, T, DK


def _check_rwkv6_cuda(name, r, k, v, logw, u, s0):
    """The card's checks shared by the forward and the backward."""
    B, H, T, DK = r.shape
    for t in (k, v, logw, u, s0):
        if t.device != r.device:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {r.device})")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"{name}: r/k/v dtypes {r.dtype}, {k.dtype}, "
                        f"{v.dtype} (one of float32, bfloat16)")
    for arg, t in (("logw", logw), ("u", u)):
        if t.dtype not in (torch.float32, r.dtype):
            raise TypeError(f"{name}: {arg} dtype {t.dtype} (float32 "
                            f"or {r.dtype})")
    if s0.dtype != torch.float32:
        raise TypeError(f"{name}: s0 dtype {s0.dtype} (float32)")
    if DK not in RWKV6_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {DK} not in {RWKV6_HEAD_DIMS}")
    for arg, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg}'s last dim must be contiguous")
    if not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError(f"{name}: u and s0 must be contiguous")
    if B * H > 2**31 - 1:
        raise ValueError(f"{name}: B*H={B * H} exceeds the grid")


def _rwkv6_scan_fwd(r, k, v, logw, u, s0):
    B, H, T, DK = _check_rwkv6_shapes("rwkv6_scan", r, k, v, logw, u, s0)
    if _costed(r):
        return _rwkv6_scan_costed(r, k, v, logw, u, s0)
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    _check_rwkv6_cuda("rwkv6_scan", r, k, v, logw, u, s0)
    lib = library()
    out, s_T = _rwkv6_scan_buffers(r)
    err = lib.dice_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_T.data_ptr(),
        B, H, T, DK, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logw.stride()[:3], _DTYPES[r.dtype], _DTYPES[logw.dtype],
        _DTYPES[u.dtype], r.device.index or 0, _stream(r.device))
    _raise_on("rwkv6_scan", err)
    LAUNCHES["rwkv6_scan"] += 1
    return out, s_T


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                   dout: torch.Tensor, dS_T: Optional[torch.Tensor] = None):
    """Gradients of :func:`rwkv6_scan` for the output gradient ``dout``
    (B, H, T, DK) and the final state's gradient ``dS_T`` (B, H, DK, DK;
    None: the state is not used, as in training).  Returns (dr, dk, dv,
    dlogw, du, ds0): dr/dk/dv in r's dtype, du in u's, dlogw and ds0 f32.

    On the card the inputs are :func:`rwkv6_scan`'s, read the same way;
    ``dout`` is f32 with a contiguous last dim, ``dS_T`` f32 and
    contiguous.  Two launches: the chunked recurrence of
    ``csrc/rwkv6_scan_bwd.cu`` (a block walking the state forward and
    one walking its gradient backward for each (b, h)), then dlogw's
    reverse running sums and du's sum over the batch."""
    B, H, T, DK = _check_rwkv6_shapes("rwkv6_scan_bwd", r, k, v, logw, u, s0)
    if tuple(dout.shape) != (B, H, T, DK):
        raise ValueError(f"rwkv6_scan_bwd: dout {tuple(dout.shape)} is not "
                         f"{(B, H, T, DK)}")
    if dS_T is not None and tuple(dS_T.shape) != (B, H, DK, DK):
        raise ValueError(f"rwkv6_scan_bwd: dS_T {tuple(dS_T.shape)} is not "
                         f"{(B, H, DK, DK)}")
    if _costed(r):
        return _rwkv6_scan_bwd_costed(r, k, v, logw, u, s0, dout, dS_T)
    if r.device.type == "cpu":
        return ref.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dout, dS_T)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    _check_rwkv6_cuda("rwkv6_scan_bwd", r, k, v, logw, u, s0)
    extra = (dout,) if dS_T is None else (dout, dS_T)
    for t in extra:
        if t.device != r.device or t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan_bwd: dout and dS_T must be f32 on "
                            f"{r.device}")
    if dout.stride(-1) != 1:
        raise ValueError("rwkv6_scan_bwd: dout's last dim must be contiguous")
    if dS_T is not None and not dS_T.is_contiguous():
        raise ValueError("rwkv6_scan_bwd: dS_T must be contiguous")
    lib = library()
    dr, dk, dv, dlogw, du, ds0, scratch = _rwkv6_scan_bwd_buffers(r, u)
    err = lib.dice_rwkv6_scan_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), dout.data_ptr(),
        0 if dS_T is None else dS_T.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
        scratch.data_ptr(), B, H, T, DK, *r.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *logw.stride()[:3], *dout.stride()[:3],
        _DTYPES[r.dtype], _DTYPES[logw.dtype], _DTYPES[u.dtype],
        r.device.index or 0, _stream(r.device))
    _raise_on("rwkv6_scan_bwd", err)
    LAUNCHES["rwkv6_scan_bwd"] += 1
    return dr, dk, dv, dlogw, du, ds0


def _rwkv6_scan_buffers(r):
    """(out, S_T): what an ``rwkv6_scan`` launch writes, f32, on r's
    device."""
    B, H, T, DK = r.shape
    return (torch.empty((B, H, T, DK), dtype=torch.float32, device=r.device),
            torch.empty((B, H, DK, DK), dtype=torch.float32, device=r.device))


def _rwkv6_scan_bwd_buffers(r, u):
    """(dr, dk, dv, dlogw, du, ds0, scratch): what an ``rwkv6_scan_bwd``
    launch writes, on r's device.  The scratch holds k (.) dk^st
    (B, H, T, DK), du's parts and Q_T (B, H, DK each)."""
    B, H, T, DK = r.shape
    kw = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty((B, H, T, DK), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    return (dr, dk, dv, torch.empty((B, H, T, DK), **kw),
            torch.empty((H, DK), dtype=u.dtype, device=r.device),
            torch.empty((B, H, DK, DK), **kw),
            torch.empty((B * H * DK * (T + 2),), **kw))


def _rwkv6_scan_costed(r, k, v, logw, u, s0):
    """:func:`_rwkv6_scan_fwd` on ``meta``: its buffers, its work in the
    ledger."""
    B, H, T, DK = r.shape
    out, s_T = _rwkv6_scan_buffers(r)
    cost.record("rwkv6_scan", cost.rwkv6_scan_flops(B, H, T, DK),
                cost.nbytes(r, k, v, logw, u, s0, out, s_T))
    return out, s_T


def _rwkv6_scan_bwd_costed(r, k, v, logw, u, s0, dout, dS_T):
    """:func:`rwkv6_scan_bwd` on ``meta``: its buffers, its work in the
    ledger."""
    B, H, T, DK = r.shape
    dr, dk, dv, dlogw, du, ds0, scratch = _rwkv6_scan_bwd_buffers(r, u)
    del scratch
    cost.record("rwkv6_scan_bwd", cost.rwkv6_scan_bwd_flops(B, H, T, DK),
                cost.nbytes(r, k, v, logw, u, s0, dout, dS_T,
                             dr, dk, dv, dlogw, du, ds0))
    return dr, dk, dv, dlogw, du, ds0


class RWKV6ScanFn(torch.autograd.Function):
    """``rwkv6_scan`` with its backward: the forward kernel and the
    ``rwkv6_scan_bwd`` kernel on the card, both plain versions on the CPU.
    Saves the inputs alone: the backward recomputes the states from ``s0``
    (its final state is the forward's ``S_T``, bit for bit on the card).
    A None cotangent for ``S_T`` goes to the backward as "no dS_T"."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.set_materialize_grads(False)        # an unused output's grad is None
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return _rwkv6_scan_fwd(r, k, v, logw, u, s0)

    @staticmethod
    def backward(ctx, dout, dS_T):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dout = dout.to(torch.float32)
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        if dS_T is not None:
            dS_T = dS_T.to(torch.float32).contiguous()
        grads = rwkv6_scan_bwd(r, k, v, logw, u, s0, dout, dS_T)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (r, k, v, logw, u, s0)))
