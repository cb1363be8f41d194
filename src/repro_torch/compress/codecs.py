"""Wire codecs: residual compression of staleness-era payloads (port of
``repro.compress.codecs``).

A codec transmits a quantized residual against the staleness cache:

    wire(s)   = encode(value(s) - base(s))
    value'(s) = base(s) + decode(wire(s))        # what the receiver sees
    base(s+1) = value'(s)                        # decoded reconstruction

Both endpoints advance the base from the decoded reconstruction, so sender
and receiver stay bit-synchronized.  :class:`CodecSpec` is hashable so a
planned ``LayerAction`` can carry one; ``wire_bytes_per_row`` is the exact
accounting both the plan and the executed layer report.

On a CUDA tensor ``apply`` sends ``int8_residual`` through the fused
quantize-pack kernel (:func:`repro_torch.kernels.ops.residual_int8`); on a
CPU tensor the same wrapper runs its plain version.  ``topk_residual`` is
plain PyTorch on either device, as the reference leaves it to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.compress import ref as _ref

CODEC_KINDS = ("none", "int8_residual", "topk_residual")


@dataclass(frozen=True)
class CodecSpec:
    """One wire codec, fully static (hashable -> plannable).

    kind
        "none"           identity; bit-exact, full-width wire
        "int8_residual"  per-row symmetric int8 quantization of the
                         residual + one f32 scale per row
        "topk_residual"  sparse delta: the ``topk_frac`` largest-magnitude
                         residual entries per row, value+index pairs
    """
    kind: str = "int8_residual"
    topk_frac: float = 0.125

    def __post_init__(self):
        if self.kind not in CODEC_KINDS:
            raise ValueError(f"unknown codec kind {self.kind!r}; "
                             f"known: {CODEC_KINDS}")
        if not (0.0 < self.topk_frac <= 1.0):
            raise ValueError(f"topk_frac must be in (0, 1], got "
                             f"{self.topk_frac}")

    def keep_count(self, d: int) -> int:
        return max(1, int(d * self.topk_frac))

    def wire_bytes_per_row(self, d: int, itemsize: int = 4) -> int:
        """Bytes one length-``d`` payload row costs on the wire (exact)."""
        if self.kind == "none":
            return d * itemsize
        if self.kind == "int8_residual":
            return d + 4                         # int8 payload + f32 scale
        return self.keep_count(d) * (itemsize + 4)   # values + int32 indices

    def wire_ratio(self, d: int, itemsize: int = 4) -> float:
        """Compressed / raw wire size (<= 1) for a length-``d`` row."""
        return self.wire_bytes_per_row(d, itemsize) / float(d * itemsize)


@dataclass(frozen=True)
class CompressConfig:
    """User-facing compression knob; ``codec="none"`` means compression is
    off and planning is identical to a config without one."""
    codec: str = "none"
    topk_frac: float = 0.125

    def __post_init__(self):
        if self.codec not in CODEC_KINDS:
            raise ValueError(f"unknown codec {self.codec!r}; "
                             f"known: {CODEC_KINDS}")

    def spec(self) -> Optional[CodecSpec]:
        if self.codec == "none":
            return None
        return CodecSpec(kind=self.codec, topk_frac=self.topk_frac)


class Encoded(NamedTuple):
    """A codec's wire representation: the tensors that would be sent."""
    kind: str
    data: Tuple[torch.Tensor, ...]
    d: int


def encode(spec: CodecSpec, r: torch.Tensor) -> Encoded:
    if spec.kind == "none":
        return Encoded(kind="none", data=(r,), d=r.shape[-1])
    if spec.kind == "int8_residual":
        q, scale = _ref.int8_encode(r)
        return Encoded(kind="int8_residual", data=(q, scale), d=r.shape[-1])
    vals, idx = _ref.topk_encode(r, spec.keep_count(r.shape[-1]))
    return Encoded(kind="topk_residual", data=(vals, idx), d=r.shape[-1])


def decode(spec: CodecSpec, enc: Encoded) -> torch.Tensor:
    if spec.kind == "none":
        return enc.data[0]
    if spec.kind == "int8_residual":
        return _ref.int8_decode(*enc.data)
    return _ref.topk_decode(enc.data[0], enc.data[1], enc.d)


def encoded_nbytes(enc: Encoded) -> int:
    """Exact bytes of the wire representation."""
    return int(sum(a.numel() * a.element_size() for a in enc.data))


def roundtrip(spec: CodecSpec, r: torch.Tensor) -> torch.Tensor:
    return decode(spec, encode(spec, r))


def apply(spec: Optional[CodecSpec], value: torch.Tensor,
          base: torch.Tensor, *, guard: bool = False) -> torch.Tensor:
    """Transmit ``value`` as a quantized residual against ``base``; return
    the receiver-side reconstruction (f32 math, cast back to value.dtype).

    ``guard``: rows of ``value`` holding any NaN or Inf are encoded as a
    zero residual, so the receiver reconstructs the (finite, shared)
    ``base`` row instead of poisoning it.  On clean rows the select passes
    everything through, so a guarded healthy wire is bit-identical."""
    if guard and spec is not None and spec.kind != "none":
        ok = torch.isfinite(value).all(-1, keepdim=True)
        value = torch.where(ok, value,
                            base.expand(value.shape).to(value.dtype))
    if spec is None or spec.kind == "none":
        return value
    if spec.kind == "topk_residual":
        v = value.to(torch.float32)
        b = base.to(torch.float32)
        return (b + roundtrip(spec, v - b)).to(value.dtype)
    from repro_torch.kernels.ops import residual_int8
    lead, d = value.shape[:-1], value.shape[-1]
    v2 = value.reshape(-1, d).contiguous()
    b2 = base.expand(value.shape).reshape(-1, d).to(value.dtype)
    _, _, recon = residual_int8(v2, b2.contiguous())
    return recon.reshape(lead + (d,)).to(value.dtype)
