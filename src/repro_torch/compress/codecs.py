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
CPU tensor the same wrapper runs its plain version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.compress import ref as _ref

CODEC_KINDS = ("none", "int8_residual")


@dataclass(frozen=True)
class CodecSpec:
    """One wire codec, fully static (hashable -> plannable).

    kind
        "none"           identity; bit-exact, full-width wire
        "int8_residual"  per-row symmetric int8 quantization of the
                         residual + one f32 scale per row

    The reference's ``topk_residual`` is not in this slice of the port.
    """
    kind: str = "int8_residual"

    def __post_init__(self):
        if self.kind not in CODEC_KINDS:
            raise ValueError(f"unknown codec kind {self.kind!r}; "
                             f"known: {CODEC_KINDS}")

    def wire_bytes_per_row(self, d: int, itemsize: int = 4) -> int:
        """Bytes one length-``d`` payload row costs on the wire (exact)."""
        if self.kind == "none":
            return d * itemsize
        return d + 4                             # int8 payload + f32 scale


@dataclass(frozen=True)
class CompressConfig:
    """User-facing compression knob; ``codec="none"`` means compression is
    off and planning is identical to a config without one."""
    codec: str = "none"

    def __post_init__(self):
        if self.codec not in CODEC_KINDS:
            raise ValueError(f"unknown codec {self.codec!r}; "
                             f"known: {CODEC_KINDS}")

    def spec(self) -> Optional[CodecSpec]:
        if self.codec == "none":
            return None
        return CodecSpec(kind=self.codec)


class Encoded(NamedTuple):
    """A codec's wire representation: the tensors that would be sent."""
    kind: str
    data: Tuple[torch.Tensor, ...]
    d: int


def encode(spec: CodecSpec, r: torch.Tensor) -> Encoded:
    if spec.kind == "none":
        return Encoded(kind="none", data=(r,), d=r.shape[-1])
    q, scale = _ref.int8_encode(r)
    return Encoded(kind="int8_residual", data=(q, scale), d=r.shape[-1])


def decode(spec: CodecSpec, enc: Encoded) -> torch.Tensor:
    if spec.kind == "none":
        return enc.data[0]
    return _ref.int8_decode(*enc.data)


def encoded_nbytes(enc: Encoded) -> int:
    """Exact bytes of the wire representation."""
    return int(sum(a.numel() * a.element_size() for a in enc.data))


def roundtrip(spec: CodecSpec, r: torch.Tensor) -> torch.Tensor:
    return decode(spec, encode(spec, r))


def apply(spec: Optional[CodecSpec], value: torch.Tensor,
          base: torch.Tensor) -> torch.Tensor:
    """Transmit ``value`` as a quantized residual against ``base``; return
    the receiver-side reconstruction (f32 math, cast back to value.dtype).
    The reference's NaN/Inf ``guard`` belongs to the resilience layer,
    which this slice does not port."""
    if spec is None or spec.kind == "none":
        return value
    from repro_torch.kernels.ops import residual_int8
    lead, d = value.shape[:-1], value.shape[-1]
    v2 = value.reshape(-1, d).contiguous()
    b2 = base.expand(value.shape).reshape(-1, d).to(value.dtype)
    _, _, recon = residual_int8(v2, b2.contiguous())
    return recon.reshape(lead + (d,)).to(value.dtype)
