"""The port's CUDA kernels on the card: each against its plain PyTorch
version, its launch counter, and the wrapper's input checks.

Every test here needs a CUDA device and is marked ``cuda``; without one it
skips.  This file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX.)  Tolerances: f32
1e-4 (sums of up to a few thousand terms in another order than cuBLAS'),
bf16 2e-2; the int8 codec's q and scale must agree exactly.
"""
import math

import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _launched(name, fn):
    before = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    return out


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("E,C,d,f", [(2, 16, 64, 128), (8, 32, 64, 96),
                                     (2, 136, 64, 768), (1, 8, 72, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_kernel(gen, E, C, d, f, dtype, act):
    kw = dict(generator=gen, device="cuda")
    buf = torch.randn((E, C, d), **kw).to(dtype)
    wg = (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype)
    wu = (torch.randn((E, d, f), **kw) / math.sqrt(d)).to(dtype)
    wd = (torch.randn((E, f, d), **kw) / math.sqrt(f)).to(dtype)
    got = _launched("expert_ffn", lambda: ops.expert_ffn(buf, wg, wu, wd, act=act))
    assert got.dtype == dtype and got.shape == buf.shape
    _close(got, ref.expert_ffn_ref(buf, wg, wu, wd, act=act), dtype)


@pytest.mark.parametrize("shape,opts", [
    ((2, 64, 64, 4, 4, 72), {}),
    ((2, 128, 128, 4, 2, 64), dict(causal=True)),
    ((2, 128, 128, 4, 2, 64), dict(window=64)),
    ((2, 128, 128, 4, 2, 64), dict(causal=True, window=64, softcap=30.0)),
    ((1, 64, 100, 4, 1, 32), {}),                  # MQA, ragged key tile
    ((1, 16, 16, 2, 2, 256), dict(causal=True, window=0)),   # all masked
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(gen, shape, opts, dtype):
    B, Sq, Sk, H, KVH, Dh = shape
    kw = dict(generator=gen, device="cuda")
    q = torch.randn((B, Sq, H, Dh), **kw).to(dtype)
    k = torch.randn((B, Sk, KVH, Dh), **kw).to(dtype)
    v = torch.randn((B, Sk, KVH, Dh), **kw).to(dtype)
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v, **opts))
    _close(got, ref.flash_attention_ref(q, k, v, **opts), dtype)


def test_flash_attention_reads_strided_inputs(gen):
    """q/k/v sliced out of one fused projection: no copy is made."""
    qkv = torch.randn((2, 64, 3, 4, 32), generator=gen, device="cuda")
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = _launched("flash_attention", lambda: ops.flash_attention(q, k, v))
    _close(got, ref.flash_attention_ref(q, k, v), torch.float32)


@pytest.mark.parametrize("N,d", [(64, 1152), (33, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_int8_kernel(gen, N, d, dtype):
    value = torch.randn((N, d), generator=gen, device="cuda")
    base = value + 0.1 * torch.randn((N, d), generator=gen, device="cuda")
    ties = torch.arange(d, device="cuda", dtype=torch.float32) % 254 - 126.5
    ties[0] = 127.0
    value[:4], base[:4] = ties, 0.0
    value, base = value.to(dtype), base.to(dtype)
    q, s, r = _launched("residual_int8", lambda: ops.residual_int8(value, base))
    qp, sp, rp = ref.residual_int8_ref(value, base)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(q[0].float(), torch.round(ties))
    _close(r, rp, dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn((2, 8, 16), generator=gen, device="cuda")
    w = torch.randn((2, 16, 32), generator=gen, device="cuda")
    wd = torch.randn((2, 32, 16), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        ops.expert_ffn(x.double(), w.double(), w.double(), wd.double())
    with pytest.raises(ValueError):
        ops.expert_ffn(x, w, w, wd.transpose(1, 2).contiguous())
    with pytest.raises(ValueError):                   # not contiguous
        ops.expert_ffn(torch.randn((2, 16, 8), device="cuda").transpose(1, 2),
                       w, w, wd)
    with pytest.raises(ValueError):
        ops.expert_ffn(x, w.cpu(), w, wd)
    q = torch.randn((1, 8, 2, 300), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)                  # head_dim over 256
    with pytest.raises(ValueError):
        ops.residual_int8(x[0], x[1].t())
