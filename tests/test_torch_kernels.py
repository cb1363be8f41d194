"""The port's kernel functions against the JAX package's, on the CPU.

The port's wrappers (``repro_torch.kernels.ops``) run their plain PyTorch
versions for CPU tensors; each is held against the JAX package's Pallas
kernel in interpret mode and against its pure-jnp oracle, on the same
numpy inputs.  The shape sweeps follow ``tests/test_kernels.py``.
Tolerances as there: f32 1e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import ref as jax_codec_ref
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.compress import ref as codec_ref
from repro_torch.kernels import ops

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _both(arrays, dtype_name):
    """numpy f32 arrays -> (jax arrays, torch CPU tensors) in one dtype; both
    frameworks round f32 to bf16 to nearest even, so the inputs agree."""
    jdt, tdt = DTYPES[dtype_name]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _expert_arrays(seed, E, C, d, f):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((E, C, d), np.float32),
            (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)]


@pytest.mark.parametrize("E,C,d,f", [
    (2, 16, 64, 128), (4, 128, 128, 512), (1, 8, 32, 64), (8, 32, 64, 96),
    (2, 136, 64, 96),            # capacity 128 does not divide
    (2, 16, 32, 768),            # hidden width 512 does not divide
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_matches_jax(E, C, d, f, dtype, act):
    (jb, jg, ju, jd), (tb, tg, tu, td) = _both(
        _expert_arrays(E * 1000 + C, E, C, d, f), dtype)
    before = dict(ops.LAUNCHES)
    got = ops.expert_ffn(tb, tg, tu, td, act=act)
    assert ops.LAUNCHES == before       # a CPU tensor takes the plain version
    assert got.dtype == tb.dtype and tuple(got.shape) == (E, C, d)
    want_ref = jax_ref.expert_ffn_ref(jb, jg, ju, jd, act=act)
    np.testing.assert_allclose(_np(got), _np(want_ref), **_tol(dtype))
    if (E, C, d, f) in ((2, 136, 64, 96), (2, 16, 32, 768)):      # ragged tiles
        want_pallas = jax_ops.expert_ffn_pallas(jb, jg, ju, jd, act=act,
                                                interpret=True)
        np.testing.assert_allclose(_np(got), _np(want_pallas), **_tol(dtype))


def _qkv(seed, B, Sq, Sk, H, KVH, Dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, Sq, H, Dh), np.float32),
            rng.standard_normal((B, Sk, KVH, Dh), np.float32),
            rng.standard_normal((B, Sk, KVH, Dh), np.float32)]


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,Dh", [
    (1, 128, 128, 4, 2, 64),
    (2, 128, 256, 8, 8, 32),
    (1, 256, 256, 4, 1, 64),     # strong GQA (MQA)
    (2, 64, 64, 2, 2, 128),
    (2, 64, 64, 4, 4, 72),       # DiT-MoE-XL's head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(B, Sq, Sk, H, KVH, Dh, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B * 100 + Dh, B, Sq, Sk, H, KVH,
                                             Dh), dtype)
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Sq, H, Dh)
    np.testing.assert_allclose(_np(got), _np(jax_ref.flash_attention_ref(
        jq, jk, jv)), **_tol(dtype))
    if (B, Sq, Sk, H, KVH, Dh) == (1, 128, 128, 4, 2, 64):
        np.testing.assert_allclose(_np(got), _np(
            jax_ops.flash_attention_pallas(jq, jk, jv, interpret=True)),
            **_tol(dtype))


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None),
    (False, 64, None),
    (True, 32, None),
    (False, None, 50.0),
    (True, 64, 30.0),            # gemma2 local layer
    (False, 1, None),            # only the diagonal is visible
])
def test_flash_attention_variants_match_jax(causal, window, softcap):
    B, Sq, Sk, H, KVH, Dh = 2, 128, 128, 4, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, B, Sq, Sk, H, KVH, Dh),
                                        "float32")
    opts = dict(causal=causal, window=window, softcap=softcap)
    got = _np(ops.flash_attention(tq, tk, tv, **opts))
    np.testing.assert_allclose(got, _np(jax_ref.flash_attention_ref(
        jq, jk, jv, **opts)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _np(jax_ops.flash_attention_pallas(
        jq, jk, jv, interpret=True, **opts)), rtol=1e-5, atol=1e-5)


def test_flash_attention_odd_blocks_match_jax():
    """Key length that is not a multiple of the preferred block."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, 64, 192, 2, 2, 32),
                                        "float32")
    got = _np(ops.flash_attention(tq, tk, tv, causal=True))
    np.testing.assert_allclose(got, _np(jax_ops.flash_attention_pallas(
        jq, jk, jv, causal=True, interpret=True)), rtol=1e-5, atol=1e-5)


def test_flash_attention_fully_masked_row_is_mean_of_v():
    """Masked logits are -1e30, not -inf: a query row that sees no key
    averages V instead of dividing by zero, as the Pallas kernel does."""
    from repro_torch.kernels.ref import flash_attention_ref
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 1, 8, 8, 2, 2, 16), "float32")
    # causal + a window of 0 masks every key of every row
    got = flash_attention_ref(tq, tk, tv, causal=True, window=0)
    want = tv.mean(dim=1, keepdim=True).expand_as(got)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _np(jax_ref.flash_attention_ref(
        jq, jk, jv, causal=True, window=0)), rtol=1e-5, atol=1e-6)


def _residual_arrays(seed, N, d, ties: bool):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((N, d)).astype(np.float32)
    base = (value + 0.1 * rng.standard_normal((N, d))).astype(np.float32)
    if ties:
        # base 0 and a row abs-max of 127 give scale 1 exactly, so r / scale
        # lands on k + 0.5 and must round half to even
        row = (np.arange(d) % 254 - 126.5).astype(np.float32)
        row[0] = 127.0
        value[: N // 2] = row
        base[: N // 2] = 0.0
    return [value, base]


@pytest.mark.parametrize("N,d", [(64, 128), (48, 1152), (8, 24)])
@pytest.mark.parametrize("ties", [False, True])
def test_residual_int8_matches_jax(N, d, ties):
    (jv, jb), (tv, tb) = _both(_residual_arrays(N + d, N, d, ties), "float32")
    q, scale, recon = ops.residual_int8(tv, tb)
    assert q.dtype == torch.int8 and tuple(scale.shape) == (N, 1)
    jq, js, jr = jax_ops.residual_int8_pallas(jv, jb, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_allclose(recon.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)
    # against the unfused codec oracle of both packages
    rq, rs = jax_codec_ref.int8_encode(jv - jb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    pq, ps = codec_ref.int8_encode(tv - tb)
    np.testing.assert_array_equal(pq.numpy(), q.numpy())
    np.testing.assert_array_equal(ps.numpy(), scale.numpy())
    if ties:
        want = np.round(_residual_arrays(N + d, N, d, True)[0][0])
        np.testing.assert_array_equal(q[0].numpy(), want.astype(np.int8))


def test_residual_int8_zero_residual_uses_eps_scale():
    value = np.ones((4, 32), np.float32)
    (jv, jb), (tv, tb) = _both([value, value.copy()], "float32")
    q, scale, recon = ops.residual_int8(tv, tb)
    jq, js, jr = jax_ops.residual_int8_pallas(jv, jb, interpret=True)
    assert (q == 0).all() and torch.equal(recon, tv)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))


def test_wrappers_refuse_a_device_without_a_kernel():
    """A tensor neither on the CPU nor on CUDA is refused, not computed."""
    x = torch.empty((2, 8, 16), device="meta")
    w = torch.empty((2, 16, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.expert_ffn(x, w, w, w.transpose(1, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(x[None], x[None], x[None])
    with pytest.raises(ValueError, match="unsupported device"):
        ops.residual_int8(x[0], x[0])
