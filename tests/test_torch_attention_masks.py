"""The port's attention with KV-cache masks against the JAX package's, on
the CPU.

``repro_torch.models.layers.attention`` (the flash wrapper's plain version
on CPU tensors) is held against ``repro.models.layers.attention`` for each
causal x window x softcap x q_offset x kv_valid_len case, against the
reference's blocked online-softmax path (``_blocked_attention``, taken at
Sq * Sk > 2^22), and ``models.dense._decode_attention`` against the
reference's over a ring cache with wrapped and empty slots.  Inputs are
numpy draws from a seed, handed to both frameworks.

Tolerances: f32 1e-5 (sums of up to a few hundred terms in another order);
bf16 2e-2 (as ``tests/test_kernels.py``; the blocked path also rounds q's
scale and the probabilities to bf16 before its products).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import dense as jax_dense
from repro.models import layers as jax_layers
from repro_torch.kernels import ops
from repro_torch.models import dense, layers

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _qkv(seed, B, Sq, Sk, H, KVH, Dh, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, Sq, H, Dh), np.float32),
              rng.standard_normal((B, Sk, KVH, Dh), np.float32),
              rng.standard_normal((B, Sk, KVH, Dh), np.float32)]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# a prefill (q_offset 0) and a chunk of queries continuing a partly filled
# cache (q_offset 20 of 48 slots, 28 of them written)
@pytest.mark.parametrize("q_offset,kv_valid_len", [(0, None), (0, 40),
                                                   (20, 28), (20, None)])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 1, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax(causal, window, softcap, q_offset, kv_valid_len):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 8, 48, 4, 2, 16)
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset, kv_valid_len=kv_valid_len)
    got = layers.attention(tq, tk, tv, **opts)
    want = jax_layers.attention(jq, jk, jv, **opts)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_one_sided_window_closes_the_non_causal_gap():
    """ROADMAP C.9: a non-causal window is one-sided in the reference's
    ``layers.attention`` (pq - pk < window) and symmetric in the Pallas
    kernel.  The port's ``layers.attention`` passes the one-sided mode and
    equals the reference; the kernel's default, the Pallas semantics, is
    what it passed before: 2.11 away at this case."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, 1, 16, 16, 2, 2, 8)
    want = _np(jax_layers.attention(jq, jk, jv, causal=False, window=4))
    got = _np(layers.attention(tq, tk, tv, causal=False, window=4))
    np.testing.assert_allclose(got, want, **TOL["float32"])
    pallas = _np(ops.flash_attention(tq, tk, tv, causal=False, window=4))
    assert float(np.abs(pallas - want).max()) > 1.0
    # causal, the two windows agree
    np.testing.assert_allclose(
        _np(ops.flash_attention(tq, tk, tv, causal=True, window=4)),
        _np(jax_layers.attention(jq, jk, jv, causal=True, window=4)),
        **TOL["float32"])


@pytest.mark.parametrize("case", [
    # Sq * Sk = 4.33e6: gemma2's prefill pattern (causal, local window,
    # softcap) past the reference's dense limit
    dict(shape=(1, 2080, 2080, 2, 1, 16),
         opts=dict(causal=True, window=300, softcap=30.0)),
    # a chunk of 64 queries at the end of a 65,600-slot cache, its tail
    # unwritten: q_offset and kv_valid_len on the blocked path
    dict(shape=(1, 64, 65600, 2, 1, 16),
         opts=dict(causal=True, q_offset=65000, kv_valid_len=65064)),
], ids=["prefill", "cache"])
def test_attention_matches_the_reference_blocked_path(case):
    B, Sq, Sk, H, KVH, Dh = case["shape"]
    assert Sq * Sk > jax_layers._DENSE_SCORE_LIMIT
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, B, Sq, Sk, H, KVH, Dh, "bfloat16")
    got = layers.attention(tq, tk, tv, **case["opts"])
    want = jax_layers.attention(jq, jk, jv, **case["opts"])   # blocked
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


@pytest.mark.parametrize("pos", [5, 15, 37, 100])   # empty slots; full; wrapped
@pytest.mark.parametrize("window,softcap", [(None, None), (8, 50.0), (3, None)])
def test_decode_attention_matches_jax(pos, window, softcap):
    """One query against a 16-slot ring written up to ``pos``: slots past
    pos are empty until the ring wraps, then each holds the last position
    written to it."""
    L = 16
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 2, 1, L, 4, 2, 16)
    slots = np.arange(L)
    slot_pos = pos - ((pos - slots) % L)
    slot_valid = slot_pos >= 0
    assert slot_valid.all() == (pos >= L - 1)
    k_pos = dense.ring_k_pos(pos, L, "cpu")
    np.testing.assert_array_equal(k_pos.numpy(), np.where(slot_valid, slot_pos, -1))
    got = dense._decode_attention(tq, tk, tv, k_pos=k_pos, q_pos=pos, window=window,
                                  softcap=softcap)
    want = jax_dense._decode_attention(
        jq, jk, jv, slot_pos=jnp.asarray(slot_pos),
        slot_valid=jnp.asarray(slot_valid), q_pos=pos,
        window=np.iinfo(np.int32).max if window is None else window,
        softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_k_pos_masks_empty_slots_like_a_shorter_cache():
    """Negative key positions mask those slots: the same as leaving them
    out, at any place in the cache."""
    _, (tq, tk, tv) = _qkv(4, 1, 3, 12, 2, 1, 8)
    k_pos = torch.tensor([0, -1, 1, 2, -1, 3, 4, 5, -1, 6, 7, 8], dtype=torch.int32)
    keep = k_pos >= 0
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=6, k_pos=k_pos,
                              one_sided_window=True, window=4)
    want = ops.flash_attention(tq, tk[:, keep], tv[:, keep], causal=True,
                               q_offset=6, one_sided_window=True, window=4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_flash_wrapper_refuses_bad_masks():
    _, (tq, tk, tv) = _qkv(5, 1, 4, 8, 2, 2, 8)
    with pytest.raises(ValueError, match="k_pos"):
        ops.flash_attention(tq, tk, tv, k_pos=torch.arange(8))       # int64
    with pytest.raises(ValueError, match="k_pos"):
        ops.flash_attention(tq, tk, tv, k_pos=torch.arange(7, dtype=torch.int32))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(tq, tk, tv, q_offset=-1)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(tq, tk, tv, window=2 ** 31)
    with pytest.raises(ValueError, match="kv_valid_len or k_pos"):
        layers.attention(tq, tk, tv, kv_valid_len=3,
                         k_pos=torch.arange(8, dtype=torch.int32))


def test_backward_through_cache_masks_raises():
    """The flash backward takes no KV-cache masks: its forward runs, its
    backward raises and names ROADMAP."""
    _, (tq, tk, tv) = _qkv(6, 1, 4, 8, 2, 2, 8)
    tq.requires_grad_()
    o = layers.attention(tq, tk, tv, q_offset=2, kv_valid_len=6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        o.sum().backward()
