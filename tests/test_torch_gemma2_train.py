"""The port's training of gemma2-9b and stablelm-12b against the JAX
package, on the CPU: one-sided attention windows, the attention-logit
softcap, and head dims 160 and 256 in the flash backward.

The flash backward's plain version (``kernels/ref.flash_attention_bwd_ref``,
what ``csrc/flash_attention_bwd.cu`` computes) is held against ``jax.vjp``
of the reference's ``layers.attention``: a window with a softcap, a window
alone, a softcap alone, Dh 160 and 256, a non-causal one-sided window, and
a causal case with a window and a softcap past 2^22 scores, where the
reference takes its blocked online-softmax path (as gemma2 does at 8,192
tokens).  Then, at the smoke configs of gemma2-9b (windows of 8 on its
local layer, softcaps 50 and 30) and stablelm-12b, and at each with the
full config's head dim (gemma2 256, stablelm 160), with the reference's
params carried over by ``bridge.from_jax_params`` and tokens from
``token_batches`` (32 a sequence: longer than the window of 8, so the
window bites): the step-0 gradients of ``loss_fn`` against ``jax.grad``
of the reference's, leaf by leaf, and ``lm_train_step`` against the
reference's jitted step.

Tolerances are ``tests/test_torch_lm_train.py``'s, with its reasons: the
plain backward within ``1e-5 * max|want|`` in f32, and in bf16 one bf16
ulp of each element plus that; step-0 gradients by ``GRAD_TOL``; losses
by ``LOSS_RTOL``.  The blocked case runs in f32 only: the reference's
blocked path rounds q * scale and P to bf16 where its dense path does not.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import layers as jax_layers
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.checkpoint.io import flatten
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import lm_train_step
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from test_torch_lm_train import (BATCH, DTYPES, GRAD_TOL, LOSS_RTOL, SEQ, TRAIN_STEPS,
                                 _attn_inputs, _batches, _check_attention_grads,
                                 _jax_train_losses, _np, _port_grads)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# (1) the plain flash backward against jax.vjp of layers.attention
# ---------------------------------------------------------------------------
# (B, Sq, Sk, H, KVH, Dh, causal, window, softcap)
ATTN_CASES = {
    "window 8 and softcap 50, GQA 4 over 2": (2, 40, 40, 4, 2, 32, True, 8, 50.0),
    "window 8 alone": (2, 40, 40, 4, 2, 32, True, 8, None),
    "softcap 5 alone": (2, 40, 40, 4, 2, 32, True, None, 5.0),
    "Dh 160, GQA 8 over 2": (1, 24, 24, 8, 2, 160, True, None, None),
    "Dh 256, window 6, softcap 30": (1, 24, 24, 4, 2, 256, True, 6, 30.0),
    "non-causal one-sided window 5, Sq != Sk": (2, 24, 37, 4, 2, 16, False, 5, 2.0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_soft_capped_backward_matches_jax_vjp(case, dtype):
    B, Sq, Sk, H, KVH, Dh, causal, window, softcap = ATTN_CASES[case]
    masks = dict(causal=causal, window=window, softcap=softcap)
    (jq, jk, jv, jdo), (q, k, v, do) = _attn_inputs(len(case), B, Sq, Sk, H, KVH, Dh, dtype)
    out, vjp = jax.vjp(partial(jax_layers.attention, **masks), jq, jk, jv)
    want = vjp(jdo)
    o32, lse = ref.flash_attention_ref(q, k, v, one_sided_window=True, stats=True, **masks)
    np.testing.assert_allclose(_np(o32.to(q.dtype)), _np(out), rtol=1e-5 if
                               dtype == "float32" else 2.0 ** -7, atol=1e-6)
    got = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, **masks)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _check_attention_grads(got, want, dtype)
    _check_attention_grads(ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, rows=7, **masks),
                           want, dtype)
    # and through the autograd Function, bit for bit with the plain version
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*live, one_sided_window=True, **masks)
    for g, w in zip(torch.autograd.grad(o, live, do), got):
        assert torch.equal(g, w)


def test_windowed_soft_capped_backward_matches_the_blocked_reference():
    """Sq * Sk = 2050^2 > 2^22, causal, window 300, softcap 20: the
    reference's ``layers.attention`` takes ``_blocked_attention`` (online
    softmax over 2,048-key blocks) as gemma2's 8,192-token training does;
    the window drops whole key blocks for the later queries."""
    B, S, H, KVH, Dh = 1, 2050, 2, 1, 16
    assert S * S > jax_layers._DENSE_SCORE_LIMIT
    masks = dict(causal=True, window=300, softcap=20.0)
    (jq, jk, jv, jdo), (q, k, v, do) = _attn_inputs(10, B, S, S, H, KVH, Dh, "float32")
    _, vjp = jax.vjp(partial(jax_layers.attention, **masks), jq, jk, jv)
    o32, lse = ref.flash_attention_ref(q, k, v, one_sided_window=True, stats=True, **masks)
    _check_attention_grads(ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, **masks),
                           vjp(jdo), "float32")


def test_magnitudes_carry_the_softcap_factor():
    """``magnitudes``: the terms' sum under a softcap still bounds each
    gradient element, and it shrinks with the cap's factor (1 - (S/c)^2):
    a tight cap's terms are smaller than an uncapped run's."""
    B, Sq, Sk, H, KVH, Dh, causal, window, softcap = ATTN_CASES[
        "window 8 and softcap 50, GQA 4 over 2"]
    _, (q, k, v, do) = _attn_inputs(12, B, Sq, Sk, H, KVH, Dh, "float32")
    q = q * 4.0                              # logits large enough for a cap of 2 to bite
    terms = {}
    for cap in (None, 2.0):
        masks = dict(causal=True, window=window, softcap=cap)
        o32, lse = ref.flash_attention_ref(q, k, v, one_sided_window=True, stats=True,
                                           **masks)
        grads = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, **masks)
        terms[cap] = ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, magnitudes=True,
                                                 **masks)
        for g, t in zip(grads, terms[cap]):
            assert bool((g.abs() <= t * (1 + 1e-5) + 1e-7).all())
    assert float(terms[2.0][0].abs().sum()) < float(terms[None][0].abs().sum())


# ---------------------------------------------------------------------------
# the smoke models, at their own head dims and at the full configs'
# ---------------------------------------------------------------------------
MODELS = {
    "gemma2-9b": ("gemma2-9b", {}),
    "stablelm-12b": ("stablelm-12b", {}),
    "gemma2-9b at head_dim 256": ("gemma2-9b", {"head_dim": 256}),
    "stablelm-12b at head_dim 160": ("stablelm-12b", {"head_dim": 160}),
}


def _configs(model):
    name, over = MODELS[model]
    return name, jax_get_smoke(name).replace(**over), get_smoke(name).replace(**over)


def _jax_params(jcfg, dtype, seed=0):
    return jax_get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg, dtype=DTYPES[dtype][0])


def test_the_smoke_sequence_is_longer_than_gemma2_s_window():
    _, jcfg, cfg = _configs("gemma2-9b")
    assert cfg.local_global_pattern and SEQ > cfg.sliding_window == jcfg.sliding_window
    assert cfg.attn_logit_softcap and cfg.final_logit_softcap


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_step0_gradients_match_jax_grad(model, dtype):
    name, jcfg, cfg = _configs(model)
    jp = _jax_params(jcfg, dtype)
    (jb, tb), = _batches(name, 1)
    jloss, jg = jax.value_and_grad(lambda p: jax_get_model(jcfg).loss_fn(p, jb, jcfg)[0])(jp)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    ops.reset_launches()
    loss, grads = _port_grads(params, tb, cfg)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 5e-2)
    rel, floor = GRAD_TOL[dtype]
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = [p for p, _ in flatten(params)[0]]
    assert len(jleaves) == len(grads) == len(paths)
    for (_, want), got, path, p in zip(jleaves, grads, paths, adamw.tree_leaves(params)):
        assert got.dtype == p.dtype and got.shape == p.shape, path
        want = _np(want)
        bound = rel * np.abs(want).max() + floor
        assert np.abs(_np(got) - want).max() <= bound, (path, np.abs(_np(got) - want).max(),
                                                         bound)
    # the plain versions ran (no launch is counted on the CPU)
    assert ops.LAUNCHES["flash_attention_bwd"] == 0


@pytest.mark.parametrize("model", ["gemma2-9b", "stablelm-12b at head_dim 160"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_train_step_losses_match_the_reference_step(model, dtype):
    name, jcfg, cfg = _configs(model)
    jp = _jax_params(jcfg, dtype)
    data = _batches(name, TRAIN_STEPS, seed=3)
    want = _jax_train_losses(jcfg, jp, [jb for jb, _ in data], TRAIN_STEPS)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    opt = adamw.adamw_init(params)
    losses = []
    for _, tb in data:
        params, opt, m = lm_train_step(params, opt, tb, cfg, total=TRAIN_STEPS)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL[dtype], atol=0)
    assert tb["tokens"].shape == (BATCH, SEQ)


def test_gemma2_trains_through_its_local_and_global_layers(monkeypatch):
    """Each of the smoke model's layers hands the flash backward its own
    window (8 on the even, local layer, none on the global one) and the
    softcap 50."""
    _, _, cfg = _configs("gemma2-9b")
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0))
    (_, tb), = _batches("gemma2-9b", 1)
    seen = []
    bwd = ops.flash_attention_bwd
    monkeypatch.setattr(ops, "flash_attention_bwd", lambda *a, **kw: seen.append(
        (kw["window"], kw["softcap"])) or bwd(*a, **kw))
    _port_grads(params, tb, cfg)
    assert sorted(seen, key=str) == sorted([(8, 50.0), (None, 50.0)], key=str)
