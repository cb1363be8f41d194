"""The port's DiT-MoE training slice against the JAX package, on the CPU.

JAX PRNG keys cannot be replayed in torch, so every random draw of the
reference is handed to the port as an array: the loss's ``t``, ``x0`` and
class-drop mask (split from the step key exactly as ``rf_loss`` splits
it), the latents' classes, channel mix and noise, and the FID proxy's
feature weights.  On the CPU the kernel wrappers run their plain versions,
through the same ``torch.autograd.Function``s the card uses.

Tolerances, with their reasons:
  * AdamW / clip / cosine over 5 steps: 1e-6 (the same f32 arithmetic in
    the same order; only ``pow`` and the reductions may round apart);
  * latents 1e-6, FID-proxy features 1e-5 (f32 matrix products summed in
    another order);
  * the backward plain versions against ``jax.vjp``: rtol 1e-4 / atol
    1e-5 (f32 products of up to 96 terms);
  * step-0 gradients of ``rf_loss`` per leaf:
    ``max|d| <= 1e-4 * max|g_ref| + 1e-6``, with adaLN and ``final_out``
    perturbed (adaLN-zero would make every block's gradient exactly 0);
  * the 30-step training run: losses within rtol 1e-3 of the reference's
    at every step (f32 rounding differences, compounded over 30 AdamW
    steps, observed well below that).
"""
import re
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.configs.dit_moe_xl import smoke as jax_smoke
from repro.configs.dit_moe_xl import tiny as jax_tiny
from repro.data.synthetic import gaussian_mixture_latents as jax_latents
from repro.data.synthetic import latent_batches as jax_latent_batches
from repro.kernels import ref as jax_ref
from repro.models.dit_moe import dit_train_forward as jax_train_forward
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.optim import adamw as jax_adamw
from repro.sampling.rectified_flow import rf_loss as jax_rf_loss
from repro.sampling.rectified_flow import rf_train_step as jax_rf_train_step
from repro_torch import bridge
from repro_torch.checkpoint.io import flatten
from repro_torch.configs.dit_moe_xl import tiny
from repro_torch.core.schedules import DiceConfig
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.metrics import fid_proxy
from repro_torch.models.dit_moe import dit_train_forward
from repro_torch.optim import adamw
from repro_torch.sampling.rectified_flow import (rf_draws, rf_loss, rf_sample,
                                                 rf_train_step)

jax_fid = importlib.import_module("repro.metrics.fid_proxy")
torch.set_num_threads(1)

TINY4 = dict(num_layers=4, d_model=64, moe_d_ff=64, d_ff=256, patch_tokens=16)
STEPS = 30
BATCH = 16
TOL_LOSS = dict(rtol=1e-3, atol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key, shape):
    """The draws ``repro.sampling.rectified_flow.rf_loss`` makes from
    ``key``, as torch tensors."""
    k_t, k_n, k_drop = jax.random.split(key, 3)
    return {"t": _t(jax.random.uniform(k_t, (shape[0],))),
            "x0": _t(jax.random.normal(k_n, shape)),
            "drop": _t(jax.random.bernoulli(k_drop, 0.1, (shape[0],)))}


def _batch(b):
    return {"latents": _t(b["latents"]), "classes": _t(b["classes"])}


# ---------------------------------------------------------------------------
# AdamW, clipping, the schedule
# ---------------------------------------------------------------------------
def test_adamw_clip_cosine_match_reference_over_five_steps():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "blocks": [{"w": (5,), "z": (2, 2, 3)}], "b": ()}

    def tree(scale):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            return np.asarray(scale * rng.standard_normal(node), np.float32)
        return walk(shapes)

    p_np = tree(1.0)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = jax.tree.map(_t, p_np)
    jopt, topt = jax_adamw.adamw_init(jp), adamw.adamw_init(tp)
    for step in range(5):
        g_np = tree(3.0 if step % 2 else 0.1)      # clipped, then not
        jg, jnorm = jax_adamw.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g_np), 1.0)
        tg, tnorm = adamw.clip_by_global_norm(
            jax.tree.map(_t, g_np), 1.0)
        jlr = jax_adamw.cosine_schedule(jopt.step, base_lr=1e-3, warmup=2,
                                        total=10)
        tlr = adamw.cosine_schedule(topt.step, base_lr=1e-3, warmup=2,
                                    total=10)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
        jp, jopt = jax_adamw.adamw_update(jg, jopt, jp, lr=jlr)
        tp, topt = adamw.adamw_update(tg, topt, tp, lr=tlr)
        for want, got in ((jp, tp), (jopt.mu, topt.mu), (jopt.nu, topt.nu)):
            for w, g in zip(jax.tree.leaves(want), adamw.tree_leaves(got)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
        assert int(topt.step) == int(jopt.step) == step + 1
        assert topt.step.dtype == torch.int32


def test_cosine_schedule_warmup_peak_and_floor():
    lrs = [float(adamw.cosine_schedule(torch.tensor(s), base_lr=1.0,
                                       warmup=4, total=12))
           for s in (0, 2, 4, 8, 12, 20)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0) and lrs[3] == pytest.approx(0.5)
    assert lrs[4] == pytest.approx(0.0, abs=1e-7) == lrs[5]


# ---------------------------------------------------------------------------
# synthetic latents and the FID proxy
# ---------------------------------------------------------------------------
def test_latents_match_reference_given_its_draws():
    key = jax.random.PRNGKey(3)
    B, T, C, K = 64, 16, 4, 4
    want_x, want_c = jax_latents(key, batch=B, tokens=T, channels=C,
                                 num_classes=K)
    kc, kn, km = jax.random.split(key, 3)
    x, c = synthetic.gaussian_mixture_latents(
        classes=_t(jax.random.randint(kc, (B,), 0, K)),
        chan_mix=_t(jax.random.normal(km, (1, 1, C))),
        noise=_t(jax.random.normal(kn, (B, T, C))))
    assert x.dtype == torch.float32 and tuple(x.shape) == (B, T, C)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=1e-6,
                               atol=1e-6)


def test_latents_class_conditional():
    """Port of the reference's test: different classes have different
    means (structure, not pure noise), on the port's own draws."""
    x, classes = synthetic.gaussian_mixture_latents(**synthetic.latent_draws(
        torch.Generator().manual_seed(0), batch=64, tokens=16, channels=4,
        num_classes=4))
    assert tuple(x.shape) == (64, 16, 4)
    m0 = x[classes == 0].mean(0)
    m1 = x[classes == 1].mean(0)
    assert float((m0 - m1).abs().max()) > 0.05
    b1 = next(synthetic.latent_batches(batch=8, tokens=16, channels=4,
                                       num_classes=4, seed=5))
    b2 = next(synthetic.latent_batches(batch=8, tokens=16, channels=4,
                                       num_classes=4, seed=5))
    assert torch.equal(b1["latents"], b2["latents"])     # seeded
    assert int(b1["classes"].max()) < 4


def _feature_weights(in_dim, seed=1234, dim=64):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    w1 = jax.random.normal(k1, (in_dim, 128)) / np.sqrt(in_dim)
    w2 = jax.random.normal(k2, (128, dim)) / np.sqrt(128)
    return np.asarray(w1), np.asarray(w2)


def test_fid_proxy_functions_match_reference_given_its_weights():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((32, 16, 4)).astype(np.float32)
    b = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    w = _feature_weights(16 * 4)
    np.testing.assert_allclose(
        fid_proxy._feature_net(a, weights=w),
        np.asarray(jax_fid._feature_net(jnp.asarray(a))), rtol=1e-5, atol=1e-5)
    for got, want in zip(fid_proxy.feature_stats(a, weights=w),
                         jax_fid.feature_stats(a)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fid_proxy.fid_proxy(a, b, weights=w),
                               jax_fid.fid_proxy(a, b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        fid_proxy.inception_score_proxy(a, weights=w),
        jax_fid.inception_score_proxy(a), rtol=1e-5)
    assert fid_proxy.precision_recall_proxy(a, b, weights=w) == \
        jax_fid.precision_recall_proxy(a, b)
    assert fid_proxy.mse_vs_reference(torch.from_numpy(a), b) == \
        jax_fid.mse_vs_reference(a, b)


def test_quality_proxy_metrics():
    """Port of the reference's test on the port's own feature weights:
    identical sets give precision == recall == 1, far-apart sets ~0."""
    a = torch.randn((32, 16, 4), generator=torch.Generator().manual_seed(0))
    p, r = fid_proxy.precision_recall_proxy(a, a)
    assert p == 1.0 and r == 1.0
    p2, r2 = fid_proxy.precision_recall_proxy(a + 100.0, a)
    assert p2 < 0.2 and r2 < 0.2
    assert fid_proxy.inception_score_proxy(a) >= 1.0
    assert fid_proxy.fid_proxy(a, a) == pytest.approx(0.0, abs=1e-6)
    assert fid_proxy.fid_proxy(a + 1.0, a) > 1.0


# ---------------------------------------------------------------------------
# the backward plain versions and the autograd wiring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_bwd_ref_matches_jax_vjp(act):
    rng = np.random.default_rng(2)
    E, C, d, f = 3, 10, 24, 40
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    x[:, 7:] = 0.0                                   # empty capacity rows
    wg, wu = (rng.standard_normal((E, d, f)).astype(np.float32) / np.sqrt(d)
              for _ in range(2))
    wd = rng.standard_normal((E, f, d)).astype(np.float32) / np.sqrt(f)
    dy = rng.standard_normal((E, C, d)).astype(np.float32)
    dy[:, 7:] = 0.0
    _, vjp = jax.vjp(lambda *a: jax_ref.expert_ffn_ref(*a, act=act),
                     *(jnp.asarray(a) for a in (x, wg, wu, wd)))
    want = vjp(jnp.asarray(dy))
    got = ref.expert_ffn_bwd_ref(*(_t(a) for a in (x, wg, wu, wd, dy)), act=act)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    assert not bool(got[0][:, 7:].any())


@pytest.mark.parametrize("dh", [24, 88])
def test_flash_attention_bwd_ref_matches_jax_vjp(dh):
    rng = np.random.default_rng(dh)
    B, Sq, Sk, H = 2, 12, 20, 3
    q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, H, dh)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    o, vjp = jax.vjp(jax_ref.flash_attention_ref,
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q), _t(k), _t(v)
    lse = ref.attention_lse_ref(tq, tk)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, _t(o), lse, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_autograd_functions_run_the_plain_backward_on_cpu():
    """torch.autograd through ops.expert_ffn / ops.flash_attention gives the
    plain backward versions' gradients; no kernel launch is counted on the
    CPU; without grad the serving path is untouched."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 6, 8), generator=g, requires_grad=True)
    ws = [torch.randn(s, generator=g).requires_grad_() for s in
          ((2, 8, 12), (2, 8, 12), (2, 12, 8))]
    dy = torch.randn((2, 6, 8), generator=g)
    before = dict(ops.LAUNCHES)
    y = ops.expert_ffn(x, *ws, act="gelu")
    assert y.grad_fn is not None and "ExpertFFNFn" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, [x, *ws], dy)
    want = ref.expert_ffn_bwd_ref(x.detach(), *(w.detach() for w in ws), dy,
                                  act="gelu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    q, k, v = (torch.randn((2, 9, 3, 16), generator=g, requires_grad=True)
               for _ in range(3))
    o = ops.flash_attention(q, k, v)
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, [q, k, v], do)
    want = ref.flash_attention_bwd_ref(
        q.detach(), k.detach(), v.detach(), o.detach(),
        ref.attention_lse_ref(q.detach(), k.detach()), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.expert_ffn(x, *ws).grad_fn is None
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="out="):
        ops.flash_attention(q, k, v, out=torch.empty_like(o))


@pytest.mark.parametrize("opts", [
    dict(causal=True), dict(window=4, one_sided_window=True), dict(softcap=30.0), "gqa",
    "bf16", "dh160", dict(causal=True, window=3, softcap=5.0), dict(window=4),
    dict(causal=True, q_offset=2)])
def test_flash_backward_raises_for_what_is_not_ported(opts):
    """What training passes (causal, a one-sided window, a softcap, GQA,
    bf16, Dh 160, a query offset: tensor parallelism's "seq" rows) gives
    the plain backward's gradients bit for bit, dk and dv in k's (B, Sk,
    KVH, Dh); the Pallas kernel's symmetric window, which training never
    passes, runs the forward and raises in the backward, naming
    ROADMAP.md.  (The ring cache's key positions raise too:
    ``tests/test_torch_attention_masks.py``.)"""
    g = torch.Generator().manual_seed(5)
    kvh, dtype, dh, kw = 3, torch.float32, 16, {}
    if opts == "gqa":
        kvh = 1
    elif opts == "bf16":
        dtype = torch.bfloat16
    elif opts == "dh160":
        dh = 160
    else:
        kw = opts
    q = torch.randn((1, 8, 3, dh), generator=g).to(dtype).requires_grad_()
    k, v = (torch.randn((1, 8, kvh, dh), generator=g).to(dtype)
            .requires_grad_() for _ in range(2))
    o = ops.flash_attention(q, k, v, **kw)     # the forward runs
    if "window" in kw and not (kw.get("causal") or kw.get("one_sided_window")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            o.sum().backward()
        return
    do = torch.randn(o.shape, generator=g).to(dtype)
    got = torch.autograd.grad(o, (q, k, v), do)
    plain = [t.detach() for t in (q, k, v)]
    masks = dict(causal=bool(kw.get("causal")), window=kw.get("window"),
                 softcap=kw.get("softcap"), q_offset=kw.get("q_offset", 0))
    o32, lse = ref.flash_attention_ref(*plain, one_sided_window=True, stats=True, **masks)
    want = ref.flash_attention_bwd_ref(*plain, o32, lse, do, **masks)
    for a, b, x in zip(got, want, plain):
        assert a.dtype == dtype and a.shape == x.shape
        assert torch.equal(a, b)


def test_rf_draws_distributions():
    gen = torch.Generator().manual_seed(0)
    d = rf_draws(gen, 4000, (4000, 2, 3))
    assert tuple(d["x0"].shape) == (4000, 2, 3) and d["drop"].dtype == torch.bool
    assert 0.0 <= float(d["t"].min()) and float(d["t"].max()) < 1.0
    assert abs(float(d["t"].mean()) - 0.5) < 0.03
    assert abs(float(d["x0"].std()) - 1.0) < 0.03
    assert abs(float(d["drop"].float().mean()) - 0.1) < 0.02


# ---------------------------------------------------------------------------
# rf_loss gradients and the trained model (tests/test_system.py's fixture)
# ---------------------------------------------------------------------------
def _cfgs():
    return jax_tiny().replace(**TINY4), tiny().replace(**TINY4)


def test_get_model_dit_moe_loss_matches_the_reference():
    """get_model for dit_moe, as the reference's api.py builds it: init is
    init_dit, loss_fn the rectified-flow loss, and prefill, decode_step and
    init_cache None.  The reference's loss_fn draws t, x0 and drop from a
    PRNG key torch cannot replay, so the port's takes them as keywords: here
    the reference's own draws from the key, and the losses agree."""
    from repro.models.api import get_model as jax_get_model
    from repro_torch.models.api import get_model
    jcfg, cfg = _cfgs()
    jp = jax_init_dit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(4)
    for blk in jp["blocks"]:
        blk["adaln"] = jnp.asarray(0.05 * rng.standard_normal(blk["adaln"].shape),
                                   jnp.float32)
    b = next(jax_latent_batches(batch=BATCH, tokens=jcfg.patch_tokens,
                                channels=jcfg.in_channels,
                                num_classes=jcfg.num_classes, seed=1))
    key = jax.random.PRNGKey(5)
    jloss, jm = jax_get_model(jcfg).loss_fn(jp, b, jcfg, key=key)
    api = get_model(cfg)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    with torch.no_grad():
        loss, m = api.loss_fn(params, _batch(b), cfg,
                              **_jax_draws(key, b["latents"].shape))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["mse"]), float(jm["mse"]), rtol=1e-5)
    assert api.prefill is None and api.decode_step is None and api.init_cache is None
    with pytest.raises(TypeError, match="key"):
        api.loss_fn(params, _batch(b), cfg, key=key)
    got = api.init(cfg, generator=torch.Generator().manual_seed(0))
    assert [tuple(v.shape) for v in bridge.leaves(got).values()] == \
        [tuple(v.shape) for v in bridge.leaves(jp).values()]


def test_rf_loss_step0_gradients_match_jax_grad():
    jcfg, cfg = _cfgs()
    jp = jax_init_dit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    for blk in jp["blocks"]:
        blk["adaln"] = jnp.asarray(0.05 * rng.standard_normal(blk["adaln"].shape),
                                   jnp.float32)
    jp["final_out"] = jnp.asarray(
        0.05 * rng.standard_normal(jp["final_out"].shape), jnp.float32)
    b = next(jax_latent_batches(batch=BATCH, tokens=jcfg.patch_tokens,
                                channels=jcfg.in_channels,
                                num_classes=jcfg.num_classes, seed=0))
    key = jax.random.PRNGKey(1)
    (jloss, jm), jg = jax.value_and_grad(jax_rf_loss, has_aux=True)(
        jp, b, jcfg, key)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, m = rf_loss(live, _batch(b), cfg,
                      **_jax_draws(key, b["latents"].shape))
    grads = torch.autograd.grad(loss, adamw.tree_leaves(live))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["lb"].detach()), float(jm["lb"]), rtol=1e-5)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = [p for p, _ in flatten(params)[0]]
    assert len(jleaves) == len(grads) == len(paths)
    for (_, want), got, path in zip(jleaves, grads, paths):
        want = np.asarray(want)
        bound = 1e-4 * np.abs(want).max() + 1e-6
        assert np.abs(got.numpy() - want).max() <= bound, path
    # every leaf's gradient is live (not adaLN-zero's exact 0)
    assert all(float(g.abs().max()) > 0 for g in grads)
    # the same capacity drops in the loss's forward (its inputs rebuilt
    # from the draws as rf_loss builds them)
    dr = _jax_draws(key, b["latents"].shape)
    t = dr["t"].numpy()
    xt = t[:, None, None] * np.asarray(b["latents"]) \
        + (1 - t)[:, None, None] * dr["x0"].numpy()
    y_in = np.where(dr["drop"].numpy(), jcfg.num_classes, np.asarray(b["classes"]))
    _, jaux = jax_train_forward(jp, jnp.asarray(xt), jnp.asarray(t),
                                jnp.asarray(y_in), jcfg)
    with torch.no_grad():
        _, aux = dit_train_forward(params, _t(xt), _t(t), _t(y_in), cfg)
    assert float(aux["dropped_frac"]) == pytest.approx(
        float(jaux["dropped_frac"]), abs=1e-7)
    np.testing.assert_array_equal(aux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))


@pytest.fixture(scope="module")
def trained():
    """tests/test_system.py's ``trained`` fixture on both packages: the
    reference's init, batches and step keys; the port gets the reference's
    params (through the bridge), batches and draws."""
    jcfg, cfg = _cfgs()
    jp = jax_init_dit(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    jopt, opt = jax_adamw.adamw_init(jp), adamw.adamw_init(params)
    it = jax_latent_batches(batch=BATCH, tokens=jcfg.patch_tokens,
                            channels=jcfg.in_channels,
                            num_classes=jcfg.num_classes, seed=0)
    jlosses, losses = [], []
    key = jax.random.PRNGKey(1)
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        b = next(it)
        jp, jopt, jm = jax_rf_train_step(jp, jopt, b, k, jcfg)
        params, opt, m = rf_train_step(
            params, opt, _batch(b), cfg,
            draws=_jax_draws(k, b["latents"].shape))
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "mse", "lb", "grad_norm", "lr"}
    return cfg, params, losses, jlosses


def test_training_losses_match_reference(trained):
    _, _, losses, jlosses = trained
    np.testing.assert_allclose(losses, jlosses, **TOL_LOSS)


def test_training_reduces_loss(trained):
    _, _, losses, _ = trained
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9, losses


def _sample(cfg, params, dcfg):
    classes = torch.arange(8) % cfg.num_classes
    noise = _t(jax.random.normal(jax.random.PRNGKey(7),
                                 (8, cfg.patch_tokens, cfg.in_channels)))
    return rf_sample(params, cfg, dcfg, num_steps=8, classes=classes,
                     noise=noise, guidance=1.5)[0]


def test_staleness_quality_ordering(trained):
    """MSE vs sync on the port's trained params: interweaved (1-step) <
    displaced (2-step)."""
    cfg, params, _, _ = trained
    ref_s = _sample(cfg, params, DiceConfig.sync_ep())
    m_i = fid_proxy.mse_vs_reference(
        _sample(cfg, params, DiceConfig.interweaved()), ref_s)
    m_d = fid_proxy.mse_vs_reference(
        _sample(cfg, params, DiceConfig.displaced()), ref_s)
    assert m_i > 0 and m_d > 0
    assert m_i < m_d, f"1-step staleness ({m_i}) must beat 2-step ({m_d})"


def test_selective_sync_improves_quality(trained):
    cfg, params, _, _ = trained
    ref_s = _sample(cfg, params, DiceConfig.sync_ep())
    inter = _sample(cfg, params, DiceConfig.interweaved())
    deep = _sample(cfg, params, DiceConfig(
        schedule=DiceConfig.dice().schedule, sync_policy="deep",
        cond_comm=False))
    assert fid_proxy.mse_vs_reference(deep, ref_s) <= \
        fid_proxy.mse_vs_reference(inter, ref_s) * 1.05


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------
def test_train_cli_checkpoint_reads_in_reference_bit_for_bit(tmp_path, capsys):
    path = str(tmp_path / "smoke.ckpt")
    params = train_cli.main(["--arch", "dit-moe-xl", "--smoke", "--device",
                             "cpu", "--steps", "3", "--batch", "4",
                             "--ckpt", path])
    out = capsys.readouterr().out
    assert "step     2" in out and f"saved {path}" in out
    like = jax_init_dit(jax.random.PRNGKey(0), jax_smoke())
    restored = jax_load_checkpoint(path, like)
    want = [p for _, p in flatten(params)[0]]
    got = jax.tree.leaves(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    assert any(float(w.abs().max()) > 0 for w in want)


@pytest.mark.parametrize("argv", [["--arch", "dit-moe-xl", "--smoke", "--mesh",
                                   "local"],
                                  ["--arch", "rwkv6-3b", "--smoke", "--mesh",
                                   "local"],
                                  ["--arch", "gemma2-9b", "--smoke", "--mesh", "local"],
                                  ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--mesh",
                                   "local"]])
def test_train_cli_refuses_what_is_not_ported(argv, capsys):
    """``--mesh local`` is ported: on one rank it is the 1 x 1 training mesh,
    and every family prints the losses it prints without a mesh (DiT-MoE
    trains as the reference does, its ``train_diffusion`` taking no mesh).
    (The name is kept from when ``--mesh`` raised.)"""
    losses = {}
    for mesh in ("local", "none"):
        train_cli.main(argv[:-1] + [mesh, "--device", "cpu", "--steps", "1", "--batch", "2"])
        losses[mesh] = re.findall(r"loss (\S+)", capsys.readouterr().out)
    assert len(losses["none"]) == 1 and losses["local"] == losses["none"]
