"""The port's VLM (Llama-3.2-Vision) against the JAX package's, on the CPU.

``repro_torch.models.vlm`` (``_image_kv``, ``_cross_block``, ``forward``,
``loss_fn``, ``prefill``, ``init_cache``, ``decode_step``) is held against
``repro.models.vlm`` with the reference's own params (``init_vlm``) carried
over by ``bridge.from_jax_params``, tokens and bf16 stub image embeddings
drawn from a seed with numpy.  The cross blocks' tanh gates are drawn off
their zero init: at 0 the whole cross path would add nothing.  Two layouts:
``smoke()`` (4 self layers, 1 cross block) and a ragged one (7 layers at
``cross_attn_every`` 5: 2 trailing self layers).  Attention runs the flash
wrapper's plain version, as on the CPU it does.

Decode follows ``tests/test_streaming.py``: the prefill's cache (exactly the
prompt's slots) copied into ``init_cache`` with room for the steps.

Tolerances: f32 params 1e-4, bf16 params 5e-2 (``tests/test_torch_dense.py``'s
MODEL_TOL); no bf16 rounding point sits on an f32 model's path (the bf16
image embeddings cast to f32 exactly).
"""
import dataclasses
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JaxModelConfig
from repro.models import vlm as jax_vlm
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import vlm
from repro_torch.models.api import get_model

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
B, PROMPT, DECODE = 2, 16, 8
NAME = "llama-3.2-vision-11b"
LAYOUTS = {"smoke": get_smoke(NAME),
           "ragged": get_smoke(NAME).replace(name="llama-vision-smoke-ragged",
                                             num_layers=7)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, dtype, seed=0):
    """The reference's params with the cross gates drawn in [0.3, 1.2], and
    the port's copy."""
    jp = jax_vlm.init_vlm(jax.random.PRNGKey(seed), _jax_cfg(cfg), dtype=DTYPES[dtype][0])
    rng = np.random.default_rng(seed + 50)
    for g in ("gate_attn", "gate_mlp"):
        jp["cross"][g] = jnp.asarray(rng.uniform(0.3, 1.2, jp["cross"][g].shape), jnp.float32)
    return jp, bridge.from_jax_params(jax.device_get(jp), device="cpu")


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT + DECODE), dtype=np.int32)
    img = jnp.asarray(rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model)),
                      jnp.bfloat16)
    t_img = torch.from_numpy(np.asarray(img).view(np.int16).copy()).view(torch.bfloat16)
    return toks, img, t_img


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_field_equal_to_jax(which):
    mod = "llama32_vision_11b"
    ours = getattr(importlib.import_module(f"repro_torch.configs.{mod}"), which)()
    ref = getattr(importlib.import_module(f"repro.configs.{mod}"), which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert (get_config(NAME) if which == "config" else get_smoke(NAME)) == ours


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_jax(dtype):
    cfg = LAYOUTS["ragged"]
    got = vlm.init_vlm(cfg, generator=torch.Generator().manual_seed(0), dtype=DTYPES[dtype][1])
    want = jax_vlm.init_vlm(jax.random.PRNGKey(0), _jax_cfg(cfg), dtype=DTYPES[dtype][0])
    shapes = lambda t: {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))  # noqa: E731
                        for k, v in bridge.leaves(t).items()}
    assert shapes(got) == shapes(want)
    assert not got["cross"]["gate_attn"].any() and got["cross"]["gate_attn"].dtype == torch.float32
    c = vlm.init_cache(cfg, 3, 11, dtype=DTYPES[dtype][1], device="cpu")
    jc = jax_vlm.init_cache(_jax_cfg(cfg), 3, 11, dtype=DTYPES[dtype][0])
    assert {k: tuple(v.shape) for k, v in c.items() if k != "pos"} == \
        {k: tuple(v.shape) for k, v in jc.items() if k != "pos"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_matches_jax(layout, dtype):
    """The image K/V, forward's logits, loss_fn, prefill's logits and cache
    (k, v, img_k, img_v) leaf by leaf, then DECODE steps from the cache
    copied into init_cache: logits each step, the cache after."""
    cfg = LAYOUTS[layout]
    jcfg = _jax_cfg(cfg)
    jdt, tdt = DTYPES[dtype]
    tol = MODEL_TOL[dtype]
    jp, tp = _params(cfg, dtype)
    toks, img, t_img = _inputs(cfg, 1)
    tt = torch.from_numpy(toks)

    want_k, want_v = jax.jit(jax_vlm._image_kv, static_argnums=2)(jp, img, jcfg)
    got_k, got_v = vlm._image_kv(tp, t_img, cfg)
    assert got_k.dtype == tdt
    _close(got_k, want_k, tol, "img_k")
    _close(got_v, want_v, tol, "img_v")

    want, _ = jax.jit(jax_vlm.forward, static_argnums=3)(jp, jnp.asarray(toks), img, jcfg)
    with torch.no_grad():
        got, aux = vlm.forward(tp, tt, t_img, cfg)
    assert got.dtype == tdt and tuple(got.shape) == (B, PROMPT + DECODE, cfg.vocab_size)
    _close(got, want, tol, "forward logits")

    labels = np.roll(toks, -1, axis=1)
    want_loss, _ = jax.jit(jax_vlm.loss_fn, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "image_embeds": img}, jcfg)
    with torch.no_grad():
        got_loss, _ = vlm.loss_fn(tp, {"tokens": tt, "labels": torch.from_numpy(labels),
                                       "image_embeds": t_img}, cfg)
    _close(got_loss, want_loss, tol, "loss")

    want_lg, c0 = jax.jit(jax_vlm.prefill, static_argnums=3)(
        jp, jnp.asarray(toks[:, :PROMPT]), img, jcfg)
    with torch.no_grad():
        got_lg, tc0 = vlm.prefill(tp, tt[:, :PROMPT], t_img, cfg)
    _close(got_lg, want_lg, tol, "prefill logits")
    for k in ("k", "v", "img_k", "img_v"):
        _close(tc0[k], c0[k], tol, f"prefill cache {k}")
    assert tc0["k"].shape[2] == PROMPT and tc0["pos"] == int(c0["pos"]) == PROMPT

    n = PROMPT + DECODE
    jc = jax_vlm.init_cache(jcfg, B, n, dtype=jdt)
    jc["k"] = jc["k"].at[:, :, :PROMPT].set(c0["k"])
    jc["v"] = jc["v"].at[:, :, :PROMPT].set(c0["v"])
    jc["img_k"], jc["img_v"], jc["pos"] = c0["img_k"], c0["img_v"], c0["pos"]
    tc = vlm.init_cache(cfg, B, n, dtype=tdt, device="cpu")
    tc["k"][:, :, :PROMPT] = tc0["k"]
    tc["v"][:, :, :PROMPT] = tc0["v"]
    tc["img_k"], tc["img_v"], tc["pos"] = tc0["img_k"], tc0["img_v"], tc0["pos"]
    jdec = jax.jit(jax_vlm.decode_step, static_argnums=3)
    for t in range(PROMPT, n):
        want_lg, jc = jdec(jp, jnp.asarray(toks[:, t]), jc, jcfg)
        with torch.no_grad():
            got_lg, tc = vlm.decode_step(tp, tt[:, t], tc, cfg)
        _close(got_lg, want_lg, tol, f"decode {t} logits")
        assert tc["pos"] == int(jc["pos"]) == t + 1
    for k in ("k", "v"):
        _close(tc[k], jc[k], tol, f"decoded cache {k}")


def test_long_context_windows_match_jax():
    """long_context=True caps every self layer's window at the smoke
    config's 16, under 24 tokens: forward and a ring decode that wraps."""
    cfg = LAYOUTS["ragged"]
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg, "float32", seed=1)
    toks, img, t_img = _inputs(cfg, 2)
    want, _ = jax.jit(partial(jax_vlm.forward, cfg=jcfg, long_context=True))(
        jp, jnp.asarray(toks), img)
    with torch.no_grad():
        got, _ = vlm.forward(tp, torch.from_numpy(toks), t_img, cfg, long_context=True)
    _close(got, want, MODEL_TOL["float32"])
    _, c0 = jax.jit(jax_vlm.prefill, static_argnums=3)(jp, jnp.asarray(toks[:, :PROMPT]),
                                                     img, jcfg)
    with torch.no_grad():
        _, tc = vlm.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), t_img, cfg)
    jdec = jax.jit(partial(jax_vlm.decode_step, cfg=jcfg, long_context=True))
    for t in range(PROMPT, PROMPT + 4):                 # past the 16 slots: wraps
        want_lg, c0 = jdec(jp, jnp.asarray(toks[:, t]), c0)
        with torch.no_grad():
            got_lg, tc = vlm.decode_step(tp, torch.from_numpy(toks[:, t]), tc, cfg,
                                         long_context=True)
        _close(got_lg, want_lg, MODEL_TOL["float32"], f"step {t}")


def test_prefill_cache_len_leaves_room_for_decode():
    """prefill(cache_len=) (the port's, as dense.prefill's) writes the
    prompt into the first S slots of a longer zeroed cache; decode then
    continues it as it does the init_cache copy, and agrees with the
    teacher-forced forward."""
    cfg = LAYOUTS["smoke"]
    _, tp = _params(cfg, "float32")
    toks, _, t_img = _inputs(cfg, 3)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        lg, c = vlm.prefill(tp, tt[:, :PROMPT], t_img, cfg)
        lg2, c2 = vlm.prefill(tp, tt[:, :PROMPT], t_img, cfg, cache_len=PROMPT + 2)
        assert torch.equal(lg, lg2) and torch.equal(c2["k"][:, :, :PROMPT], c["k"])
        assert not c2["v"][:, :, PROMPT:].any()
        full, _ = vlm.forward(tp, tt, t_img, cfg)
        for t in (PROMPT, PROMPT + 1):
            lg2, c2 = vlm.decode_step(tp, tt[:, t], c2, cfg)
            _close(lg2, full[:, t], MODEL_TOL["float32"])
    with pytest.raises(ValueError, match="cache_len"):
        vlm.prefill(tp, tt[:, :PROMPT], t_img, cfg, cache_len=PROMPT - 1)
    with torch.no_grad():     # a mesh without a "model" axis: the one-device path
        assert torch.equal(vlm.forward(tp, tt, t_img, cfg, mesh=object())[0], full)


def test_bridge_carries_a_vlm_tree_bit_for_bit():
    cfg = LAYOUTS["ragged"]
    tree = jax.device_get(jax_vlm.init_vlm(jax.random.PRNGKey(0), _jax_cfg(cfg)))
    params = bridge.from_jax_params(tree, device="cpu")
    ref, got = bridge.leaves(tree), bridge.leaves(params)
    assert list(got) == list(ref)
    for path, leaf in ref.items():
        t = got[path]
        assert tuple(t.shape) == leaf.shape, path
        if leaf.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), leaf, err_msg=path)
    del tree["cross"]["gate_mlp"]
    with pytest.raises(KeyError, match="gate_mlp"):
        bridge.from_jax_params(tree, device="cpu")


def test_get_model_round_trip():
    cfg = LAYOUTS["smoke"]
    api = get_model(cfg)
    _, tp = _params(cfg, "float32")
    toks, _, t_img = _inputs(cfg, 8)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        lg, cache = api.prefill(tp, {"tokens": tt[:, :PROMPT], "image_embeds": t_img}, cfg,
                                cache_len=PROMPT + 1)
        want, want_c = vlm.prefill(tp, tt[:, :PROMPT], t_img, cfg, cache_len=PROMPT + 1)
        assert torch.equal(lg, want) and torch.equal(cache["img_k"], want_c["img_k"])
        lg, cache = api.decode_step(tp, {"token": tt[:, PROMPT]}, cache, cfg)
        want, _ = vlm.decode_step(tp, tt[:, PROMPT], want_c, cfg)
        assert torch.equal(lg, want) and cache["pos"] == PROMPT + 1
        ce, _ = api.loss_fn(tp, {"tokens": tt, "labels": tt, "image_embeds": t_img}, cfg)
    assert torch.isfinite(ce)
    (name, shape_fn, dtype), = api.extra_inputs
    assert (name, shape_fn(cfg, 3), dtype) == \
        ("image_embeds", (3, cfg.num_image_tokens, cfg.d_model), torch.bfloat16)
    params = api.init(cfg, generator=torch.Generator().manual_seed(0))
    assert params["embed"].dtype == torch.bfloat16 and "cross" in params
    assert api.init_cache(cfg, 2, 8, device="cpu")["img_k"].shape[0] == 1
