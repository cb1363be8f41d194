"""The port's encoder-decoder (audio family, SeamlessM4T) against the JAX
package's, on the CPU.

``repro_torch.models.encdec`` (``encode``, ``_memory_kv``, ``forward``,
``loss_fn``, ``prefill``, ``decode_step``) is held against
``repro.models.encdec`` with the reference's own params (``init_encdec``)
carried over by ``bridge.from_jax_params``, tokens and bf16 stub audio
frames drawn from a seed with numpy.  Two configs: ``smoke()`` and an
uneven one (3 encoder layers over a 2-layer decoder, 20 frames: off the
flash kernel's 16-key tile).  Attention runs the flash wrapper's plain
version, as on the CPU it does.

The reference's ``prefill`` returns a self cache exactly the prompt's S
slots long; the decode tests pad it by DECODE zero slots, as
``tests/test_streaming.py`` does, and one test decodes past an unpadded
cache, where the ring wraps and drops the oldest token in both.

Tolerances: f32 params 1e-4, bf16 params 5e-2 (``tests/test_torch_dense.py``'s
MODEL_TOL); no bf16 rounding point sits on an f32 model's path here (the
caches are in the params' dtype).
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
from repro.models import encdec as jax_encdec
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import encdec
from repro_torch.models.api import get_model

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
B, PROMPT, DECODE = 2, 16, 8
NAME = "seamless-m4t-large-v2"
CONFIGS = {"smoke": get_smoke(NAME),
           "uneven": get_smoke(NAME).replace(name="seamless-smoke-uneven",
                                             encoder_layers=3, num_audio_frames=20)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, dtype, seed=0):
    jp = jax_encdec.init_encdec(jax.random.PRNGKey(seed), _jax_cfg(cfg),
                                dtype=DTYPES[dtype][0])
    return jp, bridge.from_jax_params(jax.device_get(jp), device="cpu")


def _inputs(cfg, seed):
    """Tokens (B, PROMPT + DECODE) int32 and audio frames (B, Tf, d) bf16,
    for each framework."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT + DECODE), dtype=np.int32)
    frames = jnp.asarray(rng.standard_normal((B, cfg.num_audio_frames, cfg.d_model)),
                         jnp.bfloat16)
    t_frames = torch.from_numpy(np.asarray(frames).view(np.int16).copy()).view(torch.bfloat16)
    return toks, frames, t_frames


def _jax_pad(cache, n):
    """The reference's self cache padded by ``n`` zero slots, as
    tests/test_streaming.py pads it."""
    pad = ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))
    return dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_field_equal_to_jax(which):
    mod = "seamless_m4t_large_v2"
    ours = getattr(importlib.import_module(f"repro_torch.configs.{mod}"), which)()
    ref = getattr(importlib.import_module(f"repro.configs.{mod}"), which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert (get_config(NAME) if which == "config" else get_smoke(NAME)) == ours


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_jax(dtype):
    cfg = CONFIGS["uneven"]
    got = encdec.init_encdec(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=DTYPES[dtype][1])
    want = jax_encdec.init_encdec(jax.random.PRNGKey(0), _jax_cfg(cfg),
                                  dtype=DTYPES[dtype][0])
    shapes = lambda t: {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))  # noqa: E731
                        for k, v in bridge.leaves(t).items()}
    assert shapes(got) == shapes(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_model_matches_jax(which, dtype):
    """encode's memory, the memory K/V, forward's logits, loss_fn,
    prefill's logits and cache (k, v, mem_k, mem_v) leaf by leaf, then
    DECODE steps from the padded cache: logits each step, the cache after."""
    cfg = CONFIGS[which]
    jcfg = _jax_cfg(cfg)
    tol = MODEL_TOL[dtype]
    jp, tp = _params(cfg, dtype)
    toks, frames, t_frames = _inputs(cfg, 1)
    tt = torch.from_numpy(toks)

    want_mem = jax.jit(jax_encdec.encode, static_argnums=2)(jp, frames, jcfg)
    with torch.no_grad():
        mem = encdec.encode(tp, t_frames, cfg)
        mk, mv = encdec._memory_kv(tp, mem, cfg)
    assert mem.dtype == DTYPES[dtype][1]
    _close(mem, want_mem, tol, "memory")
    want_mk, want_mv = jax.jit(jax_encdec._memory_kv, static_argnums=2)(jp, want_mem, jcfg)
    _close(mk, want_mk, tol, "mem_k")
    _close(mv, want_mv, tol, "mem_v")

    want, _ = jax.jit(jax_encdec.forward, static_argnums=3)(jp, jnp.asarray(toks), frames, jcfg)
    with torch.no_grad():
        got, aux = encdec.forward(tp, tt, t_frames, cfg)
    assert tuple(got.shape) == (B, PROMPT + DECODE, cfg.vocab_size) and float(aux) == 0
    _close(got, want, tol, "forward logits")

    labels = np.roll(toks, -1, axis=1)
    want_loss, _ = jax.jit(jax_encdec.loss_fn, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "audio_frames": frames}, jcfg)
    with torch.no_grad():
        got_loss, _ = encdec.loss_fn(tp, {"tokens": tt, "labels": torch.from_numpy(labels),
                                          "audio_frames": t_frames}, cfg)
    _close(got_loss, want_loss, tol, "loss")

    want_lg, jc = jax.jit(jax_encdec.prefill, static_argnums=3)(
        jp, jnp.asarray(toks[:, :PROMPT]), frames, jcfg)
    with torch.no_grad():
        got_lg, tc = encdec.prefill(tp, tt[:, :PROMPT], t_frames, cfg)
    _close(got_lg, want_lg, tol, "prefill logits")
    for k in ("k", "v", "mem_k", "mem_v"):
        _close(tc[k], jc[k], tol, f"prefill cache {k}")
    assert tc["k"].shape[2] == PROMPT and tc["pos"] == int(jc["pos"]) == PROMPT

    jc, tc = _jax_pad(jc, DECODE), encdec.pad_cache(tc, DECODE)
    assert tc["k"].shape[2] == PROMPT + DECODE and not tc["v"][:, :, PROMPT:].any()
    jdec = jax.jit(jax_encdec.decode_step, static_argnums=3)
    for t in range(PROMPT, PROMPT + DECODE):
        want_lg, jc = jdec(jp, jnp.asarray(toks[:, t]), jc, jcfg)
        with torch.no_grad():
            got_lg, tc = encdec.decode_step(tp, tt[:, t], tc, cfg)
        _close(got_lg, want_lg, tol, f"decode {t} logits")
        assert tc["pos"] == int(jc["pos"]) == t + 1
    for k in ("k", "v"):
        _close(tc[k], jc[k], tol, f"decoded cache {k}")


@pytest.mark.parametrize("window", [None, 5])
def test_decode_past_an_unpadded_cache_wraps_like_jax(window):
    """prefill's cache holds exactly the prompt: a step past it overwrites
    the oldest slot in both frameworks (with and without a window)."""
    cfg = CONFIGS["smoke"]
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg, "float32", seed=1)
    toks, frames, t_frames = _inputs(cfg, 2)
    _, jc = jax.jit(jax_encdec.prefill, static_argnums=3)(
        jp, jnp.asarray(toks[:, :PROMPT]), frames, jcfg)
    with torch.no_grad():
        _, tc = encdec.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), t_frames, cfg)
    jdec = jax.jit(partial(jax_encdec.decode_step, cfg=jcfg, window=window))
    for t in range(PROMPT, PROMPT + 4):
        want_lg, jc = jdec(jp, jnp.asarray(toks[:, t]), jc)
        with torch.no_grad():
            got_lg, tc = encdec.decode_step(tp, torch.from_numpy(toks[:, t]), tc, cfg,
                                            window=window)
        _close(got_lg, want_lg, MODEL_TOL["float32"], f"step {t}")
    _close(tc["k"], jc["k"], MODEL_TOL["float32"])
    assert tc["k"].shape[2] == PROMPT


def test_bridge_carries_an_encdec_tree_bit_for_bit():
    cfg = CONFIGS["uneven"]
    tree = jax.device_get(jax_encdec.init_encdec(jax.random.PRNGKey(0), _jax_cfg(cfg)))
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
    del tree["dec_layers"]["xattn"]["wv"]
    with pytest.raises(KeyError, match="wv"):
        bridge.from_jax_params(tree, device="cpu")


def test_get_model_round_trip():
    cfg = CONFIGS["smoke"]
    api = get_model(cfg)
    _, tp = _params(cfg, "float32")
    toks, _, t_frames = _inputs(cfg, 8)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        lg, cache = api.prefill(tp, {"tokens": tt[:, :PROMPT], "audio_frames": t_frames}, cfg)
        want, want_c = encdec.prefill(tp, tt[:, :PROMPT], t_frames, cfg)
        assert torch.equal(lg, want) and torch.equal(cache["mem_k"], want_c["mem_k"])
        lg, cache = api.decode_step(tp, {"token": tt[:, PROMPT]}, cache, cfg, attn_window=4)
        want, _ = encdec.decode_step(tp, tt[:, PROMPT], want_c, cfg, window=4)
        assert torch.equal(lg, want) and cache["pos"] == PROMPT + 1
        ce, _ = api.loss_fn(tp, {"tokens": tt, "labels": tt, "audio_frames": t_frames}, cfg)
    assert torch.isfinite(ce)
    assert api.init_cache is None
    (name, shape_fn, dtype), = api.extra_inputs
    assert (name, shape_fn(cfg, 3), dtype) == \
        ("audio_frames", (3, cfg.num_audio_frames, cfg.d_model), torch.bfloat16)
    params = api.init(cfg, generator=torch.Generator().manual_seed(0))
    assert params["embed"].dtype == torch.bfloat16
    assert params["enc_layers"]["attn"]["wq"].shape[0] == cfg.encoder_layers
