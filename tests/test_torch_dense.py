"""The port's dense and MoE LM families against the JAX package's, on the CPU.

``repro_torch.models.dense`` (``forward``, ``loss_fn``, ``prefill``,
``decode_step`` with its ring cache) is held against ``repro.models.dense``
for each of the six ``smoke()`` configs, with the reference's own params
(``repro.models.dense.init_lm``) carried over by ``bridge.from_jax_params``
and tokens drawn from a seed with numpy.  Attention runs the flash wrapper's
plain version and the MoE layers ``expert_ffn``'s, as on the CPU they do.
Also held here: the configs field for field, ``layer_windows``, the layers
(``mlp_apply``, ``attn_init``, ``softmax_cross_entropy``'s softcap),
``moe_init``'s tree, the embedding scale's bf16 rounding, the bridge bit for
bit, ``get_model`` and the refusals of what is not ported.

Tolerances: f32 params 1e-4 (sums in another order over a 2-layer model);
bf16 params 5e-2 (``tests/test_torch_rwkv6.py``'s MODEL_TOL: the two
frameworks' bf16 matmuls round about 0.02% of outputs to the neighbouring
value, and the JAX package's jnp expert FFN rounds its hidden to bf16 where
the port's kernel keeps it in f32).
"""
import dataclasses
import importlib
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JaxModelConfig
from repro.core import moe as jax_moe
from repro.models import dense as jax_dense
from repro.models import layers as jax_layers
from repro_torch import bridge
from repro_torch.common.config import ModelConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import moe
from repro_torch.models import dense, layers
from repro_torch.models.api import get_model

torch.set_num_threads(1)

NAMES = ("gemma2-9b", "qwen3-moe-30b-a3b", "qwen3-32b", "stablelm-12b",
         "deepseek-67b", "dbrx-132b")
MODULES = {"gemma2-9b": "gemma2_9b", "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
           "qwen3-32b": "qwen3_32b", "stablelm-12b": "stablelm_12b",
           "deepseek-67b": "deepseek_67b", "dbrx-132b": "dbrx_132b"}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
B, PROMPT, DECODE = 2, 16, 8      # gemma2's smoke window is 8: the prompt passes it


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _leaves_to_torch(tree):
    """A JAX sub-tree (not a whole model's, which the bridge checks) as
    torch CPU tensors, bf16 carried bit for bit."""
    if isinstance(tree, dict):
        return {k: _leaves_to_torch(v) for k, v in tree.items()}
    arr = np.asarray(jax.device_get(tree))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, dtype, seed=0):
    """The reference's params and the port's copy of them."""
    jp = jax_dense.init_lm(jax.random.PRNGKey(seed), _jax_cfg(cfg),
                           dtype=DTYPES[dtype][0])
    return jp, bridge.from_jax_params(jax.device_get(jp), device="cpu")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_configs_field_equal_to_jax(name, which):
    ours = getattr(importlib.import_module(f"repro_torch.configs.{MODULES[name]}"),
                   which)()
    ref = getattr(importlib.import_module(f"repro.configs.{MODULES[name]}"), which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    reg = get_config(name) if which == "config" else get_smoke(name)
    assert reg == ours


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("name", ["gemma2-9b", "qwen3-32b"])
def test_layer_windows_match_jax(name, long_context):
    for cfg in (get_config(name), get_smoke(name)):
        want = jax_dense.layer_windows(_jax_cfg(cfg), long_context=long_context)
        got = dense.layer_windows(cfg, long_context=long_context)
        assert got == [int(w) or None for w in want]


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_smoke_model_matches_jax(name, dtype):
    """forward's logits and lb, loss_fn, prefill's logits and cache, then
    DECODE steps from the prefill cache copied into init_cache (the pattern
    of tests/test_streaming.py), logits and cache each step."""
    cfg = get_smoke(name)
    jcfg = _jax_cfg(cfg)
    jdt, tdt = DTYPES[dtype]
    tol = MODEL_TOL[dtype]
    jp, tp = _params(cfg, dtype)
    toks = _tokens(cfg, 1, (B, PROMPT + DECODE))
    tt = torch.from_numpy(toks)

    want, want_lb = jax.jit(jax_dense.forward, static_argnums=2)(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, got_lb = dense.forward(tp, tt, cfg)
    assert got.dtype == tdt and tuple(got.shape) == (B, PROMPT + DECODE, cfg.vocab_size)
    _close(got, want, tol)
    _close(got_lb, want_lb, tol)

    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want_loss, want_m = jax.jit(jax_dense.loss_fn, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got_loss, got_m = dense.loss_fn(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    _close(got_loss, want_loss, tol)
    _close(got_m["ce"], want_m["ce"], tol)

    want_lg, want_cache = jax.jit(jax_dense.prefill, static_argnums=2)(
        jp, jnp.asarray(toks[:, :PROMPT]), jcfg)
    with torch.no_grad():
        got_lg, got_cache = dense.prefill(tp, tt[:, :PROMPT], cfg)
    _close(got_lg, want_lg, tol)
    _close(got_cache["k"], want_cache["k"], tol)
    _close(got_cache["v"], want_cache["v"], tol)
    assert got_cache["pos"] == int(want_cache["pos"]) == PROMPT

    max_len = PROMPT + DECODE + 4
    jc = jax_dense.init_cache(jcfg, B, max_len, dtype=jdt)
    jc["k"] = jc["k"].at[:, :, :PROMPT].set(want_cache["k"])
    jc["v"] = jc["v"].at[:, :, :PROMPT].set(want_cache["v"])
    jc["pos"] = want_cache["pos"]
    tc = dense.init_cache(cfg, B, max_len, dtype=tdt, device="cpu")
    tc["k"][:, :, :PROMPT] = got_cache["k"]
    tc["v"][:, :, :PROMPT] = got_cache["v"]
    tc["pos"] = got_cache["pos"]
    jdec = jax.jit(jax_dense.decode_step, static_argnums=3)
    for t in range(PROMPT, PROMPT + DECODE):
        want_lg, jc = jdec(jp, jnp.asarray(toks[:, t]), jc, jcfg)
        with torch.no_grad():
            got_lg, tc = dense.decode_step(tp, tt[:, t], tc, cfg)
        _close(got_lg, want_lg, tol)
        assert tc["pos"] == int(jc["pos"]) == t + 1
    _close(tc["k"], jc["k"], tol)
    _close(tc["v"], jc["v"], tol)


def test_ring_cache_decode_matches_jax_step_by_step():
    """tests/test_streaming.py's ring-buffer config with long_context=True:
    a cache of exactly the window's 8 slots, decoded from position 0 past
    it; logits and the ring's contents each step against the reference's
    decode_step, and the streamed logits against the teacher-forced
    forward (0.05, as the reference is held there)."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      d_ff=128, vocab_size=256, num_heads=4, num_kv_heads=4,
                      local_global_pattern=True, sliding_window=8,
                      long_context_window=8)
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg, "float32")
    toks = _tokens(cfg, 2, (1, 20))
    jc = jax_dense.init_cache(jcfg, 1, 8, dtype=jnp.float32)
    tc = dense.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    jdec = jax.jit(partial(jax_dense.decode_step, long_context=True),
                   static_argnums=3)
    outs = []
    for t in range(20):
        want_lg, jc = jdec(jp, jnp.asarray(toks[:, t]), jc, jcfg)
        with torch.no_grad():
            got_lg, tc = dense.decode_step(tp, torch.from_numpy(toks[:, t]), tc,
                                           cfg, long_context=True)
        _close(got_lg, want_lg, MODEL_TOL["float32"])
        _close(tc["k"], jc["k"], MODEL_TOL["float32"])
        outs.append(got_lg)
    with torch.no_grad():
        forced, _ = dense.forward(tp, torch.from_numpy(toks), cfg, long_context=True)
    assert float((torch.stack(outs, 1) - forced).abs().max()) < 0.05


def test_prefill_cache_len_leaves_room_for_decode():
    """prefill(cache_len=) writes the prompt into the first S slots of a
    longer cache and zeros the rest; decode then continues it as it does a
    copy into init_cache."""
    cfg = get_smoke("gemma2-9b")
    _, tp = _params(cfg, "float32")
    toks = torch.from_numpy(_tokens(cfg, 3, (B, PROMPT + 2)))
    with torch.no_grad():
        lg, cache = dense.prefill(tp, toks[:, :PROMPT], cfg)
        lg2, cache2 = dense.prefill(tp, toks[:, :PROMPT], cfg, cache_len=PROMPT + 4)
        assert torch.equal(lg, lg2) and cache2["k"].shape[2] == PROMPT + 4
        assert torch.equal(cache2["k"][:, :, :PROMPT], cache["k"])
        assert not cache2["v"][:, :, PROMPT:].any()
        full, _ = dense.forward(tp, toks, cfg)
        for t in (PROMPT, PROMPT + 1):
            lg2, cache2 = dense.decode_step(tp, toks[:, t], cache2, cfg)
            _close(lg2, full[:, t], MODEL_TOL["float32"])
    with pytest.raises(ValueError, match="cache_len"):
        dense.prefill(tp, toks[:, :PROMPT], cfg, cache_len=PROMPT - 1)


# ---------------------------------------------------------------------------
# layers and params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches_jax(act, dtype):
    jp = jax_layers.mlp_init(jax.random.PRNGKey(1), 32, 48, dtype=DTYPES[dtype][0])
    tp = _leaves_to_torch(jp)
    x = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(DTYPES[dtype][0]), torch.from_numpy(x).to(DTYPES[dtype][1])
    got = layers.mlp_apply(tp, tx, act=act)
    assert got.dtype == tx.dtype
    _close(got, jax_layers.mlp_apply(jp, jx, act=act), MODEL_TOL[dtype])


def _tree_shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in bridge.leaves(tree).items()}


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attn_init_tree_matches_jax(qk_norm):
    got = layers.attn_init(torch.Generator().manual_seed(0), 64, 4, 2, 16,
                           qk_norm=qk_norm)
    want = jax_layers.attn_init(jax.random.PRNGKey(0), 64, 4, 2, 16, qk_norm=qk_norm)
    assert _tree_shapes(got) == _tree_shapes(want)
    # fan-in scale of the (in, out) projections
    assert abs(float(got["wq"].float().std()) - 1 / 8) < 0.02


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_tree_matches_jax(shared, dtype):
    cfg = get_smoke("qwen3-moe-30b-a3b").replace(num_shared_experts=shared)
    got = moe.moe_init(torch.Generator().manual_seed(0), cfg, dtype=DTYPES[dtype][1])
    want = jax_moe.moe_init(jax.random.PRNGKey(0), _jax_cfg(cfg), dtype=DTYPES[dtype][0])
    assert _tree_shapes(got) == _tree_shapes(want)
    assert got["router"].dtype == torch.float32
    assert ("shared_gate" in got) == bool(shared)


def test_moe_forward_takes_bf16_tokens_with_an_f32_router():
    """bf16 x through the f32 router, the expert FFN in bf16: y comes back
    in x's dtype and equals the reference's moe_forward."""
    cfg = get_smoke("qwen3-moe-30b-a3b")
    jp = jax_moe.moe_init(jax.random.PRNGKey(2), _jax_cfg(cfg), dtype=jnp.bfloat16)
    tp = _leaves_to_torch(jp)
    x = np.random.default_rng(5).standard_normal((24, cfg.d_model)).astype(np.float32)
    y, aux = moe.moe_forward(tp, torch.from_numpy(x).bfloat16(), cfg)
    want, want_aux = jax_moe.moe_forward(jp, jnp.asarray(x).astype(jnp.bfloat16),
                                         _jax_cfg(cfg))
    assert y.dtype == torch.bfloat16
    _close(y, want, MODEL_TOL["bfloat16"])
    _close(aux.lb_loss, want_aux.lb_loss, MODEL_TOL["float32"])


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_softmax_cross_entropy_softcap_matches_jax(softcap):
    rng = np.random.default_rng(6)
    logits = (40 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = layers.softmax_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels), softcap=softcap)
    want = jax_layers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            softcap=softcap)
    _close(got, want, dict(rtol=1e-6, atol=1e-6))


def test_embed_scale_rounds_to_bf16_first():
    """gemma2 multiplies the embedding by sqrt(d_model) cast to its dtype:
    in bf16 the product with the rounded scale equals the reference's bit
    for bit; with the exact scale many products round the other way."""
    cfg = get_config("gemma2-9b")
    emb = np.random.default_rng(7).standard_normal((4096, 8)).astype(np.float32)
    toks = np.arange(4096, dtype=np.int32)[None]
    jparams = {"embed": jnp.asarray(emb).astype(jnp.bfloat16)}
    tparams = _leaves_to_torch(jparams)
    want = np.asarray(jax_dense._embed(jparams, jnp.asarray(toks), _jax_cfg(cfg)))
    got = dense._embed(tparams, torch.from_numpy(toks), cfg)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    exact = (tparams["embed"][toks] * math.sqrt(cfg.d_model)).view(torch.int16).numpy()
    assert (exact != want.view(np.int16)).mean() > 0.1


# ---------------------------------------------------------------------------
# bridge, get_model, refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gemma2-9b", "qwen3-moe-30b-a3b"])
def test_bridge_carries_an_lm_tree_bit_for_bit(name):
    cfg = get_smoke(name)
    tree = jax.device_get(jax_dense.init_lm(jax.random.PRNGKey(0), _jax_cfg(cfg)))
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
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), leaf, err_msg=path)
    assert ("ln1_post" in params["layers"]) == cfg.post_norm


def test_bridge_refuses_a_broken_lm_tree():
    tree = jax.device_get(jax_dense.init_lm(jax.random.PRNGKey(0),
                                            _jax_cfg(get_smoke("qwen3-32b"))))
    del tree["layers"]["attn"]["wo"]
    with pytest.raises(KeyError, match="wo"):
        bridge.from_jax_params(tree, device="cpu")
    tree = jax.device_get(jax_dense.init_lm(jax.random.PRNGKey(0),
                                            _jax_cfg(get_smoke("qwen3-32b"))))
    del tree["layers"]["mlp"]
    with pytest.raises(KeyError, match="mlp"):
        bridge.from_jax_params(tree, device="cpu")


@pytest.mark.parametrize("name", ["gemma2-9b", "qwen3-moe-30b-a3b"])
def test_get_model_round_trip(name):
    cfg = get_smoke(name)
    api = get_model(cfg)
    _, tp = _params(cfg, "float32")
    tt = torch.from_numpy(_tokens(cfg, 8, (B, PROMPT + 1)))
    with torch.no_grad():
        lg, cache = api.prefill(tp, {"tokens": tt[:, :PROMPT]}, cfg, cache_len=PROMPT + 1)
        want, want_cache = dense.prefill(tp, tt[:, :PROMPT], cfg, cache_len=PROMPT + 1)
        assert torch.equal(lg, want) and torch.equal(cache["k"], want_cache["k"])
        lg, cache = api.decode_step(tp, {"token": tt[:, PROMPT]}, cache, cfg)
        want, want_cache = dense.decode_step(tp, tt[:, PROMPT], want_cache, cfg)
        assert torch.equal(lg, want) and cache["pos"] == PROMPT + 1
        ce, _ = api.loss_fn(tp, {"tokens": tt, "labels": tt}, cfg)
    assert torch.isfinite(ce)
    params = api.init(cfg, generator=torch.Generator().manual_seed(0))
    assert params["embed"].dtype == torch.bfloat16
    assert ("moe" in params["layers"]) == cfg.is_moe
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].shape == (cfg.num_layers, 2, 8, cfg.num_kv_heads, cfg.head_dim)


def test_get_model_and_get_config_refuse_unknown_names():
    """Every family of the JAX package has a model interface now: only an
    unknown family raises, as the reference's ValueError; only an unknown
    config name raises KeyError."""
    cfg = ModelConfig(name="z", family="nope", num_layers=2, d_model=64,
                      d_ff=128, vocab_size=256, num_heads=4, num_kv_heads=4)
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg)
    with pytest.raises(KeyError, match="unknown config"):
        get_config("zamba3-7b")
    with pytest.raises(KeyError, match="unknown config"):
        get_smoke("zamba3-7b")


def _first_moe(p):
    return {k: v[0] for k, v in p["layers"]["moe"].items()}


@pytest.mark.parametrize("call", [
    lambda p, t, c, **kw: dense.forward(p, t, c, **kw),
    lambda p, t, c, **kw: dense.forward(p, t, c, seq_shard=True, **kw),
    lambda p, t, c, **kw: dense.forward(p, t, c, attn_shard="heads", **kw),
    lambda p, t, c, **kw: dense.prefill(p, t, c, **kw),
    lambda p, t, c, **kw: dense._moe_block(
        _first_moe(p), torch.linspace(-1, 1, 2 * c.d_model).view(1, 2, c.d_model), c,
        kw.get("mesh")),
], ids=["forward", "seq_shard", "attn_shard", "prefill", "moe_block"])
def test_mesh_options_raise_and_name_roadmap(call):
    """A ``mesh`` is ported (the training mesh,
    ``tests/test_torch_train_mesh.py``): one without a ``model`` axis runs the
    one-device path, as the reference's ``_moe_block`` does, and gives the
    mesh-less numbers bit for bit; so do ``seq_shard`` and ``attn_shard``,
    the reference dry run's layout hints, which change nothing without a
    ``model`` axis (tensor parallelism over one: ``tests/test_torch_tp.py``).
    (The name is kept from when every mesh option raised.)"""
    cfg = get_smoke("qwen3-moe-30b-a3b")
    _, tp = _params(cfg, "float32")
    tokens = torch.arange(4, dtype=torch.int32)[None]
    got, want = call(tp, tokens, cfg, mesh=object()), call(tp, tokens, cfg)
    flat = [x for out in (got, want) for x in out]
    flat = [v for x in flat for v in (x.values() if isinstance(x, dict) else [x])]
    n = len(flat) // 2
    assert all(a == b if isinstance(a, int) else torch.equal(a, b)
               for a, b in zip(flat[:n], flat[n:]))


def test_backward_through_the_lm_raises():
    """The backward through the LM (causal GQA flash, each layer
    recomputed) runs: the attention projections' gradients equal
    ``jax.grad`` of the reference's ``loss_fn`` to 1e-4 of their largest
    value (f32).  (The name is kept from when the causal backward was not
    ported; gemma2's window and softcap still raise, in
    ``tests/test_torch_lm_train.py``.)"""
    cfg = get_smoke("qwen3-32b")
    jp, tp = _params(cfg, "float32")
    toks = _tokens(cfg, 9, (1, 8))
    tt = torch.from_numpy(toks)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jg = jax.grad(lambda p: jax_dense.loss_fn(p, jb, _jax_cfg(cfg))[0])(jp)
    attn = tp["layers"]["attn"]
    for w in ("wq", "wk", "wv"):
        attn[w].requires_grad_()
    loss, _ = dense.loss_fn(tp, {"tokens": tt, "labels": tt}, cfg)
    loss.backward()
    for w in ("wq", "wk", "wv"):
        want = np.asarray(jg["layers"]["attn"][w])
        got = attn[w].grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), w
