"""The port's RWKV-6 path against the JAX package's, on the CPU.

``ops.rwkv6_scan`` (its plain version on CPU tensors) is held against the
JAX package's Pallas kernel in interpret mode and its jnp oracle on the
same numpy inputs; the model (``forward``, ``prefill``/``decode_step``,
``loss_fn``, ``get_model``) is held against ``repro.models.rwkv6`` with the
reference's own params carried over by ``bridge.from_jax_params``.

Tolerances: the kernel f32 1e-5 and bf16 2e-2 (as ``tests/test_kernels.py``);
the model with f32 params 1e-4 (sums in another order over a 2-layer
smoke model), with bf16 params 5e-2 (as ``tests/test_kernels.py``'s model
case: the two frameworks' bf16 matmuls round about 0.02% of outputs to
the neighbouring value, and the flips spread through the layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_3b as jax_rwkv6_cfg
from repro.data.synthetic import token_batches as jax_token_batches
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import rwkv6 as jax_rwkv6
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke, rwkv6_3b
from repro_torch.configs.dit_moe_xl import config as dit_config
from repro_torch.data.synthetic import token_batches
from repro_torch.kernels import ops
from repro_torch.models import rwkv6
from repro_torch.models.api import get_model

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# the token-shift state is stored in bf16 in both packages; with f32 params
# a 1e-7 difference can round it to the neighbouring bf16 value (2^-8)
BF16_STATE_TOL = {"float32": dict(rtol=2 ** -8, atol=1e-4),
                  "bfloat16": MODEL_TOL["bfloat16"]}
# streamed vs teacher-forced logits, as tests/test_streaming.py holds the
# reference: decode reads the token-shift state back from bf16, teacher
# forcing the previous position in the param dtype
STREAM_TOL = dict(rtol=0.0, atol=5e-2)
PROMPT, DECODE = 16, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------
def _scan_inputs(seed, B, H, T, DK, dtype):
    """numpy inputs as ``tests/test_kernels.py`` draws them, in one dtype
    for both frameworks (s0 stays f32)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, T, DK), np.float32) for _ in range(3)]
    arrays.append(-np.exp(rng.standard_normal((B, H, T, DK), np.float32)))
    arrays.append(np.full((H, DK), 0.5, np.float32))
    s0 = (0.1 * rng.standard_normal((B, H, DK, DK))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jax_in = [jnp.asarray(a).astype(jdt) for a in arrays] + [jnp.asarray(s0)]
    port_in = [torch.from_numpy(a).to(tdt) for a in arrays] + [torch.from_numpy(s0)]
    return jax_in, port_in


@pytest.mark.parametrize("B,H,T,DK", [(1, 2, 32, 16), (2, 4, 64, 32),
                                      (1, 1, 128, 64),
                                      (2, 2, 37, 16)])        # odd T
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_matches_jax(B, H, T, DK, dtype):
    jax_in, port_in = _scan_inputs(5, B, H, T, DK, dtype)
    out, s_T = ops.rwkv6_scan(*port_in)
    assert out.dtype == torch.float32 and s_T.dtype == torch.float32
    assert tuple(out.shape) == (B, H, T, DK) and tuple(s_T.shape) == (B, H, DK, DK)
    for want_out, want_s in (jax_ops.rwkv6_scan(*jax_in, interpret=True),
                             jax_ref.rwkv6_scan_ref(*jax_in)):
        _close(out, want_out, KERNEL_TOL[dtype])
        _close(s_T, want_s, KERNEL_TOL[dtype])


def test_rwkv6_scan_reads_strided_inputs():
    """(B, T, H, DK) tensors permuted to (B, H, T, DK), as the model passes
    them, give what contiguous copies give."""
    _, (r, k, v, logw, u, s0) = _scan_inputs(7, 2, 3, 9, 16, "float32")
    views = [a.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
             for a in (r, k, v, logw)]
    assert not views[0].is_contiguous()
    got = ops.rwkv6_scan(*views, u, s0)
    want = ops.rwkv6_scan(r, k, v, logw, u, s0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rwkv6_scan_state_continuity():
    """Scanning two halves with the carried state == scanning the whole,
    and == the JAX kernel's halves."""
    jax_in, (r, k, v, logw, u, s0) = _scan_inputs(6, 1, 2, 64, 16, "float32")
    full, s_T = ops.rwkv6_scan(r, k, v, logw, u, s0)
    h = 32
    o1, s_mid = ops.rwkv6_scan(r[:, :, :h], k[:, :, :h], v[:, :, :h],
                               logw[:, :, :h], u, s0)
    o2, s_end = ops.rwkv6_scan(r[:, :, h:], k[:, :, h:], v[:, :, h:],
                               logw[:, :, h:], u, s_mid)
    _close(torch.cat([o1, o2], 2), full, KERNEL_TOL["float32"])
    _close(s_end, s_T, KERNEL_TOL["float32"])
    jr, jk, jv, jw, ju, js0 = jax_in
    _, j_mid = jax_ops.rwkv6_scan(jr[:, :, :h], jk[:, :, :h], jv[:, :, :h],
                                  jw[:, :, :h], ju, js0, interpret=True)
    _close(s_mid, j_mid, KERNEL_TOL["float32"])


def test_rwkv6_scan_checks_shapes():
    _, (r, k, v, logw, u, s0) = _scan_inputs(8, 1, 2, 4, 16, "float32")
    with pytest.raises(ValueError):
        ops.rwkv6_scan(r, k[:, :, :3], v, logw, u, s0)
    with pytest.raises(ValueError):
        ops.rwkv6_scan(r, k, v, logw, u[:1], s0)
    with pytest.raises(ValueError):
        ops.rwkv6_scan(r[:, :, :0], k[:, :, :0], v[:, :, :0], logw[:, :, :0],
                       u, s0)


# ---------------------------------------------------------------------------
# configs, data, bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_field_equal_to_jax(which):
    ours = getattr(rwkv6_3b, which)()
    ref = getattr(jax_rwkv6_cfg, which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.attention_free == ref.attention_free is True


def test_config_registry():
    from repro.configs import get_config as jax_get_config
    for name in ("rwkv6-3b", "dit-moe-xl"):
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jax_get_config(name)))
    assert get_smoke("rwkv6-3b") == rwkv6_3b.smoke()
    assert dit_config().param_count() == jax_get_config("dit-moe-xl").param_count()
    assert (dataclasses.asdict(get_config("zamba2-7b"))
            == dataclasses.asdict(jax_get_config("zamba2-7b")))
    with pytest.raises(KeyError, match="unknown config"):
        get_config("rwkv7-3b")


@pytest.mark.parametrize("seed", [0, 7])
def test_token_batches_equal_jax(seed):
    ours = token_batches(512, batch=3, seq_len=20, seed=seed)
    ref = jax_token_batches(512, batch=3, seq_len=20, seed=seed)
    for _ in range(2):
        a, b = next(ours), next(ref)
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int32
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def _jax_params(dtype):
    return jax_rwkv6.init_rwkv6(jax.random.PRNGKey(0), jax_rwkv6_cfg.smoke(),
                                dtype=DTYPES[dtype][0])


def test_bridge_carries_bf16_bit_for_bit():
    tree = jax.device_get(_jax_params("bfloat16"))
    params = bridge.from_jax_params(tree, device="cpu")
    ref = bridge.leaves(tree)
    got = bridge.leaves(params)
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


def test_bridge_refuses_a_wrong_tree():
    tree = jax.device_get(_jax_params("float32"))
    del tree["layers"]["cm_r"]
    with pytest.raises(KeyError, match="cm_r"):
        bridge.from_jax_params(tree, device="cpu")
    tree = jax.device_get(_jax_params("float32"))
    del tree["unembed"]
    with pytest.raises(KeyError, match="unembed"):
        bridge.from_jax_params(tree, device="cpu")


def test_port_init_has_the_reference_tree():
    cfg = rwkv6_3b.smoke()
    ours = bridge.leaves(rwkv6.init_rwkv6(
        cfg, generator=torch.Generator().manual_seed(0)))
    ref = bridge.leaves(jax.device_get(_jax_params("bfloat16")))
    assert list(ours) == list(ref)
    for path, leaf in ref.items():
        assert tuple(ours[path].shape) == leaf.shape, path
        assert str(ours[path].dtype)[6:] == leaf.dtype.name, path


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """(dtype name, JAX params, port params, numpy tokens (2, 24))."""
    jp = _jax_params(request.param)
    tp = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, rwkv6_3b.smoke().vocab_size, (2, PROMPT + DECODE)).astype(np.int32)
    return request.param, jp, tp, toks


_jax_forward = jax.jit(jax_rwkv6.forward, static_argnums=2)
_jax_prefill = jax.jit(jax_rwkv6.prefill, static_argnums=2)
_jax_decode = jax.jit(jax_rwkv6.decode_step, static_argnums=3)


def _close_state(got, want, dtype):
    assert got["S"].dtype == torch.float32
    _close(got["S"], want["S"], MODEL_TOL[dtype])
    for key in ("tm_x", "cm_x"):
        assert got[key].dtype == torch.bfloat16
        _close(got[key], want[key], BF16_STATE_TOL[dtype])
    assert got["pos"] == int(want["pos"])


def test_forward_matches_jax(model):
    dtype, jp, tp, toks = model
    cfg = rwkv6_3b.smoke()
    logits, state = rwkv6.forward(tp, torch.from_numpy(toks), cfg)
    want_logits, want_state = _jax_forward(jp, jnp.asarray(toks), cfg)
    assert logits.dtype == DTYPES[dtype][1]
    assert tuple(logits.shape) == (2, PROMPT + DECODE, cfg.vocab_size)
    _close(logits, want_logits, MODEL_TOL[dtype])
    _close_state(state, want_state, dtype)


def test_prefill_and_decode_match_jax_and_teacher_forcing(model):
    dtype, jp, tp, toks = model
    cfg = rwkv6_3b.smoke()
    tol = MODEL_TOL[dtype]
    tokens = torch.from_numpy(toks)
    teacher, _ = rwkv6.forward(tp, tokens, cfg)
    lg, st = rwkv6.prefill(tp, tokens[:, :PROMPT], cfg)
    jlg, jst = _jax_prefill(jp, jnp.asarray(toks[:, :PROMPT]), cfg)
    _close(lg, jlg, tol)
    _close_state(st, jst, dtype)
    _close(lg, teacher[:, PROMPT - 1], STREAM_TOL)
    for t in range(PROMPT, PROMPT + DECODE):
        lg, st = rwkv6.decode_step(tp, tokens[:, t], st, cfg)
        jlg, jst = _jax_decode(jp, jnp.asarray(toks[:, t]), jst, cfg)
        _close(lg, jlg, tol)
        _close(lg, teacher[:, t], STREAM_TOL)
    _close_state(st, jst, dtype)
    assert st["pos"] == PROMPT + DECODE


def test_loss_fn_matches_jax(model):
    dtype, jp, tp, toks = model
    cfg = rwkv6_3b.smoke()
    labels = np.roll(toks, -1, axis=1)
    ce, metrics = rwkv6.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)}, cfg)
    want, _ = jax_rwkv6.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)}, cfg)
    assert ce.dtype == torch.float32 and metrics["ce"] is ce
    np.testing.assert_allclose(float(ce), float(want), **MODEL_TOL[dtype])


def test_get_model_round_trip(model):
    """The ``ModelApi`` interface gives what the module's functions give."""
    _, _, tp, toks = model
    cfg = rwkv6_3b.smoke()
    api = get_model(cfg)
    tokens = torch.from_numpy(toks)
    cache = api.init_cache(cfg, 2, PROMPT + DECODE, device="cpu")
    assert cache["pos"] == 0 and cache["tm_x"].dtype == torch.bfloat16
    assert torch.equal(cache["S"], rwkv6.init_state(cfg, 2, "cpu")["S"])
    lg, st = api.prefill(tp, {"tokens": tokens[:, :PROMPT]}, cfg)
    want, want_st = rwkv6.prefill(tp, tokens[:, :PROMPT], cfg)
    assert torch.equal(lg, want) and torch.equal(st["S"], want_st["S"])
    lg, st = api.decode_step(tp, {"token": tokens[:, PROMPT]}, st, cfg)
    want, want_st = rwkv6.decode_step(tp, tokens[:, PROMPT], want_st, cfg)
    assert torch.equal(lg, want) and st["pos"] == PROMPT + 1
    ce, _ = api.loss_fn(tp, {"tokens": tokens, "labels": tokens}, cfg)
    assert torch.isfinite(ce)
    params = api.init(cfg, generator=torch.Generator().manual_seed(0))
    assert params["embed"].dtype == torch.bfloat16


def test_get_model_refuses_families_not_ported():
    """Every family is ported now: DiT-MoE's interface is init and the
    rectified-flow loss (no prefill or decode), and only a family the JAX
    package does not have raises, with the reference's ValueError."""
    api = get_model(dit_config())
    assert api.prefill is api.decode_step is api.init_cache is None
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dit_config().replace(family="rwkv7"))


def test_init_state_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rwkv6.init_state(rwkv6_3b.smoke(), 1)
