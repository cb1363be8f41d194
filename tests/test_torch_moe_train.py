"""The port's training of the MoE family (qwen3-moe-30b-a3b, dbrx-132b)
against the JAX package, on the CPU.

The experts' backward plain version (``kernels/ref.expert_ffn_bwd_ref``,
what ``csrc/expert_ffn_bwd.cu`` computes) is held against ``jax.vjp`` of
the reference's ``core.moe.expert_ffn`` (its jnp einsums, ``use_pallas``
off), in f32 and bf16.  Then, at the two smoke configs with the
reference's params carried over by ``bridge.from_jax_params`` and tokens
from ``token_batches``: the step-0 gradients of ``loss_fn`` (cross-entropy
plus 0.01 x the load-balance loss) against ``jax.grad`` of the
reference's, leaf by leaf (the router's through the top-k scores that
weight the combine and through the load-balance probabilities);
``lm_train_step`` against the reference's jitted step; and the recompute
(``remat``) against none, bit for bit, with the same dispatch plan built
again in the backward.

The bf16 rounding point.  The reference's bf16 einsums round G, U, H and
Y to bf16, and its autodiff rounds dH, dG, dU and each of dX's two terms;
the plain version and the kernel keep G, U, H, dG and dU in f32 and round
each gradient once.  Measured here: every step-0 leaf of both smoke
configs meets ``GRAD_TOL``'s bf16 bound with that (the worst, qwen3-moe's
``experts_gate``, at 0.36 of it), so nothing rounds earlier.

Tolerances: the expert backward against ``jax.vjp`` in f32 within ``1e-5 *
max|want|`` (f32 sums in another order); in bf16 within ``2^-6 *
max|want|``, two bf16 ulps of the largest element (the reference's
intermediate roundings, one ulp of an element each, against one rounding
at the end); step-0 gradients by ``GRAD_TOL``, losses by ``LOSS_RTOL``
(``tests/test_torch_lm_train.py``, with its reasons).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moe as jax_moe
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.checkpoint.io import flatten
from repro_torch.core import moe as moe_lib
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import lm_train_step
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from test_torch_lm_train import (GRAD_TOL, LOSS_RTOL, TRAIN_STEPS, _batches, _jax_params,
                                 _jax_train_losses, _np, _port_grads, _smoke, _to_torch)

torch.set_num_threads(1)

NAMES = ("qwen3-moe-30b-a3b", "dbrx-132b")
FFN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


# ---------------------------------------------------------------------------
# (1) the experts' plain backward against jax.vjp of core.moe.expert_ffn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,d,f", [(4, 18, 128, 64), (3, 40, 64, 96)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_backward_matches_jax_vjp_of_expert_ffn(E, C, d, f, act, dtype):
    rng = np.random.default_rng(E * C)
    arrays = [rng.standard_normal((E, C, d)), rng.standard_normal((E, d, f)) / np.sqrt(d),
              rng.standard_normal((E, d, f)) / np.sqrt(d),
              rng.standard_normal((E, f, d)) / np.sqrt(f), rng.standard_normal((E, C, d))]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jin = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrays]

    def fn(buf, wg, wu, wd):
        p = {"experts_gate": wg, "experts_up": wu, "experts_down": wd}
        return jax_moe.expert_ffn(p, buf, act=act, use_pallas=False)

    _, vjp = jax.vjp(fn, *jin[:4])
    want = vjp(jin[4])
    tin = [_to_torch(a) for a in jin]
    got = ref.expert_ffn_bwd_ref(*tin, act=act)
    for name, g, w, x in zip(("dX", "dWg", "dWu", "dWd"), got, want, tin):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= FFN_TOL[dtype] * np.abs(w).max(), \
            (name, np.abs(g - w).max() / np.abs(w).max())
    # through the autograd Function: the plain backward's gradients bit for bit
    live = [t.clone().requires_grad_() for t in tin[:4]]
    y = ops.expert_ffn(*live, act=act)
    for g, w in zip(torch.autograd.grad(y, live, tin[4]), got):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# (2) step-0 gradients of loss_fn against jax.grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_step0_gradients_match_jax_grad(name, dtype):
    jcfg, cfg = _smoke(name)
    assert cfg.family == "moe"
    jp = _jax_params(name, dtype)
    (jb, tb), = _batches(name, 1)
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: jax_get_model(jcfg).loss_fn(p, jb, jcfg), has_aux=True)(jp)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = get_model(cfg).loss_fn(live, tb, cfg)
    grads = torch.autograd.grad(loss, adamw.tree_leaves(live))
    loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    rtol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(aux["lb"]), float(jaux["lb"]), rtol=rtol)
    assert float(aux["lb"]) > 0
    rel, floor = GRAD_TOL[dtype]
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = [p for p, _ in flatten(params)[0]]
    assert len(jleaves) == len(grads) == len(paths)
    assert any("router" in str(p) for p in paths)
    for (_, want), got, path, p in zip(jleaves, grads, paths, adamw.tree_leaves(params)):
        assert got.dtype == p.dtype and got.shape == p.shape, path
        want = _np(want)
        bound = rel * np.abs(want).max() + floor
        assert np.abs(_np(got) - want).max() <= bound, (path, np.abs(_np(got) - want).max(),
                                                         bound)
        if "router" in str(path):
            assert np.abs(want).max() > 0, path      # the router does get a gradient


# ---------------------------------------------------------------------------
# (3) lm_train_step against the reference's jitted step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_train_step_losses_match_the_reference_step(name, dtype):
    jcfg, cfg = _smoke(name)
    jp = _jax_params(name, dtype)
    data = _batches(name, TRAIN_STEPS, seed=3)
    want = _jax_train_losses(jcfg, jp, [jb for jb, _ in data], TRAIN_STEPS)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    opt = adamw.adamw_init(params)
    losses = []
    for _, tb in data:
        params, opt, m = lm_train_step(params, opt, tb, cfg, total=TRAIN_STEPS)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL[dtype], atol=0)


# ---------------------------------------------------------------------------
# (4) the recompute rebuilds the same dispatch plan and changes no bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_remat_gives_the_same_gradients_bit_for_bit(name, monkeypatch):
    """``remat=True`` (the default) and ``remat=False`` give the same loss
    and gradients bit for bit, bf16; with it every layer routes its tokens
    again in the backward, to the same plan (the same expert of every
    (token, slot) pair), and runs the experts' forward again."""
    _, cfg = _smoke(name)
    params = bridge.from_jax_params(jax.device_get(_jax_params(name, "bfloat16")),
                                    device="cpu")
    (_, tb), = _batches(name, 1, seed=5)
    plans, ffn_calls = [], []
    make_plan, ffn_fwd = moe_lib.make_plan, ops._expert_ffn_fwd
    monkeypatch.setattr(moe_lib, "make_plan", lambda idx, *a, **kw: plans.append(
        idx.clone()) or make_plan(idx, *a, **kw))
    monkeypatch.setattr(ops, "_expert_ffn_fwd",
                        lambda *a, **kw: ffn_calls.append(1) or ffn_fwd(*a, **kw))
    runs = {}
    for remat in (True, False):
        plans.clear()
        ffn_calls.clear()
        runs[remat] = _port_grads(params, tb, cfg, remat=remat), list(plans), len(ffn_calls)
    (loss_r, grads_r), plans_r, n_r = runs[True]
    (loss_p, grads_p), plans_p, n_p = runs[False]
    assert torch.equal(loss_r, loss_p)
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads_p))
    L = cfg.num_layers
    assert n_p == len(plans_p) == L and n_r == len(plans_r) == 2 * L
    # the forward's plans, then each layer's again in the backward (last first)
    assert all(torch.equal(a, b) for a, b in zip(plans_r[:L], plans_p))
    assert all(torch.equal(a, b) for a, b in zip(plans_r[L:], plans_p[::-1]))
