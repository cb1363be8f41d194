"""The remat policies ``"dots"`` and ``"save_ffn"`` of the dense and MoE
families (``models/dense.py``, ``models/layers.remat``), against the
reference's ``forward(remat_policy=...)`` and the port's ``"full"``.

* gradients of ``loss_fn`` under each policy against ``jax.grad`` of the
  reference's under the same policy, to ``GRAD_TOL`` (f32, the reference's
  params through ``bridge.from_jax_params``), and bit for bit against the
  port's ``"full"``;
* ``"dots"`` keeps the outputs of the 2-D weight products: its step counts
  (``FlopCounterMode``) ``"full"``'s less the layers' forward products;
* over a (data 1, model 2) mesh of two gloo ranks, ``"save_ffn"`` keeps the
  MoE exchange's received buffers: each MoE layer issues 4 all-to-alls in
  a step (the forward's two and their transposes) where ``"full"`` and
  ``"dots"`` issue 6 (the recompute's two more), with the same gradients;
* ``check_remat_policy`` and ``lm_train_step``'s keyword.

Time: about 30 s (one spawn of 2 ranks).
"""
import jax
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils.flop_counter import FlopCounterMode

import torch_remat_jobs as jobs
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import lm_grads, loss_kwargs
from repro_torch.models import dense
from repro_torch.models.api import get_model
from test_torch_lm_train import GRAD_TOL, _batches, _jax_params, _np, _port_grads, _smoke

torch.set_num_threads(1)

NAMES = ("qwen3-moe-30b-a3b", "qwen3-32b")
POLICIES = ("dots", "save_ffn")


@pytest.fixture(scope="module")
def grads():
    """Per config: the reference's loss and gradients under each policy,
    and the port's under "full" and each policy."""
    out = {}
    for name in NAMES:
        jcfg, cfg = _smoke(name)
        jp = _jax_params(name, "float32")
        (jb, tb), = _batches(name, 1)
        params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
        runs = {"port": {}, "ref": {}}
        for policy in ("full",) + POLICIES:
            runs["port"][policy] = _port_grads(params, tb, cfg, remat_policy=policy)
        for policy in POLICIES:
            runs["ref"][policy] = jax.value_and_grad(lambda p: jax_get_model(jcfg).loss_fn(
                p, jb, jcfg, remat_policy=policy)[0])(jp)
        out[name] = runs
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", NAMES)
def test_policy_gradients_match_the_reference_and_equal_full(grads, name, policy):
    loss, got = grads[name]["port"][policy]
    full_loss, full = grads[name]["port"]["full"]
    assert torch.equal(loss, full_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, full))
    jloss, jg = grads[name]["ref"][policy]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    rel, floor = GRAD_TOL["float32"]
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(leaves) == len(got)
    for want, g in zip(leaves, got):
        want = _np(want)
        assert np.abs(_np(g) - want).max() <= rel * np.abs(want).max() + floor


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["qwen3-32b", "qwen3-moe-30b-a3b"])
def test_dots_saves_the_forward_2d_products(name):
    """"full" recomputes the layers' 2-D weight products in the backward,
    "dots" reads them back: the difference of the two steps' FLOPs is the
    forward's products inside the layers (the unembedding is not
    recomputed either way).  The recompute runs whole layers here
    (``set_checkpoint_early_stop(False)``): by default it stops after the
    last op whose output the backward needs, so "full" skips a layer's
    last product (the MLP's down projection) too."""
    cfg = get_smoke(name).replace(dtype="float32")
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0),
                                 dtype=torch.float32)
    (_, tb), = _batches(name, 1)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        full = _flops(lambda: _port_grads(params, tb, cfg, remat_policy="full"))
        dots = _flops(lambda: _port_grads(params, tb, cfg, remat_policy="dots"))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        dense.forward_hidden(params, tb["tokens"], cfg)
    products = sum(n for op, n in fc.get_flop_counts()["Global"].items()
                   if str(op) in ("aten.mm", "aten.addmm"))
    assert products > 0 and full - dots == products


def test_save_ffn_issues_four_all_to_alls_per_moe_layer_over_model_2():
    cfg = get_smoke("qwen3-moe-30b-a3b")
    res, _ = mesh_lib.spawn(jobs.policy_a2a_job, 2, backend="gloo", device="cpu",
                            data=1, model=2, timeout_s=120,
                            args=("qwen3-moe-30b-a3b", ("full", "dots", "save_ffn"), 2, 16))
    L = cfg.num_layers
    assert res["full"]["counts"]["all_to_all"] == 6 * L
    assert res["dots"]["counts"]["all_to_all"] == 6 * L
    assert res["save_ffn"]["counts"]["all_to_all"] == 4 * L
    # the other collectives as under "full": a selective checkpoint's own
    # dispatch mode shows each op twice in the profile, counted once
    rest = {k: v for k, v in res["full"]["counts"].items() if k != "all_to_all"}
    for policy in ("dots", "save_ffn"):
        assert {k: v for k, v in res[policy]["counts"].items() if k != "all_to_all"} == rest
        assert rest["all_reduce"] and rest["all_gather"]
        assert torch.equal(res[policy]["loss"], res["full"]["loss"])
        assert all(torch.equal(a, b) for a, b in
                   zip(res[policy]["grads"], res["full"]["grads"]))


def test_check_remat_policy_and_the_train_step_keyword():
    for policy in dense.REMAT_POLICIES:
        dense.check_remat_policy(policy)
    with pytest.raises(ValueError, match="remat_policy"):
        dense.check_remat_policy("offload")
    assert loss_kwargs(get_smoke("qwen3-32b"), remat_policy="dots") == \
        {"remat_policy": "dots"}
    assert loss_kwargs(get_smoke("rwkv6-3b")) == {}
    with pytest.raises(ValueError, match="dense and moe"):
        loss_kwargs(get_smoke("rwkv6-3b"), remat_policy="save_ffn")
    cfg = get_smoke("qwen3-32b")
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0))
    (_, tb), = _batches("qwen3-32b", 1)
    want = lm_grads(params, tb, cfg)
    got = lm_grads(params, tb, cfg, remat_policy="save_ffn")
    assert torch.equal(got[0], want[0])
