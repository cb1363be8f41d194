"""The port's schedule planning against the JAX package's, field by field.

``compile_step_plans`` is pure Python in both packages, so the plans must
agree exactly: every LayerAction field, the variant bucketing, the planned
dispatch capacity and bytes, for all five schedules, step counts {1, 4, 10}
and codec {none, int8_residual}.  The pure-Python helpers the planner
rests on (selective sync masks, conditional-communication arithmetic,
model configs) are held to the reference too.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_xl as jax_configs
from repro.core import conditional as jax_cond
from repro.core import plan as jax_plan
from repro.core import selective as jax_selective
from repro.core.schedules import DiceConfig as JaxDice
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import conditional, plan as plan_lib, selective
from repro_torch.core.moe import default_capacity
from repro_torch.core.placement import Placement
from repro_torch.core.schedules import DiceConfig

SCHEDULES = ("sync", "displaced", "interweaved", "dice", "staggered_batch")
CODEC_SCHEDULES = ("displaced", "interweaved", "dice")


def _dcfgs(name, codec):
    """The same schedule config in both packages."""
    if name == "sync":
        return DiceConfig.sync_ep(), JaxDice.sync_ep()
    if name == "staggered_batch":
        return DiceConfig.staggered_batch(), JaxDice.staggered_batch()
    if codec == "none" or name not in CODEC_SCHEDULES:
        return getattr(DiceConfig, name)(), getattr(JaxDice, name)()
    return (getattr(DiceConfig, name)(compress=CompressConfig(codec)),
            getattr(JaxDice, name)(compress=JaxCompress(codec)))


def _action_fields(a):
    out = {}
    for f in dataclasses.fields(a):
        v = getattr(a, f.name)
        if f.name == "codec" and v is not None:
            v = v.kind
        out[f.name] = v
    return out


def _assert_plans_equal(mine, ref):
    assert mine.num_steps == ref.num_steps
    assert mine.num_variants == ref.num_variants
    assert mine.variant_of_step == ref.variant_of_step
    for pm, pr in zip(mine.steps, ref.steps):
        assert (pm.schedule, pm.is_warmup) == (pr.schedule, pr.is_warmup)
        assert pm.num_layers == pr.num_layers
        for am, ar in zip(pm.actions, pr.actions):
            assert _action_fields(am) == _action_fields(ar)
            assert (am.staleness, am.num_buffers) == (ar.staleness, ar.num_buffers)
        assert (pm.step_staleness, pm.num_buffers, pm.num_sync_layers) == \
            (pr.step_staleness, pr.num_buffers, pr.num_sync_layers)


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("num_steps", [1, 4, 10])
@pytest.mark.parametrize("codec", ["none", "int8_residual"])
def test_compile_step_plans_field_equal(name, num_steps, codec):
    mine_cfg, ref_cfg = _dcfgs(name, codec)
    cfg, jcfg = configs.config(), jax_configs.config()
    mine = plan_lib.compile_step_plans(mine_cfg, cfg.num_layers, num_steps,
                                       experts_per_token=cfg.experts_per_token)
    ref = jax_plan.compile_step_plans(ref_cfg, jcfg.num_layers, num_steps,
                                      experts_per_token=jcfg.experts_per_token)
    _assert_plans_equal(mine, ref)
    tokens = 8 * cfg.patch_tokens            # 8 requests of 256 tokens
    for pm, pr in zip(mine.variants, ref.variants):
        for am, ar in zip(pm.actions, pr.actions):
            assert am.dispatch_capacity(tokens, cfg) == \
                ar.dispatch_capacity(tokens, jcfg)
            assert am.dispatch_bytes(tokens, cfg) == ar.dispatch_bytes(tokens, jcfg)
            assert am.raw_dispatch_bytes(tokens, cfg) == \
                ar.raw_dispatch_bytes(tokens, jcfg)


def test_dice_xl_capacities_and_variants():
    """DICE at XL and 8 requests: 3 variants (warm-up, refresh, light);
    refresh steps give every expert 640 slots, light steps 320."""
    cfg = configs.config()
    splan = plan_lib.compile_step_plans(
        DiceConfig.dice(compress=CompressConfig("int8_residual")),
        cfg.num_layers, 10, experts_per_token=cfg.experts_per_token)
    assert splan.num_variants == 3
    tokens = 8 * cfg.patch_tokens
    async_caps = {s: {a.dispatch_capacity(tokens, cfg)
                      for a in splan.steps[s].actions if a.mode != "sync"}
                  for s in range(2, 10)}
    assert all(async_caps[s] == {640} for s in (2, 4, 6, 8))
    assert all(async_caps[s] == {320} for s in (3, 5, 7, 9))
    assert default_capacity(tokens, cfg) == 640


@pytest.mark.parametrize("policy", ["none", "deep", "shallow", "staggered", "all"])
@pytest.mark.parametrize("num_layers", [1, 2, 7, 28])
@pytest.mark.parametrize("fraction", [0.25, 0.5, 0.9])
def test_sync_layer_mask_matches_jax(policy, num_layers, fraction):
    np.testing.assert_array_equal(
        selective.sync_layer_mask(policy, num_layers, fraction=fraction),
        jax_selective.sync_layer_mask(policy, num_layers, fraction=fraction))
    assert selective.sync_overhead_fraction(policy, num_layers, fraction=fraction) \
        == jax_selective.sync_overhead_fraction(policy, num_layers,
                                                fraction=fraction)


@pytest.mark.parametrize("policy", ["low", "high", "random"])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_conditional_arithmetic_matches_jax(policy, stride):
    k = 2
    for step in range(6):
        assert conditional.is_refresh_step(step, stride) == \
            jax_cond.is_refresh_step(step, stride)
    assert conditional.policy_effective_k(policy, k) == \
        jax_cond.policy_effective_k(policy, k)


@pytest.mark.parametrize("policy", ["low", "high"])
def test_policy_mask_matches_jax(policy):
    mine = conditional.policy_mask(policy, 10, 2, device="cpu")
    ref = jax_cond.policy_mask(policy, 10, 2)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_random_policy_draws_from_the_generator():
    a = conditional.policy_mask("random", 64, 2,
                                generator=torch.Generator().manual_seed(3))
    b = conditional.policy_mask("random", 64, 2,
                                generator=torch.Generator().manual_seed(3))
    assert a.shape == (64, 2) and a.dtype == torch.bool
    assert torch.equal(a, b) and 0 < int(a.sum()) < a.numel()
    with pytest.raises(ValueError):
        conditional.policy_mask("random", 4, 2)


@pytest.mark.parametrize("name", ["config", "smoke", "tiny"])
def test_model_configs_field_equal(name):
    mine, ref = getattr(configs, name)(), getattr(jax_configs, name)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.expert_d_ff == ref.expert_d_ff


def test_unported_config_fields_raise():
    """Paging is still refused; a placement is carried (identity ones
    normalize away), so only paging raises."""
    with pytest.raises(NotImplementedError, match="A.9"):
        DiceConfig(paging=object())
    with pytest.raises(NotImplementedError, match="A.9"):
        plan_lib.LayerAction(paging=object())
    pl = Placement(perm=(1, 0, 2, 3), replicated=(0,), cap_scale=0.5)
    assert plan_lib.LayerAction(placement=pl).placement == pl
    assert plan_lib.LayerAction(placement=Placement.identity(4)) == \
        plan_lib.LayerAction()
    with pytest.raises(ValueError):
        plan_lib.LayerAction(mode="staggered",
                             codec=CompressConfig("int8_residual").spec())
