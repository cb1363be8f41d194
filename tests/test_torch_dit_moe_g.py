"""DiT-MoE-G, the paper's larger model, against the JAX package's config
and sampler, on the CPU.

``config()`` and ``smoke()`` equal the reference's field for field, and
``param_count()`` is 17.45 B.  ``rf_sample`` at G's ``smoke()`` (and at
a narrow case with G's head dim 88: 2 heads x 88) runs through the plain
versions of the kernels on the reference's params (adaLN and the output
layer perturbed, so every block contributes) and noise, and must match
the reference's jitted run within TOL_F32 (rtol = atol = 1e-4: f32 end to
end, sums in another order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_g as jax_g
from repro.core.schedules import DiceConfig as JaxDice
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.sampling.rectified_flow import rf_sample as jax_rf_sample
from repro_torch import bridge
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_g, get_config, get_smoke
from repro_torch.core.schedules import DiceConfig
from repro_torch.sampling.rectified_flow import rf_sample

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
STEPS = 4


@pytest.mark.parametrize("name", ["config", "smoke"])
def test_g_configs_field_equal(name):
    mine, ref = getattr(dit_moe_g, name)(), getattr(jax_g, name)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.expert_d_ff == ref.expert_d_ff


def test_g_is_in_the_registry_at_17_45b_parameters():
    cfg = get_config("dit-moe-g")
    assert cfg == dit_moe_g.config() and get_smoke("dit-moe-g") == \
        dit_moe_g.smoke()
    assert cfg.param_count() == jax_g.config().param_count()
    assert round(cfg.param_count() / 1e9, 2) == 17.45
    # the routed experts: 60.9 GB in f32, 1.52 GB a layer, 761 MB a layer
    # on each of 2 ep ranks (what paging moves off the card)
    per_layer = cfg.num_experts * 3 * cfg.d_model * cfg.expert_d_ff * 4
    assert per_layer * cfg.num_layers == 60_901_294_080
    assert per_layer // 2 == 761_266_176


def _tree(cfg):
    tree = jax.device_get(jax_init_dit(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(99)
    for blk in tree["blocks"]:
        blk["adaln"] = (0.05 * rng.standard_normal(
            blk["adaln"].shape)).astype(np.float32)
    tree["final_out"] = (0.05 * rng.standard_normal(
        tree["final_out"].shape)).astype(np.float32)
    return tree


CASES = {
    "smoke": {},
    "head_dim_88": dict(num_heads=2, num_kv_heads=2, head_dim=88),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("codec", [None, "int8_residual"])
def test_rf_sample_at_g_smoke_matches_reference(case, codec):
    jcfg = jax_g.smoke().replace(**CASES[case])
    cfg = dit_moe_g.smoke().replace(**CASES[case])
    tree = _tree(jcfg)
    B = 4
    key = jax.random.PRNGKey(7)
    classes = np.arange(B) % jcfg.num_classes
    jdcfg = JaxDice.dice(compress=None if codec is None
                         else JaxCompress(codec))
    want, _ = jax_rf_sample(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                            jcfg, jdcfg, num_steps=STEPS,
                            classes=jax.numpy.asarray(classes), key=key,
                            guidance=1.5)
    noise = np.asarray(jax.random.normal(
        key, (B, jcfg.patch_tokens, jcfg.in_channels)))
    dcfg = DiceConfig.dice(compress=None if codec is None
                           else CompressConfig(codec))
    got, _ = rf_sample(bridge.from_jax_params(tree, device="cpu"), cfg, dcfg,
                       num_steps=STEPS, classes=torch.as_tensor(classes),
                       noise=torch.from_numpy(noise.copy()), guidance=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_F32)
    assert float(np.abs(np.asarray(want) - noise).max()) > 1e-2  # it moved
