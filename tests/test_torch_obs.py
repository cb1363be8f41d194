"""The port's in-graph staleness telemetry against the JAX package's, on
the CPU.

For each of the five schedules, and dice with the int8 and the top-k
codec, ``rf_sample`` with telemetry on gives, step by step, the
reference's (L, NUM_FIELDS) block to rtol 1e-4 / atol 1e-6 (energy ratios
of sums taken in another order, so bitwise is not the bar), and samples
bit-identical to the port's own run with telemetry off.  The serving
loops publish the blocks as the reference's per-layer series.  Over 2
gloo ranks the block is the mean of the two token shards' blocks.

A 2-layer DiT of tests/test_serve_continuous.py's widths (d 64, 16
tokens, capacity_factor 8.0) with its perturbed adaLN and output layer;
4 steps (warm-up 0-1, refresh 2, light 3).
"""
import jax
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_xl as jax_configs
from repro.core.schedules import DiceConfig as JaxDice
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.obs import ObsConfig as JaxObs
from repro.obs import telemetry as jax_telemetry
from repro.sampling.rectified_flow import rf_sample as jax_rf_sample
from repro_torch import bridge
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core.schedules import DiceConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.obs import ObsConfig, telemetry
from repro_torch.sampling.rectified_flow import rf_sample

torch.set_num_threads(1)

STEPS = 4
TEL_TOL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, patch_tokens=16,
          capacity_factor=8.0)


def _both(name):
    if name.startswith("dice+"):
        codec = name.split("+")[1]
        return (DiceConfig.dice(compress=CompressConfig(codec)),
                JaxDice.dice(compress=JaxCompress(codec)))
    mk = {"sync": "sync_ep"}.get(name, name)
    return getattr(DiceConfig, mk)(), getattr(JaxDice, mk)()


CASES = ("sync", "displaced", "interweaved", "dice", "staggered_batch",
         "dice+int8_residual", "dice+topk_residual")


@pytest.fixture(scope="module")
def jax_params():
    params = jax_init_dit(jax.random.PRNGKey(0),
                          jax_configs.tiny().replace(**KW))
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return params


@pytest.fixture(scope="module")
def port_params(jax_params):
    return bridge.from_jax_params(jax.device_get(jax_params), device="cpu")


def test_fields_equal_the_reference():
    assert telemetry.TELEMETRY_FIELDS == jax_telemetry.TELEMETRY_FIELDS
    assert (telemetry.AGE, telemetry.RES_DISPATCH, telemetry.RES_COMBINE,
            telemetry.MASK_RATE, telemetry.DROP_FRAC, telemetry.CODEC_ERR) == \
        (jax_telemetry.AGE, jax_telemetry.RES_DISPATCH,
         jax_telemetry.RES_COMBINE, jax_telemetry.MASK_RATE,
         jax_telemetry.DROP_FRAC, jax_telemetry.CODEC_ERR)


@pytest.mark.parametrize("name", CASES)
def test_telemetry_blocks_match_reference(name, jax_params, port_params):
    mine, ref = _both(name)
    cfg = configs.tiny().replace(**KW)
    key = jax.random.PRNGKey(7)
    cls = np.array([1, 6])
    want, ref_st = jax_rf_sample(jax_params, jax_configs.tiny().replace(**KW),
                                 ref, num_steps=STEPS, classes=cls, key=key,
                                 obs=JaxObs(enabled=True))
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (2, cfg.patch_tokens, cfg.in_channels))))
    got, st = rf_sample(port_params, cfg, mine, num_steps=STEPS,
                        classes=torch.from_numpy(cls), noise=noise,
                        obs=ObsConfig(enabled=True))
    plain, plain_st = rf_sample(port_params, cfg, mine, num_steps=STEPS,
                                classes=torch.from_numpy(cls), noise=noise)
    assert torch.equal(got, plain)                 # obs changes no bit
    assert "telemetry" not in plain_st
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(st["telemetry"]) == len(ref_st["telemetry"]) == STEPS
    assert len(st["step_wall_s"]) == STEPS
    for s, (a, b) in enumerate(zip(st["telemetry"], ref_st["telemetry"])):
        assert a.shape == (KW["num_layers"], telemetry.NUM_FIELDS)
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {s}",
                                   **TEL_TOL)
    light = st["telemetry"][-1]
    if "+" in name:
        assert light[:, telemetry.CODEC_ERR].max() > 0
    else:
        assert (np.stack(st["telemetry"])[..., telemetry.CODEC_ERR] == 0).all()


def test_serving_publishes_the_reference_series(port_params):
    """generate and serve_continuous put every step's block into the
    registry as per-layer series (the reference's names and labels), and
    the continuous engine's samples do not move."""
    cfg = configs.tiny().replace(**KW)
    dcfg = DiceConfig.dice(compress=CompressConfig("int8_residual"))
    server = serve.DiceServer(cfg, dcfg, params=port_params, device="cpu",
                              obs=ObsConfig(enabled=True))
    reqs = [serve.Request(1, 0), serve.Request(2, 1), serve.Request(3, 2)]
    _, res = server.generate(reqs[:2], num_steps=STEPS)
    assert len(res["telemetry"]) == STEPS and server.tracer is not None
    out, stats = serve.serve_continuous(server, reqs, max_batch=2,
                                        num_steps=STEPS, seed=1,
                                        arrival_steps=[0.0, 0.0, 1.0])
    plain = serve.DiceServer(cfg, dcfg, params=port_params, device="cpu")
    ref, _ = serve.serve_continuous(plain, reqs, max_batch=2, num_steps=STEPS,
                                    seed=1, arrival_steps=[0.0, 0.0, 1.0])
    assert all(torch.equal(out[r], ref[r]) for r in ref)
    text = server.metrics.to_prometheus()
    for name in ("dice_staleness_age", "dice_mask_rate", "dice_dropped_frac",
                 "dice_codec_error", "dice_residual_energy",
                 "dice_step_wall_seconds"):
        assert name in text, name
    lab = {"schedule": "dice", "engine": "continuous", "layer": "01"}
    ages = server.metrics.get("dice_staleness_age", lab)
    assert ages is not None and len(ages.values) == stats["ticks"]


def test_shard_mean_over_two_gloo_ranks(jax_params, port_params):
    """Each rank's block is the mean of the two shards' blocks, and equal
    on both ranks; with capacity to spare every shard computes what a
    single process computes for its requests alone."""
    cfg = configs.tiny().replace(**KW)
    dcfg = DiceConfig.dice(compress=CompressConfig("int8_residual"))
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((2, cfg.patch_tokens, cfg.in_channels)
                                ).astype(np.float32)
    cls = np.array([2, 7])
    (x, blocks), _ = mesh_lib.spawn(
        jobs.obs_blocks, 2, backend="gloo", device="cpu", timeout_s=120,
        args=(jax.device_get(jax_params), cfg, dcfg, noise, cls, STEPS))
    halves = [rf_sample(port_params, cfg, dcfg, num_steps=STEPS,
                        classes=torch.from_numpy(cls[i:i + 1]),
                        noise=torch.from_numpy(noise[i:i + 1]),
                        obs=ObsConfig(enabled=True))[1]["telemetry"]
              for i in range(2)]
    assert len(blocks) == 2
    for s in range(STEPS):
        assert torch.equal(blocks[0][s], blocks[1][s])
        np.testing.assert_allclose(blocks[0][s].numpy(),
                                   (halves[0][s] + halves[1][s]) / 2,
                                   **TEL_TOL)
    single, _ = rf_sample(port_params, cfg, dcfg, num_steps=STEPS,
                          classes=torch.from_numpy(cls),
                          noise=torch.from_numpy(noise))
    np.testing.assert_allclose(x.numpy(), single.numpy(), **TOL)
