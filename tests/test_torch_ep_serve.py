"""The port's serving engines over an expert-parallel mesh, on the CPU.

``serve_continuous(mesh=)`` at ep = 4 (4 spawned gloo ranks, one slot
each) on the 4-layer config of ``tests/test_serve_continuous.py``
(capacity_factor 8.0, so no dispatch overflows) with the reference's
perturbed params (``bridge.from_jax_params``): a request admitted into a
recycled slot, and the first wave, equal the same requests in a fresh
fixed batch over the mesh bit for bit, as
``tests/test_serve_continuous.py:200-299`` holds for the reference on one
device; the mesh run equals the port's single-process run within TOL_F32
(f32, sums in another order) with the same tick, admission and byte
counts; every rank runs as many step keys as there are plan variants.
Then the serving CLI with ``--ep 2 --backend gloo``.

Time limits: each spawn of ranks 120 s for its collectives and its
reports, the CLI subprocess 180 s.
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stderr

import jax
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.configs import dit_moe_xl as jax_configs
from repro.models.dit_moe import init_dit as jax_init_dit
from repro_torch import bridge
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core.schedules import DiceConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EP = 4
SLOTS = 4
STEPS = 6
SEED = 42
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
RANK_TIMEOUT_S = 120
CLI_TIMEOUT_S = 180
# the first wave fills the 4 slots; rids 4 and 5 arrive at tick 1 and are
# admitted into recycled slots when the first wave finishes
REQS = [(1, 0), (2, 1), (3, 2), (4, 3), (5, 4), (6, 5)]
ARRIVALS = [0.0, 0.0, 0.0, 0.0, 1.0, 1.0]
FRESH = ([(1, 0), (2, 1), (3, 2), (4, 3)],          # the first wave
         [(5, 4), (6, 5), (7, 6), (8, 7)])          # 4 and 5, others beside
ENGINES = ("sync", "interweaved", "dice", "dice_int8")
COUNTS = ("ticks", "makespan_steps", "padded_slot_steps", "slot_occupancy",
          "slotted_ticks", "admissions", "recycled_admissions",
          "steady_period", "buffer_bytes", "num_plan_variants", "step_keys")


def _dcfg(name):
    if name == "dice_int8":
        return DiceConfig.dice(compress=CompressConfig("int8_residual"))
    if name == "dice_random":
        return DiceConfig.dice(cond_policy="random")
    return {"sync": DiceConfig.sync_ep, "interweaved": DiceConfig.interweaved,
            "dice": DiceConfig.dice}[name]()


def _cfg():
    return configs.tiny().replace(num_layers=4, d_model=64, moe_d_ff=64,
                                  d_ff=256, patch_tokens=16,
                                  capacity_factor=8.0)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jax_configs.tiny().replace(num_layers=4, d_model=64, moe_d_ff=64,
                                     d_ff=256, patch_tokens=16,
                                     capacity_factor=8.0)
    params = jax_init_dit(jax.random.PRNGKey(0), cfg)
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return jax.device_get(params)


@pytest.fixture(scope="module")
def noise():
    rng = np.random.default_rng(SEED)
    cfg = _cfg()
    return {rid: rng.standard_normal((cfg.patch_tokens, cfg.in_channels))
            .astype(np.float32) for rid in range(8)}


@pytest.fixture(scope="module")
def mesh_runs(jax_tree, noise):
    runs = [(name, _dcfg(name), STEPS, FRESH) for name in ENGINES]
    runs.append(("dice_random", _dcfg("dice_random"), STEPS, ()))
    (out, masks), counts = mesh_lib.spawn(
        jobs.continuous_and_masks, EP, backend="gloo", device="cpu",
        timeout_s=RANK_TIMEOUT_S,
        args=(jax_tree, _cfg(), runs, REQS, ARRIVALS, SEED, noise, SLOTS))
    assert counts == [{k: 0 for k in counts[0]}] * EP   # plain versions
    return out, masks


@pytest.mark.parametrize("name", ENGINES)
def test_recycled_slot_equals_a_fresh_mesh_batch(name, mesh_runs):
    got, stats, fresh, keys = mesh_runs[0][name]
    assert stats["recycled_admissions"] == 2
    assert sorted(got) == [r for _, r in REQS]
    for rid in range(6):
        assert torch.equal(got[rid], fresh[rid]), rid
    assert keys == [stats["num_plan_variants"]] * EP      # every rank
    assert (stats["ep"], stats["backend"]) == (EP, "gloo")


@pytest.mark.parametrize("name", ENGINES)
def test_mesh_serving_matches_the_single_process_engine(name, mesh_runs,
                                                        jax_tree, noise):
    got, stats, _, _ = mesh_runs[0][name]
    server = serve.DiceServer(_cfg(), _dcfg(name), device="cpu",
                              params=bridge.from_jax_params(jax_tree,
                                                            device="cpu"))
    ref, ref_stats = serve.serve_continuous(
        server, [serve.Request(c, r) for c, r in REQS], max_batch=SLOTS,
        num_steps=STEPS, seed=SEED, arrival_steps=ARRIVALS, noise=noise)
    for rid in ref:
        np.testing.assert_allclose(got[rid].numpy(), ref[rid].numpy(),
                                   **TOL_F32)
    for key in COUNTS:
        assert stats[key] == ref_stats[key], key
    assert stats["tick_variants"] == ref_stats["tick_variants"]
    # per-rank payload: a quarter of the single process's buffer
    assert stats["dispatch_bytes_total"] * EP == \
        ref_stats["dispatch_bytes_total"]
    assert "ep" not in ref_stats


def test_random_policy_draws_one_mask_per_rank(mesh_runs):
    """Over the mesh each rank draws its "random" mask from (seed, tick,
    rank): the token shards get different masks, as the reference's
    per-device fold_in gives them."""
    out, masks = mesh_runs
    assert len(masks) == EP
    assert all(m.shape == (16, 2) for m in masks)
    assert len({m.numpy().tobytes() for m in masks}) == EP
    again = serve._tick_generator(SEED, 0, "cpu", 2)
    from repro_torch.core import conditional
    assert torch.equal(conditional.policy_mask("random", 16, 2,
                                               generator=again), masks[2])
    got, stats, _, keys = out["dice_random"]
    assert sorted(got) == [r for _, r in REQS]
    assert all(bool(torch.isfinite(x).all()) for x in got.values())
    assert keys == [stats["num_plan_variants"]] * EP


def test_serve_cli_over_two_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ep", "2",
         "--backend", "gloo", "--device", "cpu", "--overlap", "ring",
         "--requests", "4", "--steps", "4", "--codec", "int8_residual"],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "expert-parallel over 2 ranks (gloo, ring)" in text
    assert "samples: (4, 64, 4), finite=True" in text
    lines = dict(line.split(None, 1) for line in text.splitlines()
                 if line.startswith("  ") and not line.startswith("  rank"))
    assert (lines["ep"], lines["backend"], lines["ring_hops"]) == \
        ("2", "gloo", "2")
    assert float(lines["hop_bytes_total"]) > 0
    assert text.count("kernel launches") == 2           # one line a rank


def test_serve_cli_needs_an_explicit_backend():
    with redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
        serve.main(["--ep", "2", "--device", "cpu"])
