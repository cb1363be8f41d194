"""The port's serving slice end to end against the JAX package, on the CPU.

The JAX ``smoke`` model's params (with the zero-initialised leaves given
random values, so no block is an identity map) are carried over through
``repro_torch.bridge.from_jax_params``; JAX's initial noise goes to the
port as an array.  The port's ``DiceServer.generate`` and ``rf_sample``
must then give the reference's samples for every schedule, and the
per-step dispatch bytes must be equal exactly.

Tolerance: rtol 1e-4 / atol 1e-5 on samples of magnitude ~4, f32 end to
end; the two frameworks sum matrix products in another order, which is
all that separates them (observed ~5e-7).  5 steps reach a light step
whose expert outputs a later step consumes (warm-up 0-1, refresh 2 and
4, light 3).
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs.dit_moe_xl import smoke as jax_smoke
from repro.core.schedules import DiceConfig as JaxDice
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.sampling.rectified_flow import rf_sample as jax_rf_sample
from repro_torch import bridge
from repro_torch.common.device import resolve_device
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs.dit_moe_xl import smoke, tiny
from repro_torch.core.schedules import DiceConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.dit_moe import init_dit
from repro_torch.sampling.rectified_flow import rf_sample

torch.set_num_threads(1)

STEPS = 5
BATCH = 2
GUIDANCE = 1.5
TOL = dict(rtol=1e-4, atol=1e-5)
CASES = {
    "sync": (DiceConfig.sync_ep, JaxDice.sync_ep, None),
    "displaced": (DiceConfig.displaced, JaxDice.displaced, None),
    "interweaved": (DiceConfig.interweaved, JaxDice.interweaved, None),
    "dice": (DiceConfig.dice, JaxDice.dice, None),
    "staggered_batch": (DiceConfig.staggered_batch, JaxDice.staggered_batch, None),
    "dice_int8": (DiceConfig.dice, JaxDice.dice, "int8_residual"),
}


def _perturbed_jax_params():
    params = jax_init_dit(jax.random.PRNGKey(0), jax_smoke())
    rng = np.random.default_rng(99)

    def rand(a):
        return jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype)
    for blk in params["blocks"]:
        blk["adaln"] = rand(blk["adaln"])
        blk["ln1"]["scale"] = rand(blk["ln1"]["scale"])
        blk["ln2"]["scale"] = rand(blk["ln2"]["scale"])
    for name in ("final_out", "final_mod"):
        params[name] = rand(params[name])
    params["final_norm"]["scale"] = rand(params["final_norm"]["scale"])
    return params


@pytest.fixture(scope="module")
def jax_params():
    return _perturbed_jax_params()


@pytest.fixture(scope="module")
def port_params(jax_params):
    return bridge.from_jax_params(jax.device_get(jax_params), device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_server_matches_jax_rf_sample(name, jax_params, port_params):
    mine_fn, ref_fn, codec = CASES[name]
    mine_dcfg, ref_dcfg = mine_fn(), ref_fn()
    if codec:
        ref_dcfg = dataclasses.replace(ref_dcfg, compress=JaxCompress(codec))
    key = jax.random.PRNGKey(7)
    classes = jnp.arange(BATCH) % jax_smoke().num_classes
    ref, ref_stats = jax_rf_sample(jax_params, jax_smoke(), ref_dcfg,
                                   num_steps=STEPS, classes=classes, key=key,
                                   guidance=GUIDANCE)
    # rf_sample's initial noise, drawn as the reference draws it
    noise = np.array(jax.random.normal(
        key, (BATCH, jax_smoke().patch_tokens, jax_smoke().in_channels)))
    server = serve.DiceServer(smoke(), mine_dcfg, params=port_params,
                              device="cpu",
                              compress=CompressConfig(codec) if codec else None)
    reqs = [serve.Request(class_id=int(c), rid=i) for i, c in enumerate(classes)]
    out, stats = server.generate(reqs, num_steps=STEPS, guidance=GUIDANCE,
                                 noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert stats["dispatch_bytes_per_step"] == \
        [float(b) for b in ref_stats["dispatch_bytes"]]
    assert stats["num_plan_variants"] == ref_stats["num_plan_variants"]
    assert stats["buffer_bytes"] == float(ref_stats["buffer_bytes"][-1])
    assert stats["raw_bytes_total"] == float(sum(ref_stats["raw_bytes"]))
    assert stats["device"] == "cpu" and stats["wall_s"] > 0
    assert stats["kernel_launches"] == {k: 0 for k in ops.LAUNCHES}
    if codec:
        assert stats["wire_bytes_total"] < stats["raw_bytes_total"]


def test_rf_sample_with_noise_matches_server(port_params):
    """rf_sample is what the server runs; a generator or an explicit noise
    tensor seeds it."""
    cfg = smoke()
    classes = torch.arange(BATCH) % cfg.num_classes
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn((BATCH, cfg.patch_tokens, cfg.in_channels),
                        generator=torch.Generator().manual_seed(3))
    a, sa = rf_sample(port_params, cfg, DiceConfig.dice(), num_steps=3,
                      classes=classes, generator=gen)
    b, sb = rf_sample(port_params, cfg, DiceConfig.dice(), num_steps=3,
                      classes=classes, noise=noise)
    assert torch.equal(a, b) and sa == sb
    with pytest.raises(ValueError):
        rf_sample(port_params, cfg, DiceConfig.dice(), num_steps=1,
                  classes=classes)


def test_bridge_covers_every_leaf(jax_params, port_params):
    ref = bridge.leaves(jax_params)
    mine = bridge.leaves(port_params)
    assert list(mine) == list(ref) and len(mine) == len(ref)
    for path, leaf in ref.items():
        assert tuple(mine[path].shape) == tuple(leaf.shape), path
        np.testing.assert_array_equal(mine[path].numpy(), np.asarray(leaf))
    with pytest.raises(KeyError):
        bridge.from_jax_params({"blocks": []}, device="cpu")


def test_port_init_has_the_reference_tree():
    ref = bridge.leaves(jax_init_dit(jax.random.PRNGKey(0), jax_smoke()))
    mine = bridge.leaves(init_dit(smoke(), generator=torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in mine.values())


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.DiceServer(smoke(), DiceConfig.dice())
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--device", "cpu", "--requests", "2", "--steps", "4",
                    "--schedule", "dice", "--codec", "int8_residual"])
    out = buf.getvalue()
    assert "model=dit-moe-tiny" in out and "finite=True" in out
    assert "3 variants for 4 steps" in out
    assert "kernel_launches" in out and "modeled" not in out


def test_server_plan_is_what_generate_runs():
    server = serve.DiceServer(tiny(), DiceConfig.dice(), device="cpu", seed=1,
                              compress=CompressConfig("int8_residual"))
    splan = server.plan(6)
    assert splan.num_variants == 3 and splan.num_steps == 6
    assert set(serve.SCHEDULES) == {"sync", "displaced", "interweaved", "dice",
                                    "staggered_batch"}
