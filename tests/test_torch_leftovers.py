"""The last small helpers of the port, against the reference:
``sampling/rectified_flow.make_sample_step`` (a per-step loop equals
``rf_sample`` bit for bit and the reference's sampler to ``TOL``; its
cache size counts the ``(plan, slotted)`` keys), ``core/plan.
registered_schedules``, ``core/staleness.init_layer_states`` /
``flatten_state`` / ``unflatten_state`` / ``staleness_of``, and
``compress/ref.int8_roundtrip`` / ``topk_roundtrip``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import ref as jax_ref
from repro.configs.dit_moe_xl import smoke as jax_smoke
from repro.core import plan as jax_plan
from repro.core import staleness as jax_stale
from repro.core.schedules import DiceConfig as JaxDice
from repro.core.schedules import Schedule as JaxSchedule
from repro.sampling.rectified_flow import rf_sample as jax_rf_sample
from repro_torch.compress import ref
from repro_torch.configs.dit_moe_xl import smoke
from repro_torch.core import plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.core.schedules import DiceConfig, Schedule
from repro_torch.sampling.rectified_flow import make_sample_step, rf_sample
from test_torch_slice import BATCH, GUIDANCE, STEPS, TOL

torch.set_num_threads(1)

CASES = {"interweaved": (DiceConfig.interweaved, JaxDice.interweaved),
         "dice": (DiceConfig.dice, JaxDice.dice)}


@pytest.mark.parametrize("name", list(CASES))
def test_make_sample_step_loop_matches_rf_sample_and_the_reference(
        name, jax_params, port_params):
    mine, theirs = (f() for f in CASES[name])
    cfg, key = smoke(), jax.random.PRNGKey(7)
    classes = jnp.arange(BATCH) % cfg.num_classes
    want, _ = jax_rf_sample(jax_params, jax_smoke(), theirs, num_steps=STEPS,
                            classes=classes, key=key, guidance=GUIDANCE)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (BATCH, cfg.patch_tokens, cfg.in_channels))))
    tclasses = torch.from_numpy(np.array(classes))
    whole, stats = rf_sample(port_params, cfg, mine, num_steps=STEPS,
                             classes=tclasses, noise=noise, guidance=GUIDANCE)
    splan = plan_lib.compile_step_plans(mine, cfg.num_layers, STEPS,
                                        experts_per_token=cfg.experts_per_token)

    def planned():
        return stale_lib.init_planned_states(
            splan, num_tokens=BATCH * cfg.patch_tokens, d_model=cfg.d_model,
            k=cfg.experts_per_token)

    dt = 1.0 / STEPS
    reused = make_sample_step(port_params, cfg, mine, tclasses, dt=dt,
                              guidance=GUIDANCE)
    for fresh in (True, False):
        x, st, stu, ps, psu = noise.clone(), planned(), planned(), {}, {}
        for s in range(STEPS):
            step = make_sample_step(port_params, cfg, mine, tclasses, dt=dt,
                                    guidance=GUIDANCE) if fresh else reused
            t = torch.full((BATCH,), s * dt)
            x, st, stu, ps, psu, _ = step(x, st, stu, ps, psu, t,
                                          plan=splan.steps[s], tick=s)
            if fresh:
                assert step._cache_size() == 1
        assert torch.equal(x, whole)
    assert reused._cache_size() == stats["num_plan_variants"] == splan.num_variants
    np.testing.assert_allclose(x.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def jax_params():
    from test_torch_slice import _perturbed_jax_params
    return _perturbed_jax_params()


@pytest.fixture(scope="module")
def port_params(jax_params):
    from repro_torch import bridge
    return bridge.from_jax_params(jax.device_get(jax_params), device="cpu")


def test_registered_schedules_equal_the_reference():
    assert plan_lib.registered_schedules() == jax_plan.registered_schedules()
    assert plan_lib.registered_schedules() == sorted(s.value for s in Schedule)


def test_init_layer_states_and_staleness_of_match_the_reference():
    got, want = stale_lib.init_layer_states(3), jax_stale.init_layer_states(3)
    assert got.keys() == want.keys()
    assert all(vars(s) == {k: None for k in vars(s)} for s in got.values())
    for mine, theirs in zip(Schedule, JaxSchedule):
        assert stale_lib.staleness_of(mine) == jax_stale.staleness_of(theirs)


def test_flatten_and_unflatten_state_match_the_reference():
    rng = np.random.default_rng(0)
    b, t, d, k = 2, 3, 4, 2
    arrays = {"y_buf": rng.standard_normal((b, t, d)).astype(np.float32),
              "h_cache": rng.standard_normal((b, t, k, d)).astype(np.float32)}
    mine = stale_lib.MoELayerState(**{n: torch.from_numpy(a) for n, a in arrays.items()})
    theirs = jax_stale.MoELayerState(**{n: jnp.asarray(a) for n, a in arrays.items()})
    flat, jflat = stale_lib.flatten_state(mine), jax_stale.flatten_state(theirs)
    for n in ("y_buf", "x_prev", "h_cache", "c_base"):
        g, w = getattr(flat, n), getattr(jflat, n)
        assert (g is None) == (w is None), n
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = stale_lib.unflatten_state(flat, b, t)
    for n, a in arrays.items():
        assert torch.equal(getattr(back, n), torch.from_numpy(a))


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 17)])
def test_roundtrips_match_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    r = rng.standard_normal(shape).astype(np.float32)
    r[0] = 0.0                                     # a row the guard zeroed: ties
    got = ref.int8_roundtrip(torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref.int8_roundtrip(jnp.asarray(r))))
    keep = max(1, shape[-1] // 4)
    got = ref.topk_roundtrip(torch.from_numpy(r), keep)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_ref.topk_roundtrip(jnp.asarray(r), keep)))
