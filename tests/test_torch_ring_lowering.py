"""The ring engine's collective contract, checked on profiled steps
(``repro_torch.launch.hlo_cost``) against the reference's HLO check.

The reference lowers its ring step on a 4-device mesh (a subprocess with 4
forced XLA host devices, the 2-layer config of tests/test_ep_dice.py) and
``repro.launch.hlo_cost.check_ring_lowering`` counts the collective-
permutes of each plan variant's compiled HLO.  The port runs one step of
each variant in 4 gloo ranks under ``torch.profiler`` and its
``check_ring_lowering`` counts the c10d sends and receives in the trace:
each must equal the reference's collective-permute count (2 (n - 1) per
MoE layer call: layers, times 2 under CFG, times 2 for staggered half
batches) with no all-to-all, and a blocking step must raise.

Time limits: the reference subprocess 400 s (about 30 s here), the spawn
120 s.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.configs import dit_moe_xl as jax_configs
from repro.models.dit_moe import init_dit as jax_init_dit
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core.schedules import DiceConfig
from repro_torch.launch import hlo_cost
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EP = 4
REF_TIMEOUT_S = 400
RANK_TIMEOUT_S = 120
KW = dict(num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
          num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=8.0)

REF_PROG = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from repro.configs.dit_moe_xl import tiny
    from repro.core import plan as plan_lib
    from repro.core import staleness as stale_lib
    from repro.core.schedules import DiceConfig
    from repro.launch.hlo_cost import check_ring_lowering
    from repro.launch.mesh import make_ep_mesh
    from repro.models.dit_moe import init_dit
    from repro.sampling.rectified_flow import make_rf_step

    cfg = tiny().replace(**json.loads(sys.argv[1]))
    params = init_dit(jax.random.PRNGKey(0), cfg)
    mesh = make_ep_mesh(4)
    classes = jnp.arange(8) % cfg.num_classes
    key = jax.random.PRNGKey(7)
    out = {}
    for label, dcfg, guidance in (
            ("dice", DiceConfig.dice(overlap="ring"), 1.0),
            ("dice cfg", DiceConfig.dice(overlap="ring"), 1.5),
            ("staggered", DiceConfig.staggered_batch(overlap="ring"), 1.0)):
        splan = plan_lib.compile_step_plans(
            dcfg, cfg.num_layers, 6, experts_per_token=cfg.experts_per_token)
        step = make_rf_step(params, cfg, dcfg, dt=1.0 / 6, guidance=guidance,
                            mesh=mesh)
        states = stale_lib.init_planned_states(
            splan, num_tokens=8 * cfg.patch_tokens, d_model=cfg.d_model,
            k=cfg.experts_per_token, dtype=jnp.float32, mesh=mesh)
        x0 = jnp.zeros((8, cfg.patch_tokens, cfg.in_channels))
        t0 = jnp.zeros((8,))
        res = []
        for plan in splan.variants:
            txt = step.lower(x0, classes, states, states, {}, {}, t0, key,
                             plan=plan, slotted=False).compile().as_text()
            calls = cfg.num_layers * (2 if guidance != 1.0 else 1) * max(
                2 if a.mode == "staggered" else 1 for a in plan.actions)
            counts = check_ring_lowering(txt, n_dev=4, moe_layer_calls=calls)
            res.append([calls, counts.get("collective-permute", 0.0),
                        counts.get("all-to-all", 0.0)])
        out[label] = res
    print("RINGHLO " + json.dumps(out))
""")


def _runs():
    return [("dice", DiceConfig.dice(overlap="ring"), 1.0),
            ("dice cfg", DiceConfig.dice(overlap="ring"), 1.5),
            ("staggered", DiceConfig.staggered_batch(overlap="ring"), 1.0),
            ("blocking", DiceConfig.dice(), 1.0)]


@pytest.fixture(scope="module")
def both():
    """The reference's HLO counts (a subprocess) and the port's profiled
    counts on every rank (one spawn of 4 gloo ranks)."""
    import json
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_PROG, json.dumps(KW)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        jcfg = jax_configs.tiny().replace(**KW)
        tree = jax.device_get(jax_init_dit(jax.random.PRNGKey(0), jcfg))
        noise = np.asarray(jax.random.normal(
            jax.random.PRNGKey(7), (8, jcfg.patch_tokens, jcfg.in_channels)))
        classes = np.arange(8) % jcfg.num_classes
        port, _ = mesh_lib.spawn(
            jobs.ring_step_collectives, EP, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S,
            args=(tree, configs.tiny().replace(**KW), _runs(), noise,
                  classes))
        out, err = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    line = next(l for l in out.splitlines() if l.startswith("RINGHLO "))
    return json.loads(line[len("RINGHLO "):]), port


@pytest.mark.parametrize("label", ["dice", "dice cfg", "staggered"])
def test_ring_step_passes_with_the_reference_count(both, label):
    ref, port = both
    for rank, per_rank in enumerate(port):
        assert len(per_rank[label]) == len(ref[label])
        for (calls, counts, got), (rcalls, permutes, a2a) in zip(
                per_rank[label], ref[label]):
            want = 2 * (EP - 1) * calls
            assert calls == rcalls and permutes == want and a2a == 0
            assert got == counts, (rank, got)          # the check passed
            assert counts["send"] == counts["recv"] == want
            assert counts["all_to_all"] == 0


def test_blocking_step_raises(both):
    _, port = both
    for per_rank in port:
        for calls, counts, got in per_rank["blocking"]:
            assert counts["all_to_all"] == 2 * calls and counts["send"] == 0
            assert isinstance(got, str) and "all-to-all" in got


@pytest.mark.parametrize("names,kind", [
    (["c10d::send"] * 5 + ["c10d::recv_"] * 6, "receives"),
    (["c10d::send", "c10d::recv_"] * 6 + ["c10d::alltoall_base_"],
     "all-to-all")])
def test_check_names_the_counts_it_found(names, kind):
    with pytest.raises(ValueError, match=kind):
        hlo_cost.check_ring_lowering(names, n_dev=4, moe_layer_calls=1)
    ok = ["c10d::send", "c10d::recv_"] * 6 + ["c10d::allreduce_"]
    assert hlo_cost.check_ring_lowering(ok, n_dev=4, moe_layer_calls=1) == {
        "send": 6, "recv": 6, "all_to_all": 0, "all_reduce": 1,
        "all_gather": 0, "reduce_scatter": 0}
