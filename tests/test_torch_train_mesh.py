"""The port's training mesh (``launch/mesh.TrainMesh``, ``make_local_mesh``,
``batch_axes``; the expert-parallel ``dense._moe_block``; ``train_lm``'s
gradient reduction) on the CPU with gloo ranks, against the reference's
``shard_map`` on forced XLA host devices.

One reference subprocess (4 forced devices) runs, in f32:

* (a) qwen3-moe smoke at ``capacity_factor`` 1.0 (capacity drops happen)
  under ``make_local_mesh(2, 2)``: the loss, every gradient leaf, the
  clipped norm and the params after one step of its ``train_lm`` step
  (AdamW from zero moments at step 10 of the cosine schedule);
* (b) prefill then two decode steps under ``make_local_mesh(1, 2)`` for a
  prompt whose prefill splits the sequence and whose decode splits the
  batch, and for one that splits neither way (the fallback), with the
  fallback prompt's loss and gradients;
* (c) qwen3-32b smoke's single-device ``value_and_grad``;
* (h) (a)'s model under ``make_local_mesh(2, 2)`` where the sequence does
  not split: prefill then two decode steps of an 8-row prompt (decode
  splits the global batch over ``model``, at a capacity floor of 1 so
  tokens drop), and the loss and gradients of a batch of odd length.

The port runs the same in one spawn of 4 gloo ranks (data 2 x model 2:
(a), (c), (h) and (f), three planted faults that (a)'s comparison must reject)
and one of 2 (data 1 x model 2: (b)).  The reference's params come over
through numpy and ``bridge.from_jax_params``.  Besides: (d) the spec rules
against the reference's over the ``jax.eval_shape`` trees of all twelve
configs on three duck meshes, (e) ``make_local_mesh``'s clamp and
``make_production_mesh``'s error on a one-rank world against the
reference on one CPU device, (g) the CLI's ``--mesh local`` against
``--mesh none``.

The reference's ``_moe_block`` raises under this JAX (ROADMAP C.11): it
takes ``pmean(lb, batch_axes + ("model",))`` of a value already invariant
over ``model``, which ``shard_map``'s replication check refuses.  The
subprocess wraps ``jax.lax.pmean`` to reduce over the axes where its input
varies only, the same value (the mean of an invariant is itself).

Tolerances: every gradient leaf, the clipped norm and the updated params
by ``GRAD_TOL``, the loss by ``LOSS_RTOL`` (``tests/test_torch_lm_train.py``,
with their reasons); logits by ``MODEL_TOL`` (``tests/test_torch_dense.py``).
Time limits: the reference subprocess 300 s, each spawn 120 s.
"""
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_mesh_jobs as jobs
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.common import sharding as jax_sharding
from repro.launch import mesh as jax_mesh
from repro.models.api import get_model as jax_get_model
from repro.models.dit_moe import init_dit as jax_init_dit
from repro_torch.common import sharding as shard_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_cli
from test_torch_dense import MODEL_TOL
from test_torch_lm_train import GRAD_TOL, LOSS_RTOL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TIMEOUT_S = 300
RANK_TIMEOUT_S = 120
STEP0, TOTAL = 10, 100          # lr 1.5e-4 at the step (warm-up of 20)
DECODE_STEPS = 2
CONFIGS = ("dit-moe-xl", "dit-moe-g", "rwkv6-3b", "gemma2-9b", "qwen3-32b",
           "stablelm-12b", "deepseek-67b", "qwen3-moe-30b-a3b", "dbrx-132b",
           "zamba2-7b", "seamless-m4t-large-v2", "llama-3.2-vision-11b")

REF_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp

    _pmean = jax.lax.pmean

    def pmean(x, axis_name, **kw):
        # only over the axes where x varies (ROADMAP C.11)
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        axes = tuple(a for a in axes if a in jax.typeof(x).vma)
        return _pmean(x, axes, **kw) if axes else x

    jax.lax.pmean = pmean
    from repro.configs import get_smoke
    from repro.launch.mesh import batch_axes, make_local_mesh
    from repro.models.api import get_model
    from repro.optim.adamw import (adamw_init, adamw_update,
                                   clip_by_global_norm, cosine_schedule)

    inp = dict(np.load(sys.argv[1]))
    step0, total, steps = (int(v) for v in inp.pop("consts"))
    out = {}

    def put(prefix, tree):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
            out[f"{prefix}/{i}"] = np.asarray(leaf)

    def batch(name):
        return {"tokens": jnp.asarray(inp[name + "_tokens"]),
                "labels": jnp.asarray(inp[name + "_labels"])}

    # (a) the MoE train step under make_local_mesh(2, 2)
    cfg = get_smoke("qwen3-moe-30b-a3b").replace(capacity_factor=1.0)
    api = get_model(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    mesh = make_local_mesh(2, 2)
    kw = {"mesh": mesh, "batch_axes": batch_axes(mesh)}

    @jax.jit
    def step(params, opt, b):
        loss, grads = jax.value_and_grad(
            lambda p: api.loss_fn(p, b, cfg, **kw)[0])(params)
        clipped, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt.step, base_lr=3e-4, warmup=20, total=total)
        new, _ = adamw_update(clipped, opt, params, lr=lr)
        return loss, grads, gnorm, new

    opt = adamw_init(params)._replace(step=jnp.asarray(step0, jnp.int32))
    loss, grads, gnorm, new = step(params, opt, batch("a"))
    out["a/loss"], out["a/gnorm"] = np.asarray(loss), np.asarray(gnorm)
    put("a/grads", grads)
    put("a/params", new)

    # (c) the dense model on one device
    dcfg = get_smoke("qwen3-32b")
    dapi = get_model(dcfg)
    dparams = dapi.init(jax.random.PRNGKey(1), dcfg, dtype=jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: dapi.loss_fn(p, batch("c"), dcfg)[0]))(dparams)
    out["c/loss"] = np.asarray(loss)
    put("c/grads", grads)

    # (h) (a)'s model under make_local_mesh(2, 2) where no sequence split
    # happens: decode splits the global batch, and so does an odd length
    toks = jnp.asarray(inp["wide"])
    S = toks.shape[1] - steps
    lg, cache = api.prefill(params, {"tokens": toks[:, :S]}, cfg, **kw)
    out["h/decode/0"] = np.asarray(lg)
    for t in range(S, S + steps):
        lg, cache = api.decode_step(params, {"token": toks[:, t]}, cache, cfg,
                                    capacity_floor=1, **kw)
        out[f"h/decode/{t - S + 1}"] = np.asarray(lg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss_fn(p, batch("h"), cfg, **kw)[0]))(params)
    out["h/loss"] = np.asarray(loss)
    put("h/grads", grads)

    # (b) prefill + decode under make_local_mesh(1, 2)
    scfg = get_smoke("qwen3-moe-30b-a3b")
    sparams = api.init(jax.random.PRNGKey(2), scfg, dtype=jnp.float32)
    mesh = make_local_mesh(1, 2)
    kw = {"mesh": mesh, "batch_axes": batch_axes(mesh)}
    for name in ("split", "fallback"):
        toks = jnp.asarray(inp[name])
        S = toks.shape[1] - steps
        lg, cache = api.prefill(sparams, {"tokens": toks[:, :S]}, scfg, **kw)
        out[f"b/{name}/0"] = np.asarray(lg)
        for t in range(S, S + steps):
            lg, cache = api.decode_step(sparams, {"token": toks[:, t]}, cache,
                                        scfg, **kw)
            out[f"b/{name}/{t - S + 1}"] = np.asarray(lg)
    toks = jnp.asarray(inp["fallback"])
    fb = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    loss, grads = jax.value_and_grad(
        lambda p: api.loss_fn(p, fb, scfg, **kw)[0])(sparams)
    out["b/fallback_loss"] = np.asarray(loss)
    put("b/fallback_grads", grads)
    np.savez(sys.argv[2], **out)
""")


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tokens(rng, vocab, B, S):
    t = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return t, np.roll(t, -1, 1)


def _leaf_errors(got, want):
    """[(index, max abs error, bound)] of the leaves over GRAD_TOL's f32
    bound."""
    rel, floor = GRAD_TOL["float32"]
    assert len(got) == len(want)
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), np.asarray(w, np.float32)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        bound = rel * np.abs(w).max() + floor
        err = float(np.abs(g - w).max())
        if not err <= bound:
            out.append((i, err, bound))
    return out


def _step_errors(port, ref, prefix="a"):
    """What of (a)'s comparison fails: loss, gradient leaves, clipped norm,
    updated params."""
    n = len(port["grads"])
    want = [ref[f"{prefix}/grads/{i}"] for i in range(n)]
    errs = {}
    if not np.isclose(port["loss"], ref[f"{prefix}/loss"], rtol=LOSS_RTOL["float32"],
                      atol=0):
        errs["loss"] = (port["loss"], float(ref[f"{prefix}/loss"]))
    if bad := _leaf_errors(port["grads"], want):
        errs["grads"] = [(port["paths"][i], e, b) for i, e, b in bad]
    rel, floor = GRAD_TOL["float32"]
    gn = float(ref[f"{prefix}/gnorm"])
    if not abs(port["gnorm"] - gn) <= rel * gn + floor:
        errs["gnorm"] = (port["gnorm"], gn)
    if bad := _leaf_errors(port["params"], [ref[f"{prefix}/params/{i}"]
                                            for i in range(n)]):
        errs["params"] = [(port["paths"][i], e, b) for i, e, b in bad]
    return errs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the port's two spawns, side by side."""
    d = tmp_path_factory.mktemp("train_mesh")
    rng = np.random.default_rng(28)
    moe, dense_cfg = jax_get_smoke(jobs.MOE), jax_get_smoke(jobs.DENSE)
    a_t, a_l = _tokens(rng, moe.vocab_size, 4, 16)
    c_t, c_l = _tokens(rng, dense_cfg.vocab_size, 4, 16)
    split = rng.integers(0, moe.vocab_size, (2, 8 + DECODE_STEPS)).astype(np.int32)
    fallback = rng.integers(0, moe.vocab_size, (1, 3 + DECODE_STEPS)).astype(np.int32)
    wide = rng.integers(0, moe.vocab_size, (8, 8 + DECODE_STEPS)).astype(np.int32)
    h_t, h_l = _tokens(rng, moe.vocab_size, 4, 15)
    np.savez(d / "in.npz", a_tokens=a_t, a_labels=a_l, c_tokens=c_t, c_labels=c_l,
             split=split, fallback=fallback, wide=wide, h_tokens=h_t, h_labels=h_l,
             consts=np.asarray([STEP0, TOTAL, DECODE_STEPS]))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_PROG, str(d / "in.npz"),
                             str(d / "ref.npz")], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        trees = {}
        for key, name, seed in (("a", jobs.MOE, 0), ("c", jobs.DENSE, 1),
                                ("b", jobs.MOE, 2)):
            cfg = jax_get_smoke(name)
            if key == "a":
                cfg = cfg.replace(capacity_factor=1.0)
            trees[key] = jax.device_get(jax_get_model(cfg).init(
                jax.random.PRNGKey(seed), cfg, dtype=jnp.float32))
        train, _ = mesh_lib.spawn(
            jobs.train_case, 4, data=2, model=2, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S,
            args=(trees["a"], {"tokens": a_t, "labels": a_l}, trees["c"],
                  {"tokens": c_t, "labels": c_l}, STEP0, TOTAL, wide,
                  {"tokens": h_t, "labels": h_l}, DECODE_STEPS))
        serve, _ = mesh_lib.spawn(
            jobs.serve_case, 2, data=1, model=2, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S,
            args=(trees["b"], split, fallback, DECODE_STEPS, str(d / "mesh.ckpt")))
        _, err = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(d / "ref.npz") as f:
        ref = {k: f[k] for k in f.files}
    serve["ckpt"] = str(d / "mesh.ckpt")
    return ref, train, serve


def test_the_mesh_lays_ranks_out_pod_data_model(runs):
    _, train, _ = runs
    names, shape, coords = train["mesh"]
    assert names == ("data", "model") and shape == {"data": 2, "model": 2}
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]      # model innermost


def test_moe_step_on_data2_model2_matches_the_reference_mesh(runs):
    """(a): loss, every gradient leaf, the clipped norm and the params after
    one AdamW step of qwen3-moe smoke at capacity_factor 1.0."""
    ref, train, _ = runs
    port = train["a"]
    assert _step_errors(port, ref) == {}
    paths = port["paths"]
    router = [i for i, p in enumerate(paths) if p.endswith("router")]
    assert router and all(np.abs(ref[f"a/grads/{i}"]).max() > 0 for i in router)
    # the clip is active, so the norm scales every leaf of the update
    assert float(ref["a/gnorm"]) > 1.0


def test_replicated_leaves_are_bit_identical_across_ranks(runs):
    """Rules (ii) and (iii): after the reduction every rank holds the same
    gradient and updated param of each leaf but the experts (the batch
    group's mean makes data ranks agree, the identical computation model
    ranks)."""
    _, train, _ = runs
    digests = train["a"]["digests"]
    assert len(digests) == 4 and all(d == digests[0] for d in digests)


@pytest.mark.parametrize("fault", sorted(jobs.FAULTS))
def test_planted_faults_fail_the_step_comparison(runs, fault):
    """(f): the router's share not summed over model, the norm over the
    local experts only, the gather's backward summing: each fails (a)."""
    ref, train, _ = runs
    errs = _step_errors(train["faults"][fault], ref)
    assert errs, fault
    if fault == "norm_local_experts":
        assert "gnorm" in errs
    else:
        assert "grads" in errs


def test_dense_data2_matches_the_single_device_gradients(runs):
    """(c): qwen3-32b smoke trained data-parallel (data 2 x model 2, the model
    ranks redundant) against the reference's single-device value_and_grad
    on the whole batch."""
    ref, train, _ = runs
    port = train["c"]
    np.testing.assert_allclose(port["loss"], ref["c/loss"], rtol=LOSS_RTOL["float32"])
    assert _leaf_errors(port["grads"], [ref[f"c/grads/{i}"]
                                        for i in range(len(port["grads"]))]) == []


@pytest.mark.parametrize("case", ["split", "fallback"])
def test_prefill_and_decode_over_model2_match_the_reference(runs, case):
    """(b): prefill (sequence split, or the fallback) and two decode steps
    (batch split, or the fallback) under the 1 x 2 mesh."""
    ref, _, serve = runs
    for i, got in enumerate(serve[case]):
        np.testing.assert_allclose(_np(got), ref[f"b/{case}/{i}"], **MODEL_TOL["float32"])


def test_decode_over_data2_model2_matches_the_reference(runs):
    """(h): prefill and two decode steps under the 2 x 2 mesh, decode's
    tokens split over model by the rows of the global batch (the
    reference's ``P("model")``), capacity sized from them, with drops."""
    ref, train, _ = runs
    for i, got in enumerate(train["h"]["decode"]):
        np.testing.assert_allclose(_np(got), ref[f"h/decode/{i}"], **MODEL_TOL["float32"])


def test_odd_length_gradients_over_data2_model2_match_the_reference(runs):
    """(h): an odd length splits the global batch over model in training
    too; the gathered rows' backward sums over the batch group."""
    ref, train, _ = runs
    port = train["h"]
    np.testing.assert_allclose(port["loss"], ref["h/loss"], rtol=LOSS_RTOL["float32"])
    assert _leaf_errors(port["grads"], [ref[f"h/grads/{i}"]
                                        for i in range(len(port["grads"]))]) == []


def test_fallback_gradients_match_the_reference(runs):
    """The fallback with grad: the experts all-gathered, the router and
    shared leaves' shares summed over model."""
    ref, _, serve = runs
    port = serve["fallback_grads"]
    np.testing.assert_allclose(port["loss"], ref["b/fallback_loss"],
                               rtol=LOSS_RTOL["float32"])
    assert _leaf_errors(port["grads"], [ref[f"b/fallback_grads/{i}"]
                                        for i in range(len(port["grads"]))]) == []


def test_checkpoint_over_the_mesh_holds_every_expert(runs):
    """``train_lm(mesh=, ckpt=)``: rank 0 writes the whole tree, the experts
    gathered over model, in the reference's format (read by its
    ``load_checkpoint``)."""
    _, _, serve = runs
    want = serve["trained"]
    got = jax_load_checkpoint(serve["ckpt"], _like(want))
    want_leaves, got_leaves = _spec_leaves(want), _spec_leaves(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    cfg = jobs.moe_cfg()
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        if path[-1].startswith("experts_"):
            assert g.shape[1] == cfg.num_experts, path
        np.testing.assert_array_equal(_np(g), _np(w))


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    return jnp.zeros(tree.shape, jnp.bfloat16 if tree.dtype == torch.bfloat16
                     else jnp.float32)


# ---------------------------------------------------------------------------
# (d) the spec rules
# ---------------------------------------------------------------------------
class _Duck:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


DUCKS = {"16x16": _Duck(data=16, model=16), "2x16x16": _Duck(pod=2, data=16, model=16),
         "2x2": _Duck(data=2, model=2)}


def _shape_tree(name):
    cfg = jax_get_config(name)
    if cfg.family == "dit_moe":
        return jax.eval_shape(lambda k: jax_init_dit(k, cfg), jax.random.PRNGKey(0))
    return jax.eval_shape(lambda k: jax_get_model(cfg).init(k, cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", CONFIGS)
def test_spec_rules_match_the_reference(name):
    shapes = _shape_tree(name)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for duck in DUCKS.values():
        want = jax.tree_util.tree_leaves(jax_sharding.tree_param_specs(shapes, duck),
                                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = shard_lib.tree_param_specs(shapes, duck)
        got_leaves = [s for _, s in _spec_leaves(got)]
        assert len(got_leaves) == len(want) == len(flat)
        for (path, leaf), g, w in zip(flat, got_leaves, want):
            assert g == tuple(w), (jax.tree_util.keystr(path), g, w)
            assert shard_lib.opt_state_spec(g, leaf.shape, duck) == \
                tuple(jax_sharding.opt_state_spec(w, leaf.shape, duck))
            spath = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            assert shard_lib.param_spec(spath, leaf.shape, duck) == g
        assert shard_lib.batch_spec(duck) == jax_sharding.batch_spec(duck)
        assert mesh_lib.batch_axes(duck) == jax_mesh.batch_axes(duck)
        assert mesh_lib.data_axis_size(duck) == jax_mesh.data_axis_size(duck)
        assert mesh_lib.model_axis_size(duck) == jax_mesh.model_axis_size(duck)


def _spec_leaves(tree, path=()):
    """(path, spec) of a port spec tree in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _spec_leaves(v, path + (i,))]
    return [(path, tree)]


def test_lm_expert_helpers_cut_and_gather_dim_1():
    """``shard_lm_experts`` cuts the stacked (L, E, d, f) leaves on dim 1 (not
    the layer axis ``ep_shard_params`` cuts); the predicates name the
    experts and the token-local leaves."""
    mesh = mesh_lib.TrainMesh(rank=3, data=2, model=2)
    assert (mesh.rank_in("data"), mesh.rank_in("model"), mesh.lane) == (1, 1, 1)
    params = {"layers": {"moe": {"experts_gate": torch.arange(24.).view(2, 4, 3),
                                 "router": torch.ones(3, 4)}},
              "embed": torch.zeros(2)}
    got = shard_lib.shard_lm_experts(params, mesh)
    assert torch.equal(got["layers"]["moe"]["experts_gate"],
                       params["layers"]["moe"]["experts_gate"][:, 2:])
    assert got["layers"]["moe"]["router"] is params["layers"]["moe"]["router"]
    assert shard_lib.is_lm_expert(".layers.moe.experts_down")
    assert not shard_lib.is_lm_expert(".layers.moe.router")
    assert shard_lib.is_lm_token_local("layers/moe/shared_up")
    assert shard_lib.is_lm_token_local(".layers.moe.router")
    assert not shard_lib.is_lm_token_local(".layers.attn.wq")
    with pytest.raises(ValueError, match="divide"):
        shard_lib.lm_expert_slice(5, mesh)


# ---------------------------------------------------------------------------
# (e) the factories on a one-rank world
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 2), (4, 1), (2, 4)])
def test_make_local_mesh_clamps_as_the_reference(shape):
    assert len(jax.devices()) == 1
    want = jax_mesh.make_local_mesh(*shape)
    got = mesh_lib.make_local_mesh(*shape, device="cpu")
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.ep_mesh is None and got.world_size == 1
    x = torch.arange(6.)
    assert got.batch_mean(x) is x and got.model_sum(x) is x


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_raises_on_a_one_rank_world(multi_pod):
    with pytest.raises(ValueError):
        jax_mesh.make_production_mesh(multi_pod=multi_pod)
    shape = "(2, 16, 16)" if multi_pod else "(16, 16)"
    with pytest.raises(ValueError, match=re.escape(shape) + ".*world size 1"):
        mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_spawn_builds_the_training_mesh_only_when_it_divides():
    with pytest.raises(ValueError, match="training mesh"):
        mesh_lib.spawn(jobs.serve_case, 4, data=3, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="training mesh"):
        mesh_lib.spawn(jobs.serve_case, 4, model=2, dp=2, backend="gloo", device="cpu")


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------
def test_cli_mesh_local_prints_the_losses_of_no_mesh(capsys):
    argv = ["--arch", jobs.MOE, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16"]
    out = {}
    for mesh in ("none", "local"):
        train_cli.main(argv + ["--mesh", mesh])
        out[mesh] = re.findall(r"loss (\S+)\s+gnorm (\S+)", capsys.readouterr().out)
    assert len(out["none"]) == 2 and out["local"] == out["none"]
    with pytest.raises(ValueError, match="world size 1"):
        train_cli.main(argv + ["--mesh", "prod"])
