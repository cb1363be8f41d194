"""Tensor parallelism: the dense and MoE LMs' training step with every
leaf cut by the reference's ``param_spec`` over ``model`` and the AdamW
moments cut over ``data`` by ``opt_state_spec`` (ZeRO), under the reference
dry run's layout options, on gloo ranks, against the reference's step
under the same specs on forced XLA host devices.

Two reference subprocesses (4 forced devices; one a mesh) run, in f32,
for the smoke configs of qwen3-32b, gemma2-9b (windows, softcaps,
post-norms, embedding scale) and qwen3-moe-30b-a3b (``capacity_factor``
1.0), on
``make_local_mesh(2, 2)`` and ``make_local_mesh(1, 4)`` (where the 2 kv
heads do not divide over ``model``), under each option set of its
``make_step`` (none, ``seq_shard``, ``attn_shard`` = ``"heads"``,
``attn_seq`` = ``"seq"``, ``seq_shard`` + ``attn_seq``): ``value_and_grad``
of ``loss_fn`` with params placed by ``tree_param_specs``, the clip and
AdamW with moments placed by ``opt_state_spec``, from zero moments at step
10 of the cosine schedule.  The port runs the same on two spawns of 4 gloo
ranks (``tests/torch_tp_jobs.py``).  Held: the loss by ``LOSS_RTOL``, every
gradient leaf, the clipped norm and every updated param by ``GRAD_TOL``
(``tests/test_torch_lm_train.py``, with their reasons), all gathered over
``model``; ZeRO's params bit for bit the step's without it; three planted
faults rejected.  The reference's ``_moe_block`` raises under this JAX
(ROADMAP C.11); the subprocess wraps ``jax.lax.pmean`` as
``tests/test_torch_train_mesh.py`` does.

Besides, on one process: the flash kernels' plain versions at a query
offset (the ``"seq"`` layout's rows of a sequence) against the reference's
``layers.attention`` and its ``jax.vjp``, the forward's log-sum-exp and the
autograd path included; the spec cuts, the bridge's cut and the ZeRO dims.

Time limits: each reference subprocess 300 s, each spawn 120 s.  About
70 s of wall time: the reference's two processes of 15 compiles (about
55 s each) beside the port's two spawns (about 20 s each).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_jobs as jobs
from repro.common import sharding as jax_sharding
from repro.configs import get_smoke as jax_get_smoke
from repro.models import layers as jax_layers
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.common import sharding as shard_lib
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import get_model
from test_torch_lm_train import GRAD_TOL, LOSS_RTOL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TIMEOUT_S = 300
RANK_TIMEOUT_S = 120
STEP0, TOTAL = 10, 100          # lr 1.5e-4 at the step (warm-up of 20)
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# which mesh's spawn plants which faults
MESH_FAULTS = {"2x2": ("ln_not_summed", "offset_dropped"), "1x4": ("kv_heads_mod",)}
CASES = [(m, c, o) for m in MESHES for c in jobs.CONFIGS for o in jobs.OPTIONS]

REF_PROG = textwrap.dedent("""
    import os, sys, json
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
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.common.sharding import opt_state_spec, tree_param_specs
    from repro.configs import get_smoke
    from repro.launch.mesh import batch_axes, make_local_mesh
    from repro.models.api import get_model
    from repro.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                   clip_by_global_norm, cosine_schedule)

    inp = dict(np.load(sys.argv[1]))
    step0, total = (int(v) for v in inp.pop("consts"))
    spec = json.loads(sys.argv[3])
    out = {}
    for name in spec["configs"]:
        cfg = get_smoke(name)
        if cfg.is_moe:
            cfg = cfg.replace(capacity_factor=1.0)
        api = get_model(cfg)
        params = api.init(jax.random.PRNGKey(spec["seeds"][name]), cfg,
                          dtype=jnp.float32)
        b = {"tokens": jnp.asarray(inp[name + "/tokens"]),
             "labels": jnp.asarray(inp[name + "/labels"])}
        for mname, shape in spec["meshes"].items():
            mesh = make_local_mesh(*shape)
            ns = lambda s: NamedSharding(mesh, s)
            pspecs = tree_param_specs(params, mesh)
            ospecs = jax.tree.map(lambda s, a: opt_state_spec(s, a.shape, mesh),
                                  pspecs, params,
                                  is_leaf=lambda x: isinstance(x, P))
            psh = jax.tree.map(ns, pspecs, is_leaf=lambda x: isinstance(x, P))
            osh = AdamWState(step=ns(P()),
                             mu=jax.tree.map(ns, ospecs, is_leaf=lambda x: isinstance(x, P)),
                             nu=jax.tree.map(ns, ospecs, is_leaf=lambda x: isinstance(x, P)))
            bsh = {k: ns(P(batch_axes(mesh))) for k in b}
            for oname, kw in spec["options"].items():
                kw = dict(kw, mesh=mesh, batch_axes=batch_axes(mesh))

                def step(params, opt, b):
                    loss, grads = jax.value_and_grad(
                        lambda p: api.loss_fn(p, b, cfg, **kw)[0])(params)
                    clipped, gnorm = clip_by_global_norm(grads, 1.0)
                    lr = cosine_schedule(opt.step, base_lr=3e-4, warmup=20,
                                         total=total)
                    new, _ = adamw_update(clipped, opt, params, lr=lr)
                    return loss, grads, gnorm, new

                opt = adamw_init(params)._replace(step=jnp.asarray(step0, jnp.int32))
                loss, grads, gnorm, new = jax.jit(
                    step, in_shardings=(psh, osh, bsh))(params, opt, b)
                key = f"{mname}/{name}/{oname}"
                out[key + "/loss"], out[key + "/gnorm"] = np.asarray(loss), np.asarray(gnorm)
                for i, leaf in enumerate(jax.tree_util.tree_leaves(grads)):
                    out[f"{key}/grads/{i}"] = np.asarray(leaf)
                for i, leaf in enumerate(jax.tree_util.tree_leaves(new)):
                    out[f"{key}/params/{i}"] = np.asarray(leaf)
    np.savez(sys.argv[2], **out)
""")

SEEDS = {name: i for i, name in enumerate(jobs.CONFIGS)}


def _np(x):
    return x.detach().to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _leaf_errors(got, want, paths):
    rel, floor = GRAD_TOL["float32"]
    assert len(got) == len(want)
    out = []
    for path, g, w in zip(paths, got, want):
        g, w = _np(g), np.asarray(w, np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        bound = rel * np.abs(w).max() + floor
        err = float(np.abs(g - w).max())
        if not err <= bound:
            out.append((path, err, bound))
    return out


def _step_errors(port, ref_out, key):
    """What of one step's comparison fails: loss, gradient leaves, clipped
    norm, updated params."""
    n = len(port["grads"])
    errs = {}
    if not np.isclose(port["loss"], ref_out[key + "/loss"], rtol=LOSS_RTOL["float32"],
                      atol=0):
        errs["loss"] = (port["loss"], float(ref_out[key + "/loss"]))
    if bad := _leaf_errors(port["grads"], [ref_out[f"{key}/grads/{i}"] for i in range(n)],
                           port["paths"]):
        errs["grads"] = bad
    rel, floor = GRAD_TOL["float32"]
    gn = float(ref_out[key + "/gnorm"])
    if not abs(port["gnorm"] - gn) <= rel * gn + floor:
        errs["gnorm"] = (port["gnorm"], gn)
    if bad := _leaf_errors(port["params"], [ref_out[f"{key}/params/{i}"] for i in range(n)],
                           port["paths"]):
        errs["params"] = bad
    return errs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the port's two spawns, side by side."""
    import json
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(31)
    arrays, batches, trees = {}, {}, {}
    for name in jobs.CONFIGS:
        cfg = jax_get_smoke(name)
        t = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        batches[name] = {"tokens": t, "labels": np.roll(t, -1, 1)}
        arrays[name + "/tokens"], arrays[name + "/labels"] = t, batches[name]["labels"]
        if cfg.is_moe:
            cfg = cfg.replace(capacity_factor=1.0)
        trees[name] = jax.device_get(jax_get_model(cfg).init(
            jax.random.PRNGKey(SEEDS[name]), cfg, dtype=jnp.float32))
    np.savez(d / "in.npz", consts=np.asarray([STEP0, TOTAL]), **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    # one reference process a mesh (15 compiles each), side by side
    procs = {m: subprocess.Popen(
        [sys.executable, "-c", REF_PROG, str(d / "in.npz"), str(d / f"ref{m}.npz"),
         json.dumps({"configs": list(jobs.CONFIGS), "seeds": SEEDS,
                     "meshes": {m: shape}, "options": jobs.OPTIONS})],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for m, shape in MESHES.items()}
    try:
        port = {}
        for mname, (data, model) in MESHES.items():
            port[mname], _ = mesh_lib.spawn(
                jobs.tp_case, 4, data=data, model=model, backend="gloo", device="cpu",
                timeout_s=RANK_TIMEOUT_S,
                args=(trees, batches, STEP0, TOTAL, MESH_FAULTS[mname]))
        errs = {m: p.communicate(timeout=REF_TIMEOUT_S)[1] for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    ref_out = {}
    for m, p in procs.items():
        assert p.returncode == 0, errs[m][-4000:]
        with np.load(d / f"ref{m}.npz") as f:
            ref_out.update({k: f[k] for k in f.files})
    return ref_out, port


@pytest.mark.parametrize("mesh,name,opt", CASES, ids=["-".join(c) for c in CASES])
def test_tp_step_matches_the_reference_sharded_step(runs, mesh, name, opt):
    """Loss, every gradient leaf, the clipped norm and the params after one
    AdamW step, the port's gathered over ``model``."""
    ref_out, port = runs
    assert port[mesh]["shape"] == dict(zip(("data", "model"), MESHES[mesh]))
    got = port[mesh][f"{name}/{opt}"]
    assert _step_errors(got, ref_out, f"{mesh}/{name}/{opt}") == {}
    assert float(ref_out[f"{mesh}/{name}/{opt}/gnorm"]) > 1.0     # the clip acts


@pytest.mark.parametrize("mesh,name,opt", CASES, ids=["-".join(c) for c in CASES])
def test_zero_step_is_bit_identical_to_the_step_without_it(runs, mesh, name, opt):
    """Each rank updates its ``data`` slice of a leaf whose moments
    ``opt_state_spec`` cuts and all-gathers the param: the same bits on
    every rank as whole moments give (on 1 x 4 nothing is cut)."""
    _, port = runs
    got = port[mesh][f"{name}/{opt}"]
    assert got["zero_same"] == [True] * 4
    assert got["zero_cut"] == (MESHES[mesh][0] > 1)


@pytest.mark.parametrize("fault", sorted(jobs.FAULTS))
def test_planted_faults_fail_the_step_comparison(runs, fault):
    """The norms' gradients under ``seq_shard`` not summed over ``model``,
    the ``"seq"`` layout's query offset dropped, GQA's kv heads mapped as
    h % KVH: each fails its step's comparison in the gradients."""
    ref_out, port = runs
    mesh = next(m for m, faults in MESH_FAULTS.items() if fault in faults)
    name, opt, _ = jobs.FAULTS[fault]
    errs = _step_errors(port[mesh][f"fault/{fault}"], ref_out, f"{mesh}/{name}/{opt}")
    assert "grads" in errs, fault


def test_the_step_is_the_same_on_every_data_lane_and_option(runs):
    """The dense configs compute one function whatever the mesh and the
    options: their losses agree to ``LOSS_RTOL`` across all ten runs."""
    _, port = runs
    for name in ("qwen3-32b", "gemma2-9b"):
        losses = [port[m][f"{name}/{o}"]["loss"] for m in MESHES for o in jobs.OPTIONS]
        np.testing.assert_allclose(losses, losses[0], rtol=LOSS_RTOL["float32"])


# ---------------------------------------------------------------------------
# the flash kernels' plain versions at a query offset
# ---------------------------------------------------------------------------
ATTN_CASES = {
    "causal": dict(causal=True),
    "window-softcap": dict(causal=True, window=5, softcap=20.0),
    "gqa-noncausal": dict(causal=False),
}


def _attn_inputs(seed, B=2, S=16, H=4, KVH=2, Dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    do = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("parts", [2, 4])
def test_offset_plain_versions_match_the_reference_attention(case, parts):
    """The sequence's queries cut into ``parts`` row blocks, each at its
    ``q_offset`` against every key: the plain forward (output, log-sum-exp)
    and backward (dq of the block, its share of dk and dv) put back
    together equal the reference's ``layers.attention`` and ``jax.vjp``."""
    kw = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(7)
    S = q.shape[1]
    win = kw.get("window")
    jwin = None if win is None else jnp.int32(win)
    f = lambda a, b, c: jax_layers.attention(  # noqa: E731
        a, b, c, causal=kw["causal"], window=jwin, softcap=kw.get("softcap"))
    want_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    n = S // parts
    dq = torch.empty_like(tq)
    dk, dv = torch.zeros_like(tk), torch.zeros_like(tv)
    for i in range(parts):
        rows = slice(i * n, (i + 1) * n)
        o, lse = ref.flash_attention_ref(
            tq[:, rows], tk, tv, causal=kw["causal"], window=win,
            softcap=kw.get("softcap"), q_offset=i * n, one_sided_window=True, stats=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o)[:, rows], rtol=1e-5, atol=1e-5)
        s = np.einsum("bqhd,bkhd->bhqk", q[:, rows],
                      np.repeat(k, q.shape[2] // k.shape[2], axis=2)) / np.sqrt(q.shape[3])
        if "softcap" in kw:
            s = kw["softcap"] * np.tanh(s / kw["softcap"])
        mask = ref.attention_mask(n, S, causal=kw["causal"], window=win, device="cpu",
                                  q_offset=i * n, one_sided=True).numpy()
        s = np.where(mask, s, -1e30)
        m = s.max(-1, keepdims=True)
        np.testing.assert_allclose(lse.numpy(), (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0],
                                   rtol=1e-5, atol=1e-5)
        g = ref.flash_attention_bwd_ref(
            tq[:, rows], tk, tv, o, lse, tdo[:, rows], causal=kw["causal"], window=win,
            softcap=kw.get("softcap"), q_offset=i * n)
        dq[:, rows] = g[0]
        dk += g[1]
        dv += g[2]
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_offset_autograd_runs_the_plain_backward_and_drops_the_offset_fault():
    """``ops.flash_attention`` with grad at a query offset goes through
    ``FlashAttentionFn`` (whose backward took no offset before) and gives
    the plain backward's gradients; the same rows at offset 0 give other
    ones (the planted fault the chip's phase 19a rejects)."""
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(8))
    rows, off = slice(8, 16), 8
    qr = q[:, rows].clone().requires_grad_()
    kk, vv = k.clone().requires_grad_(), v.clone().requires_grad_()
    o = ops.flash_attention(qr, kk, vv, causal=True, q_offset=off, one_sided_window=True)
    got = torch.autograd.grad(o, [qr, kk, vv], do[:, rows])
    o32, lse = ref.flash_attention_ref(q[:, rows], k, v, causal=True, q_offset=off,
                                       one_sided_window=True, stats=True)
    want = ref.flash_attention_bwd_ref(q[:, rows], k, v, o32, lse, do[:, rows],
                                       causal=True, q_offset=off)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    wrong = ref.flash_attention_bwd_ref(q[:, rows], k, v, o32, lse, do[:, rows], causal=True)
    assert not torch.allclose(wrong[1], want[1], atol=1e-3)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention_bwd(q, k, v, o32, lse, do, q_offset=-1)


# ---------------------------------------------------------------------------
# the cuts
# ---------------------------------------------------------------------------
class _Duck:
    def __init__(self, rank=0, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.model = shape.get("model", 1)
        self._rank = rank

    def rank_in(self, axis):
        names = list(self.axis_names)
        i = names.index(axis)
        inner = int(np.prod([self.shape[a] for a in names[i + 1:]]))
        return (self._rank // inner) % self.shape[axis]


@pytest.mark.parametrize("name", jobs.CONFIGS)
@pytest.mark.parametrize("shape", [dict(data=2, model=2), dict(data=1, model=4)])
def test_spec_cuts_bridge_and_zero_dims_follow_the_reference_specs(name, shape):
    """``shard_lm_params`` cuts each leaf on the dim of the reference's
    ``param_spec`` (the ranks' slices concatenate to the leaf),
    ``bridge.from_jax_params(mesh=)`` gives the same slices from numpy,
    ``param_cuts`` finds them, and ``lm_moment_dims`` is
    ``opt_state_spec``'s ``data`` dim."""
    from repro_torch.models import dense
    cfg = jobs.config(name)
    tree = jax.device_get(jax_get_model(cfg).init(jax.random.PRNGKey(3), cfg,
                                                  dtype=jnp.float32))
    whole = bridge.from_jax_params(tree, device="cpu")
    n = shape["model"]
    ranks = [_Duck(rank=r, **shape) for r in range(n)]
    slices = [shard_lib.shard_lm_params(whole, m) for m in ranks]
    specs = jax.tree_util.tree_leaves(
        jax_sharding.tree_param_specs(tree, ranks[0]),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    items = shard_lib.tree_items(whole)
    for j, ((path, leaf), spec) in enumerate(zip(items, specs)):
        parts = [shard_lib.tree_items(s)[j][1] for s in slices]
        if "model" in tuple(spec):
            dim = tuple(spec).index("model")
            assert torch.equal(torch.cat(parts, dim), leaf), path
            assert parts[0].shape[dim] * n == leaf.shape[dim]
        else:
            assert all(p is leaf for p in parts), path
        zero = jax_sharding.opt_state_spec(spec, leaf.shape, ranks[0])
        got = shard_lib.tree_items(shard_lib.lm_moment_dims(whole, ranks[0]))[j][1]
        assert got == (tuple(zero).index("data") if "data" in tuple(zero) else None)
    for m, s in zip(ranks, slices):
        cut = bridge.from_jax_params(tree, device="cpu", mesh=m)
        for (path, a), (_, b) in zip(shard_lib.tree_items(cut), shard_lib.tree_items(s)):
            assert torch.equal(a, b), path
        cuts = dense.param_cuts(s, cfg, m)
        for (path, c), spec in zip(shard_lib.tree_items(cuts), specs):
            assert c == (tuple(spec).index("model") if "model" in tuple(spec) else None), path
    assert get_model(cfg).init(cfg, generator=None)["embed"].shape == whole["embed"].shape
