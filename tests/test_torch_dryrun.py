"""The port's dry run (``launch/dryrun.py``), its step cost analysis
(``launch/hlo_cost.analyze_step``, ``hetero_wire_seconds``), the kernels'
work formulas and ``meta`` wrappers (``kernels/cost.py``, ``kernels/ops.py``),
the abstract init of every family, and ``launch/roofline_report.py``, against
the reference where it has a counterpart.

Against the reference's dry run: one subprocess lowers
``repro.launch.dryrun.make_step`` on a hand-made 2 x 4 ``("data", "model")``
mesh of 8 forced XLA host devices (C.11's ``pmean`` wrapped as in
``tests/test_torch_train_mesh.py``), for the qwen3-moe and qwen3-32b smoke
configs at small train, prefill and decode shapes; another runs the port's
``run_one`` for the same combos over a fake world of 8 ranks.  Exact:

* ``spec_argument_bytes`` (the arguments under the reference's specs) is
  the compiled step's ``memory_analysis().argument_size_in_bytes``;
* the MoE train step's all-to-alls (count and bytes a rank) are the
  reference's in its layer loops, counted with the loop multipliers
  ``repro.launch.hlo_cost`` applies (and its halving of the f32 payloads
  the CPU backend upcasts from bf16).  XLA's partitioner adds reshard
  all-to-alls of its own outside the loops, which the port, placing
  nothing but the experts over ``model``, does not issue;
* ``model_flops_global`` / ``_per_chip``;
* ``hetero_wire_seconds`` of the same totals.

What the port holds: the train steps of the dense and moe families place
every param by its spec and the moments by ``opt_state_spec`` (tensor
parallelism, ZeRO), so their ``memory.argument_bytes`` equals
``spec_argument_bytes`` exactly, on the 2 x 4 combos under every layout
option (``seq_shard``, ``attn_shard``, ``attn_seq``, both) and on the
production rows run here (qwen3-moe under ``seq_shard``, qwen3-32b under
``seq_shard`` + ``attn_seq``).

The production combos run on ``meta`` in subprocesses of their own (a fake
world is one a process).  Time: about 60 s, the subprocesses in parallel.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.common.config import HW, INPUT_SHAPES
from repro_torch.configs import get_smoke
from repro_torch.kernels import cost, ops
from repro_torch.launch import hlo_cost, roofline_report
from repro_torch.launch.train import lm_train_step
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import adamw_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 400
COMBOS = [("qwen3-moe-30b-a3b", "train", 8, 16), ("qwen3-32b", "train", 8, 16),
          ("qwen3-moe-30b-a3b", "prefill", 4, 16), ("qwen3-32b", "prefill", 4, 16),
          ("qwen3-moe-30b-a3b", "decode", 8, 16), ("qwen3-32b", "decode", 8, 16)]
IDS = [f"{a}-{k}" for a, k, _, _ in COMBOS]
# the keys of the reference's record (src/repro/launch/dryrun.py run_one),
# whose lowering and compile times the port's t_trace_s replaces
REF_KEYS = {"arch", "shape", "mesh", "opts", "n_chips", "memory", "roofline",
            "collectives", "loops", "raw_cost_analysis", "model_flops_global",
            "model_flops_per_chip", "useful_flop_ratio"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
REF_ROOFLINE = {"flops", "bytes", "collective_bytes", "t_compute", "t_memory",
                "t_collective", "dominant"}
PRODUCTION = [("qwen3-moe-30b-a3b", "train_4k"), ("dit-moe-g", "dit_serve"),
              ("rwkv6-3b", "decode_32k")]
# production train rows under the layout options, each a process of its own
PRODUCTION_OPTS = [("qwen3-moe-30b-a3b", "seq_shard"), ("qwen3-32b", "seq_shard,attn_seq")]
# the 2 x 4 train combos' layout options
TRAIN_OPTS = ("seq_shard", "attn_shard", "attn_seq", "seq_shard,attn_seq")

REF_PROG = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax

    _pmean = jax.lax.pmean

    def pmean(x, axis_name, **kw):
        # only over the axes where x varies (ROADMAP C.11)
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        axes = tuple(a for a in axes if a in jax.typeof(x).vma)
        return _pmean(x, axes, **kw) if axes else x

    jax.lax.pmean = pmean
    devs = jax.devices()           # 8 devices, before dryrun's import asks 512
    from jax.sharding import Mesh
    from repro.common.config import ShapeConfig
    from repro.configs import get_smoke
    from repro.launch import dryrun, hlo_cost

    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("data", "model"))
    out = {}
    for arch, kind, B, S in json.loads(sys.argv[1]):
        cfg = get_smoke(arch)
        fn, args, in_sh, out_sh = dryrun.make_step(
            cfg, ShapeConfig(kind, S, B, kind), mesh)
        c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(
            *args).compile()
        comps, entry = hlo_cost.parse_module(c.as_text())
        loop = {"count": 0.0, "bytes": 0.0}

        def walk(name, mult, in_loop):
            for op in comps[name].ops:
                if op.is_collective and op.coll_kind == "all-to-all" and in_loop:
                    b = mult * hlo_cost._nbytes(op.result_shapes)
                    if op.result_shapes[0][0] == "f32":
                        b *= 0.5           # analyze's bf16-wire correction
                    loop["count"] += mult
                    loop["bytes"] += b
                if op.kind == "while":
                    for callee in op.calls:
                        walk(callee, mult * op.trip, True)
                elif op.calls and op.kind in ("call", "conditional", "fusion"):
                    for callee in op.calls:
                        walk(callee, mult, in_loop)

        walk(entry, 1.0, False)
        t = hlo_cost.analyze(c.as_text())
        n = cfg.active_param_count()
        mf = {"train": 6 * n * B * S, "prefill": 2 * n * B * S,
              "decode": 2 * n * B}[kind]
        out[arch + "/" + kind] = {
            "argument_bytes": c.memory_analysis().argument_size_in_bytes,
            "loop_a2a": loop, "model_flops_global": mf,
            "model_flops_per_chip": mf / 8,
            "all_a2a": t.collective_counts.get("all-to-all", 0.0)}
    print(json.dumps(out))
""")

PORT_PROG = textwrap.dedent("""
    import sys, json
    from repro_torch.launch import dryrun
    names = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
    out = {}
    for arch, kind, B, S in json.loads(sys.argv[1]):
        r = dryrun.run_one(arch, names[kind], mesh_shape=(2, 4), smoke=True,
                           batch=B, seq=S, verbose=False)
        out[arch + "/" + kind] = r
        if (arch, kind) == ("qwen3-moe-30b-a3b", "train"):
            out[arch + "/train/save_ffn"] = dryrun.run_one(
                arch, "train_4k", mesh_shape=(2, 4), smoke=True, batch=B, seq=S,
                opts=("save_ffn",), verbose=False)
        if kind == "train":
            for opts in json.loads(sys.argv[2]):
                out[arch + "/train/" + opts] = dryrun.run_one(
                    arch, "train_4k", mesh_shape=(2, 4), smoke=True, batch=B, seq=S,
                    opts=tuple(opts.split(",")), verbose=False)
    print(json.dumps(out, default=str))
""")

# one rank: the dry run's memory parts, which a CPU step's trees must equal
ONE_PROG = textwrap.dedent("""
    import json
    from repro_torch.launch import dryrun
    r = dryrun.run_one("qwen3-moe-30b-a3b", "train_4k", mesh_shape=(1, 1),
                       smoke=True, batch=2, seq=16, verbose=False)
    print(json.dumps(r["memory"]))
""")


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return env


def _start(args):
    return subprocess.Popen(args, env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(p):
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
    return p.returncode, out, err


def _last_json(out):
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's 2 x 4 runs, the production combos
    (with and without layout options), all started at once."""
    combos = json.dumps(COMBOS)
    ref = _start([sys.executable, "-c", REF_PROG, combos])
    port = _start([sys.executable, "-c", PORT_PROG, combos, json.dumps(TRAIN_OPTS)])
    prod = {c: _start([sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", c[0], "--shape", c[1], "--quiet"])
            for c in PRODUCTION}
    one = _start([sys.executable, "-c", ONE_PROG])
    out = tmp_path_factory.mktemp("dry") / "rows.jsonl"
    opts = {c: _start([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                       c[0], "--shape", "train_4k", "--opts", c[1], "--out", str(out),
                       "--quiet"]) for c in PRODUCTION_OPTS}
    got = {"ref": _finish(ref), "port": _finish(port),
           "prod": {c: _finish(p) for c, p in prod.items()},
           "opts": {c: _finish(p) for c, p in opts.items()}, "one": _finish(one)}
    got["opt_rows"] = out.read_text().splitlines() if out.exists() else []
    for key in ("ref", "port", "one"):
        rc, stdout, err = got[key]
        assert rc == 0, err[-3000:]
        got[key] = _last_json(stdout)
    return got


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_spec_argument_bytes_equal_the_reference_argument_size(runs, combo):
    key = f"{combo[0]}/{combo[1]}"
    assert runs["port"][key]["spec_argument_bytes"] == runs["ref"][key]["argument_bytes"]


def test_moe_train_all_to_alls_equal_the_reference_exchange(runs):
    key = "qwen3-moe-30b-a3b/train"
    port, ref = runs["port"][key], runs["ref"][key]
    cfg = get_smoke("qwen3-moe-30b-a3b")
    assert port["collective_counts"]["all_to_all"] == ref["loop_a2a"]["count"] \
        == 6 * cfg.num_layers                  # forward, recompute, backward
    assert port["collectives"]["all_to_all"] == ref["loop_a2a"]["bytes"]
    # the reference's partitioner adds reshards beside the exchange
    assert ref["all_a2a"] >= ref["loop_a2a"]["count"]


def test_save_ffn_dry_run_issues_four_all_to_alls_per_moe_layer(runs):
    """Under ``save_ffn`` the recompute takes the exchange's received
    buffers from the selective checkpoint's cache, which answers before
    the analysis' dispatch mode: 4 all-to-alls a layer, not 6."""
    key = "qwen3-moe-30b-a3b/train"
    full, save = runs["port"][key], runs["port"][key + "/save_ffn"]
    layers = get_smoke("qwen3-moe-30b-a3b").num_layers
    assert save["collective_counts"]["all_to_all"] == 4 * layers
    assert 6 * save["collectives"]["all_to_all"] == 4 * full["collectives"]["all_to_all"]


def test_dry_run_memory_parts_are_a_cpu_step_s_trees(runs):
    """The dry run's parameter, gradient and AdamW bytes (a 1 x 1 mesh) are
    those of the trees a CPU step makes: the gradients measured, not
    assumed to be the parameters' size."""
    from repro_torch.launch.train import lm_grads
    cfg = get_smoke("qwen3-moe-30b-a3b")
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    _, grads = lm_grads(params, {"tokens": tokens, "labels": tokens}, cfg)
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in _leaf_tensors(tree))
    mem = runs["one"]
    assert (mem["param_bytes"], mem["grad_bytes"], mem["opt_bytes"]) == \
        (nbytes(params), nbytes(grads), nbytes(adamw_init(params)))
    assert mem["grad_bytes"] > 0


def _leaf_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaf_tensors(v)]
    if isinstance(tree, (list, tuple)):            # AdamWState too
        return [t for v in tree for t in _leaf_tensors(v)]
    return []


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_model_flops_equal_the_reference(runs, combo):
    key = f"{combo[0]}/{combo[1]}"
    for k in ("model_flops_global", "model_flops_per_chip"):
        assert runs["port"][key][k] == runs["ref"][key][k]


def test_the_port_holds_what_it_places(runs):
    """The train steps hold exactly the reference's layout (every param by
    its spec, the moments by ``opt_state_spec``), under every layout
    option; the serving steps, which place only the routed experts over
    ``model``, hold at least it."""
    train = [k for k in runs["port"] if "/train" in k]
    assert len(train) == 2 * (2 + len(TRAIN_OPTS)) - 1      # save_ffn: qwen3-moe only
    for key, r in runs["port"].items():
        if "/train" in key:
            assert r["memory"]["argument_bytes"] == r["spec_argument_bytes"], key
        else:
            assert r["memory"]["argument_bytes"] >= r["spec_argument_bytes"], key
        assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"], key


# ---------------------------------------------------------------------------
# hetero_wire_seconds against the reference on the same totals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fabric", [
    dict(n_dev=16, link_bw=450e9),
    dict(n_dev=16, link_bw=450e9, devices_per_host=8, inter_host_bw=50e9),
    dict(n_dev=8, link_bw=450e9, devices_per_host=4, inter_host_bw=50e9,
         hop_schedule=(1, 3, 2, 4, 5, 7, 6)),
    dict(n_dev=6, link_bw=450e9, devices_per_host=4, inter_host_bw=50e9),
], ids=["flat", "two-tier", "two-tier-ring-order", "uneven-hosts"])
def test_hetero_wire_seconds_equals_the_reference(fabric):
    from repro.launch import hlo_cost as ref_cost
    coll = {"all_to_all": 3.5e9, "all_reduce": 1.25e9, "all_gather": 7.0e8,
            "send": 4.2e8}
    counts = {"all_to_all": 96.0, "all_reduce": 17.0, "all_gather": 12.0,
              "send": 14.0}
    names = {"all_to_all": "all-to-all", "all_reduce": "all-reduce",
             "all_gather": "all-gather", "send": "collective-permute"}
    got = hlo_cost.hetero_wire_seconds(
        hlo_cost.CostTotals(collective_bytes=dict(coll), collective_counts=dict(counts)),
        **fabric)
    want = ref_cost.hetero_wire_seconds(
        ref_cost.CostTotals(collective_bytes={names[k]: v for k, v in coll.items()},
                            collective_counts={names[k]: v for k, v in counts.items()}),
        **fabric)
    assert got == {k: want[names[k]] for k in coll}


# ---------------------------------------------------------------------------
# analyze_step: meta against real CPU tensors
# ---------------------------------------------------------------------------
def _train_args(cfg, device):
    api = get_model(cfg)
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    params = api.init(cfg, generator=gen)
    make = (lambda sh, dt: torch.empty(sh, dtype=dt, device="meta")) \
        if device == "meta" else (lambda sh, dt: torch.ones(sh, dtype=dt))
    batch = {"tokens": make((2, 16), torch.int32), "labels": make((2, 16), torch.int32)}
    for name, shape, dtype in api.extra_inputs:
        batch[name] = make(shape(cfg, 2), dtype)
    return params, adamw_init(params), batch


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-3b", "gemma2-9b"])
def test_analyze_step_is_the_same_on_meta_and_cpu(name, monkeypatch):
    """A smoke train step counts the same aten FLOPs and bytes, kernel
    calls and peak on ``meta`` as on real CPU tensors, with the kernel
    wrappers stubbed the same way on both sides: their ``meta`` branch,
    which allocates the card's buffers and records the work (on the CPU
    the buffers stay unwritten, so the values are not compared)."""
    cfg = get_smoke(name)
    monkeypatch.setattr(ops, "_costed", lambda t: t.device.type in ("meta", "cpu"))
    totals = {}
    for device in ("meta", "cpu"):
        args = _train_args(cfg, device)
        launches = dict(ops.LAUNCHES)
        _, totals[device] = hlo_cost.analyze_step(
            lambda p, o, b: lm_train_step(p, o, b, cfg, total=10), *args)
        assert ops.LAUNCHES == launches          # the card's counts only
    m, c = totals["meta"], totals["cpu"]
    for key in ("flops", "bytes", "aten_flops", "aten_bytes", "argument_bytes",
                "output_bytes", "peak_bytes", "collective_bytes"):
        assert getattr(m, key) == getattr(c, key), key
    assert m.kernels == c.kernels and m.kernels
    assert m.peak_bytes > m.argument_bytes > 0


# ---------------------------------------------------------------------------
# the kernels' work formulas and their meta wrappers
# ---------------------------------------------------------------------------
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ledger(fn):
    first = len(cost.LEDGER)
    out = fn()
    rows = cost.LEDGER[first:]
    del cost.LEDGER[first:]
    return out, rows


def test_cost_formulas_reproduce_the_documented_counts():
    """PERF.md's kernel tables: ``expert_ffn`` at XL's refresh shape is
    1.6307e11 FLOP; qwen3-32b's causal flash backward (8, 128, 64 over 8
    heads, 128) bf16 is 5.41e9 FLOP over 92.5 MB; qwen3-moe's bf16
    ``expert_ffn_bwd`` moves 2.54 GB."""
    assert cost.expert_ffn_flops(8, 640, 1152, 4608) == pytest.approx(1.6307e11, rel=1e-4)
    q, o, do = _meta(8, 128, 64, 128), _meta(8, 128, 64, 128, dtype=torch.float32), \
        _meta(8, 128, 64, 128)
    k, v = _meta(8, 128, 8, 128), _meta(8, 128, 8, 128)
    lse = _meta(8, 64, 128, dtype=torch.float32)
    _, (row,) = _ledger(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    assert row.name == "flash_attention_bwd"
    assert row.flops == pytest.approx(5.41e9, rel=1e-3)
    assert row.bytes == pytest.approx(92.5e6, rel=1e-3)
    E, C, d, f = 128, 80, 2048, 768
    _, (row,) = _ledger(lambda: ops.expert_ffn_bwd(
        _meta(E, C, d), _meta(E, d, f), _meta(E, d, f), _meta(E, f, d), _meta(E, C, d)))
    assert row.bytes == pytest.approx(2.54e9, rel=2e-3)
    assert row.flops == 12.0 * E * C * d * f
    assert cost.kept_pairs(4, 4, causal=True) == 10
    assert cost.kept_pairs(6, 6, causal=True, window=2, one_sided_window=True) == 11
    assert cost.kept_pairs(1, 8, causal=True, q_offset=7) == 8


def test_kernel_wrappers_on_meta_allocate_and_record_without_launching():
    launches = dict(ops.LAUNCHES)
    buf, wg, wd = _meta(4, 8, 16), _meta(4, 16, 24), _meta(4, 24, 16)
    y, rows = _ledger(lambda: ops.expert_ffn(buf, wg, wg, wd))
    assert (y.shape, y.dtype, y.device.type) == ((4, 8, 16), torch.bfloat16, "meta")
    assert [r.name for r in rows] == ["expert_ffn"]
    q, kv = _meta(2, 16, 4, 32), _meta(2, 16, 2, 32)
    (o, lse, o32), rows = _ledger(lambda: ops._flash_attention_fwd(
        q, kv, kv, causal=True, want_lse=True))
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (2, 4, 16) and o32.dtype == torch.float32
    assert rows[0].flops == cost.flash_flops(2, 4, 32, 16 * 17 // 2)
    (q8, scale, recon), rows = _ledger(lambda: ops.residual_int8(
        _meta(8, 64, dtype=torch.float32), _meta(8, 64, dtype=torch.float32)))
    assert (q8.dtype, scale.shape, recon.shape) == (torch.int8, (8, 1), (8, 64))
    r = _meta(2, 3, 5, 16)
    u, s0 = _meta(3, 16, dtype=torch.float32), _meta(2, 3, 16, 16, dtype=torch.float32)
    (out, sT), _ = _ledger(lambda: ops.rwkv6_scan(r, r, r, r, u, s0))
    assert out.dtype == torch.float32 and sT.shape == (2, 3, 16, 16)
    grads, rows = _ledger(lambda: ops.rwkv6_scan_bwd(
        r, r, r, r, u, s0, _meta(2, 3, 5, 16, dtype=torch.float32)))
    assert [g.shape for g in grads] == [r.shape] * 4 + [u.shape, s0.shape]
    assert [r_.name for r_ in rows] == ["rwkv6_scan_bwd"]
    assert ops.LAUNCHES == launches


# ---------------------------------------------------------------------------
# the abstract init of every family
# ---------------------------------------------------------------------------
FAMILIES = ["qwen3-moe-30b-a3b", "gemma2-9b", "rwkv6-3b", "zamba2-7b",
            "seamless-m4t-large-v2", "llama-3.2-vision-11b", "dit-moe-xl"]


def _leaf_meta(tree, names=()):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_leaf_meta(v, names + (k,)))
        return out
    return {names: (tuple(tree.shape), tree.dtype, tree.device.type)}


@pytest.mark.parametrize("name", FAMILIES)
def test_abstract_init_matches_a_seeded_init_leaf_by_leaf(name):
    cfg = get_smoke(name)
    init = get_model(cfg).init
    abstract = _leaf_meta(init(cfg, generator=None))
    seeded = _leaf_meta(init(cfg, generator=torch.Generator().manual_seed(0)))
    assert abstract.keys() == seeded.keys()
    for k in seeded:
        assert abstract[k] == seeded[k][:2] + ("meta",), k


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-3b", "zamba2-7b",
                                  "llama-3.2-vision-11b"])
def test_init_cache_on_meta_matches_the_cpu_cache(name):
    cfg = get_smoke(name)
    make = get_model(cfg).init_cache
    got, want = make(cfg, 2, 8, device="meta"), make(cfg, 2, 8, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert (got[k].shape, got[k].dtype, got[k].device.type) == \
                (want[k].shape, want[k].dtype, "meta")
        else:
            assert got[k] == want[k]


# ---------------------------------------------------------------------------
# production combos, the error row, the report
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("combo", PRODUCTION, ids=[c[0] for c in PRODUCTION])
def test_production_combos_give_the_reference_record_keys(runs, combo):
    rc, out, err = runs["prod"][combo]
    assert rc == 0, err[-3000:]
    r = _last_json(out)
    assert REF_KEYS <= r.keys() and "t_trace_s" in r
    assert REF_MEMORY <= r["memory"].keys() and REF_ROOFLINE <= r["roofline"].keys()
    assert r["fits"] == (r["memory"]["peak_bytes"] <= HW.hbm_bytes)
    assert r["mesh"] == "16x16" and r["n_chips"] == 256
    assert r["roofline"]["flops"] > 0 and r["kernels"]
    assert "not measured" in r["roofline"]["modeled"]


@pytest.mark.parametrize("combo", PRODUCTION_OPTS, ids=[f"{a}-{o}" for a, o in PRODUCTION_OPTS])
def test_layout_options_give_production_rows_holding_the_reference_layout(runs, combo):
    """``seq_shard`` and ``attn_seq`` (once refused with an error row) give a
    record on 16 x 16, written to ``--out``, whose arguments are the
    reference's placement to the byte; the sequence-sharded residuals
    reduce-scatter over ``model``."""
    rc, out, err = runs["opts"][combo]
    assert rc == 0, err[-3000:]
    r = _last_json(out)
    assert r["opts"] == combo[1].split(",") and r["mesh"] == "16x16"
    assert "error" not in r
    assert r["memory"]["argument_bytes"] == r["spec_argument_bytes"]
    assert r["collective_counts"]["reduce_scatter"] > 0
    rows = [json.loads(ln) for ln in runs["opt_rows"]]
    assert any(x["arch"] == combo[0] and x["opts"] == r["opts"] for x in rows)


def _fixed_rows(path):
    rows = [
        {"arch": "qwen3-moe-30b-a3b", "shape": "train_4k", "mesh": "16x16",
         "t_compile_s": 41.5, "memory": {"peak_bytes": 3.4e10},
         "roofline": {"t_compute": 2.5, "t_memory": 0.0042, "t_collective": 3e-6,
                      "dominant": "compute", "flops": 1.5e15, "collective_bytes": 8.8e10},
         "useful_flop_ratio": 0.71},
        {"arch": "rwkv6-3b", "shape": "decode_32k", "mesh": "16x16",
         "t_compile_s": 3.0, "memory": {"peak_bytes": 812},
         "roofline": {"t_compute": 4e-5, "t_memory": 0.0021, "t_collective": 0.0,
                      "dominant": "memory", "flops": 4.7e10, "collective_bytes": 0.0},
         "useful_flop_ratio": None},
        {"arch": "gemma2-9b", "shape": "long_500k", "mesh": "2x16x16",
         "t_compile_s": 2.0, "memory": {"peak_bytes": 3.1e10},
         "roofline": {"t_compute": 4e-5, "t_memory": 0.009, "t_collective": 0.0,
                      "dominant": "memory", "flops": 4.1e10, "collective_bytes": 0.0},
         "useful_flop_ratio": 0.5},
        {"arch": "dbrx-132b", "shape": "train_4k", "mesh": "16x16",
         "error": "NotImplementedError: not ported"},
    ]
    path.write_text("not json\n" + "\n".join(json.dumps(r) for r in rows) + "\n")


@pytest.mark.parametrize("mesh,markdown", [("16x16", True), ("2x16x16", True),
                                           ("16x16", False)])
def test_render_of_a_fixed_jsonl_equals_the_reference(tmp_path, mesh, markdown):
    from repro.launch import roofline_report as ref_report
    path = tmp_path / "rows.jsonl"
    _fixed_rows(path)
    got = roofline_report.render(roofline_report.load(path), mesh=mesh,
                                 markdown=markdown)
    assert got == ref_report.render(ref_report.load(path), mesh=mesh,
                                    markdown=markdown)
    # a port record shows its trace time in the "compile" column
    rows = roofline_report.load(path)
    key = ("qwen3-moe-30b-a3b", "train_4k", "16x16")
    rows[key] = dict(rows[key], t_trace_s=12.5)
    del rows[key]["t_compile_s"]
    assert "| 12.5s |" in roofline_report.render(rows)


def test_input_shapes_and_peaks():
    from repro.common.config import INPUT_SHAPES as REF_SHAPES
    assert {k: tuple(v.__dict__.values()) for k, v in INPUT_SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in REF_SHAPES.items()}
    assert (HW.peak_flops_bf16, HW.hbm_bw, HW.hbm_bytes, HW.nvlink_bw,
            HW.devices_per_host, HW.inter_host_bw) == \
        (989e12, 3.35e12, 80e9, 450e9, 8, 50e9)
