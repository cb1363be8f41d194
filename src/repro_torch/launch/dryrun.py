"""Multi-pod dry run of the port (port of ``repro.launch.dryrun``): what one
rank of the production mesh holds and does, for every (architecture x
input shape x mesh) combination, without a card.

The reference forces 512 host devices and lowers each step against
``ShapeDtypeStruct`` stand-ins.  The port runs its real step code for rank 0
of a fake world on ``meta`` tensors, which hold no storage:

* the world: ``torch.distributed.init_process_group("fake", ...)`` of 256
  ranks (the 16 x 16 ``("data", "model")`` mesh) or 512 (``--multi-pod``,
  2 x 16 x 16), whose groups exist and whose collectives return at once;
  each run is a process of its own;
* the step: ``launch/train.lm_train_step`` (loss, backward, the mesh's
  gradient reduction, clip, AdamW) for train shapes, the family's
  ``prefill`` / ``decode_step`` (``models/api.get_model``) for serving
  shapes, and one interweaved DiT-MoE denoise step at batch 4096 for
  ``dit_serve`` (:func:`make_dit_step`), each on the rank's own params,
  rows and cache.  A train shape of the dense and moe families places
  the params and moments as the reference does (every leaf by
  ``param_spec`` over ``model``, the AdamW moments also over ``data`` by
  ``opt_state_spec``) and runs tensor-parallel (``models/tp.py``); the
  other steps hold their routed experts cut, the rest whole;
* the kernels: their wrappers allocate on ``meta`` what the card would and
  record their work (``kernels/cost.py``);
* the counts: ``launch/hlo_cost.analyze_step`` (FLOPs, bytes, collectives,
  the live storages' peak).

Each record has the reference's keys (``t_trace_s`` in place of its
lowering and compile times) plus ``spec_argument_bytes``, the per-rank
bytes of the arguments under the reference's specs (``tree_param_specs``,
``opt_state_spec``, :func:`batch_input_spec`, :func:`cache_spec`), what
the reference places, beside ``memory.argument_bytes``, what the port
holds (the same for the dense and moe train steps; the routed experts
alone cut elsewhere); and ``fits``,
whether the peak is within the card's memory.  The roofline divides by the
H100 SXM5's data-sheet peaks (``common/config.HW``): its times are
modelled, not measured.

Run one combo:   python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b \\
                     --shape train_4k [--multi-pod] [--out results.jsonl]
Run everything:  python -m repro_torch.launch.dryrun --all --out results.jsonl
A cut combo:     ... --arch qwen3-moe-30b-a3b --shape train_4k --mesh 1x2 \\
                     --layers 2 --batch 8 --seq 128 [--opts save_ffn]
                 (a small (data, model) mesh, the depth, the global batch and
                 the sequence cut, as ``chip_smoke.py`` phase 18 runs it)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.config import HW, INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.common.sharding import (lm_moment_dims, opt_state_spec,
                                         param_spec, shard_lm_experts,
                                         shard_lm_moments, shard_lm_params)
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_smoke
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import (batch_axes, data_axis_size, make_local_mesh,
                                     make_mesh, make_production_mesh)
from repro_torch.models.api import get_model

# (arch, shape) pairs that run a documented VARIANT for long_500k
# (DESIGN.md Sec. 5): full-attention archs decode with a sliding window.
LONG_CONTEXT_WINDOWED = {
    "gemma2-9b", "deepseek-67b", "stablelm-12b", "qwen3-32b",
    "qwen3-moe-30b-a3b", "dbrx-132b", "llama-3.2-vision-11b",
    "seamless-m4t-large-v2",
}
MODELED = ("modelled from the H100 SXM5 80GB data-sheet peaks "
           "(common/config.HW), not measured")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# abstract inputs (global shapes)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this shape, at the
    global batch, in the reference's dtypes."""
    B, S = shape.global_batch, shape.seq_len
    api = get_model(cfg)
    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"] = _meta((B, S), torch.int32)
        out["labels"] = _meta((B, S), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = _meta((B, S), torch.int32)
    else:  # decode
        out["token"] = _meta((B,), torch.int32)
    for name, shape_fn, dtype in api.extra_inputs:
        if shape.kind == "decode":
            continue                       # modality K/V served from cache
        out[name] = _meta(shape_fn(cfg, B), dtype)
    return out


def _cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if shape.name == "long_500k" and cfg.name in LONG_CONTEXT_WINDOWED:
        return cfg.long_context_window
    return shape.seq_len


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig,
                   batch: Optional[int] = None) -> Dict[str, Any]:
    """The serving cache of a decode shape on ``meta`` for ``batch`` rows
    (the global batch by default), its ``pos`` at the shape's occupancy:
    the next write at ``seq_len - 1``."""
    api = get_model(cfg)
    B = shape.global_batch if batch is None else batch
    clen = _cache_len(cfg, shape)
    if api.init_cache is not None:
        cache = dict(api.init_cache(cfg, B, clen, device="meta"))
    else:
        # audio enc-dec: the cache comes from prefill; its shapes directly
        kvh, dh, nl = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
        Tf = cfg.num_audio_frames
        cache = {"k": _meta((nl, B, clen, kvh, dh), torch.bfloat16),
                 "v": _meta((nl, B, clen, kvh, dh), torch.bfloat16),
                 "mem_k": _meta((nl, B, Tf, kvh, dh), torch.bfloat16),
                 "mem_v": _meta((nl, B, Tf, kvh, dh), torch.bfloat16)}
    cache["pos"] = shape.seq_len - 1
    return cache


# ---------------------------------------------------------------------------
# the reference's shardings, as specs (one entry per dim)
# ---------------------------------------------------------------------------
def _divides(n, mesh, axis):
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def cache_spec(name: str, shape, mesh) -> Tuple[Any, ...]:
    """Sharding rule for serving-state leaves (the reference's)."""
    nd = len(shape)
    ba = batch_axes(mesh)
    if nd == 0 or name == "pos":
        return ()
    if nd == 5:           # (L, B, S, KVH, Dh) KV caches and the RWKV-6 state
        batch_p = ba if all(_divides(shape[1], mesh, a) for a in ba) and \
            shape[1] % data_axis_size(mesh) == 0 else None
        if _divides(shape[3], mesh, "model"):
            return (None, batch_p, None, "model", None)
        if _divides(shape[2], mesh, "model"):
            return (None, batch_p, "model", None, None)
        return (None, batch_p, None, None, None)
    if nd in (3, 4) and _divides(shape[-1], mesh, "model"):
        return (None,) * (nd - 1) + ("model",)
    return (None,) * nd


def batch_input_spec(name: str, shape, mesh) -> Tuple[Any, ...]:
    """The batch dim over the batch axes where it divides, else
    replicated."""
    lead = batch_axes(mesh) if shape[0] % data_axis_size(mesh) == 0 else None
    return (lead,) + (None,) * (len(shape) - 1)


def spec_bytes(shape, itemsize: int, spec, mesh) -> int:
    """One rank's bytes of a ``shape`` leaf laid out by ``spec``."""
    n = itemsize
    for d in shape:
        n *= d
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n //= mesh.shape[axis]
    return n


def _leaves(tree, names=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, names + (str(i),))
    else:
        yield names, tree


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree)
               if isinstance(t, torch.Tensor))


def _param_spec_bytes(params, mesh, *, opt: bool) -> int:
    """Params under ``param_spec`` (``tree_param_specs``' rule) and, with
    ``opt``, the f32 AdamW moments under ``opt_state_spec`` and the int32
    step."""
    total = 4 if opt else 0
    for names, t in _leaves(params):
        ps = param_spec("/".join(names), tuple(t.shape), mesh)
        total += spec_bytes(t.shape, t.element_size(), ps, mesh)
        if opt:
            os_ = opt_state_spec(ps, t.shape, mesh)
            total += 2 * spec_bytes(t.shape, 4, os_, mesh)
    return total


def _local_rows(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Rank 0's block of a batch-leading input under ``spec`` (a copy, so
    the rank holds its rows only)."""
    return t if spec[0] is None else t[: t.shape[0] // data_axis_size(mesh)].clone()


# ---------------------------------------------------------------------------
# DiT-MoE (the paper's model) on the production mesh: one interweaved
# denoise step under expert parallelism, batch over dp x ep, experts over ep
# ---------------------------------------------------------------------------
def make_dit_step(cfg: ModelConfig, mesh, *, global_batch: int = 4096):
    """(fn, args, spec_argument_bytes) of one interweaved steady-state
    denoise step of ``cfg`` for rank 0 of ``mesh`` (a ``HierMesh`` dp x
    ep): ``x + dt v`` and the staleness buffers threaded as state."""
    from repro_torch.common.sharding import expert_slice
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import staleness as stale_lib
    from repro_torch.core.schedules import DiceConfig
    from repro_torch.models.dit_moe import dit_forward, init_dit

    ep = mesh.shape["ep"]
    if cfg.num_experts % ep:
        raise ValueError(
            f"{cfg.name}: {cfg.num_experts} experts not divisible by the "
            f"ep axis ({ep}) — use dit-moe-g (16e) for the production-mesh "
            f"dry run")
    dcfg = DiceConfig.interweaved()
    plan = plan_lib.steady_state_plan_for(
        dcfg, cfg.num_layers, experts_per_token=cfg.experts_per_token)
    B, T, C, d = global_batch, cfg.patch_tokens, cfg.in_channels, cfg.d_model
    n_dev = mesh.lanes
    assert B % n_dev == 0
    b = B // n_dev
    params = init_dit(cfg, generator=None,
                      experts=expert_slice(cfg.num_experts, mesh))
    states = {i: stale_lib.MoELayerState(y_buf=_meta((b * T, d), torch.float32))
              for i in range(cfg.num_layers)}
    latents, classes = _meta((b, T, C), torch.float32), _meta((b,), torch.int32)

    def denoise_step(params, latents, classes, states):
        t = torch.full((b,), 0.5, device=latents.device)
        v, ns, _, _ = dit_forward(params, latents, t, classes, cfg, states,
                                  plan=plan, mesh=mesh)
        return latents + (1.0 / 50) * v, ns

    # the reference's layout: experts over the ep axis, everything else
    # replicated, the latents, classes and buffers over every rank
    full = init_dit(cfg, generator=None)
    spec_b = sum(t.numel() * t.element_size() // (ep if any(
        n.startswith("experts_") for n in names) else 1)
        for names, t in _leaves(full))
    spec_b += _bytes(states) + _bytes((latents, classes))
    return denoise_step, (params, latents, classes, states), spec_b


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def make_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              opts: Tuple[str, ...] = ()):
    """(fn, args, spec_argument_bytes) of the step for rank 0 of ``mesh``:
    ``fn(*args)`` runs it on the rank's own params (its routed experts),
    optimizer state, rows and cache, all ``meta``.

    ``opts`` are the reference's levers: ``cap1`` (capacity_factor 1.0),
    ``cap_floor4`` (decode capacity rounded to 4), and for train shapes of
    the dense and moe families ``remat_dots`` / ``save_ffn`` (the remat
    policies), ``seq_shard`` (the sequence-sharded residual stream),
    ``attn_shard`` / ``attn_seq`` (the attention's ``"heads"`` / ``"seq"``
    layout: :func:`train_kwargs`).  Those train steps hold every param cut
    by its spec and the moments cut over ``data`` too (ZeRO), what the
    reference places."""
    from repro_torch.launch.train import lm_train_step
    from repro_torch.optim.adamw import adamw_init

    if "cap1" in opts:
        cfg = cfg.replace(capacity_factor=1.0)
    api = get_model(cfg)
    ba = batch_axes(mesh)
    long_ctx = shape.name == "long_500k"
    kw: Dict[str, Any] = {"mesh": mesh, "batch_axes": ba}
    if cfg.family in ("ssm", "hybrid", "audio"):
        kw = {}                             # these models ignore mesh kwargs
    if long_ctx and cfg.family in ("hybrid", "audio"):
        kw["attn_window"] = cfg.long_context_window
    if long_ctx and cfg.family in ("dense", "moe", "vlm"):
        kw["long_context"] = True
    if shape.kind == "decode" and cfg.family == "moe" and "cap_floor4" in opts:
        kw["capacity_floor"] = 4
    spec_placed = shape.kind == "train" and cfg.family in ("dense", "moe")
    train_kw = train_kwargs(cfg, shape, opts)

    params_g = api.init(cfg, generator=None)
    params = shard_lm_params(params_g, mesh) if spec_placed \
        else shard_lm_experts(params_g, mesh)
    inputs_g = input_specs(cfg, shape)
    in_specs = {k: batch_input_spec(k, v.shape, mesh) for k, v in inputs_g.items()}
    inputs = {k: _local_rows(v, in_specs[k], mesh) for k, v in inputs_g.items()}
    in_spec_b = sum(spec_bytes(v.shape, v.element_size(), in_specs[k], mesh)
                    for k, v in inputs_g.items())

    if shape.kind == "train":
        opt = adamw_init(params)
        if spec_placed:
            opt = shard_lm_moments(opt, lm_moment_dims(params_g, mesh), mesh)
            # the cut dims' cache (shapes only) filled outside the analysis
            from repro_torch.models.dense import param_cuts
            param_cuts(params, cfg, mesh)

        def train_step(params, opt_state, batch):
            return lm_train_step(params, opt_state, batch, cfg, total=1000,
                                 mesh=mesh, **train_kw)

        spec_b = _param_spec_bytes(params_g, mesh, opt=True) + in_spec_b
        return train_step, (params, opt, inputs), spec_b

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return api.prefill(params, batch, cfg, **kw)

        return prefill_step, (params, inputs), \
            _param_spec_bytes(params_g, mesh, opt=False) + in_spec_b

    # decode: the rank holds the cache of its own rows
    rows = next(iter(inputs.values())).shape[0]
    cache = abstract_cache(cfg, shape, batch=rows)
    cache_g = abstract_cache(cfg, shape)
    cache_b = sum(4 if names[-1] == "pos" else spec_bytes(
        t.shape, t.element_size(), cache_spec(names[-1], t.shape, mesh), mesh)
        for names, t in _leaves(cache_g))

    def decode_fn(params, batch, cache):
        return api.decode_step(params, batch, cache, cfg, **kw)

    spec_b = _param_spec_bytes(params_g, mesh, opt=False) + in_spec_b + cache_b
    return decode_fn, (params, inputs, cache), spec_b


def train_kwargs(cfg: ModelConfig, shape: ShapeConfig,
                 opts: Tuple[str, ...]) -> Dict[str, Any]:
    """``lm_train_step``'s keywords for a train shape of the dense and moe
    families under ``opts``, as the reference's ``make_step`` maps them:
    ``remat_dots`` / ``save_ffn`` the remat policy, ``seq_shard``,
    ``attn_shard`` (``"heads"``) and ``attn_seq`` (``"seq"``, which wins
    when both are given)."""
    kw: Dict[str, Any] = {}
    if shape.kind != "train" or cfg.family not in ("dense", "moe"):
        return kw
    if "remat_dots" in opts:
        kw["remat_policy"] = "dots"
    if "save_ffn" in opts:
        kw["remat_policy"] = "save_ffn"
    if "seq_shard" in opts:
        kw["seq_shard"] = True
    if "attn_shard" in opts:
        kw["attn_shard"] = "heads"
    if "attn_seq" in opts:
        kw["attn_shard"] = "seq"
    return kw


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------
def roofline(flops: float, byts: float, totals: hlo_cost.CostTotals, *,
             n_dev: int) -> Dict[str, Any]:
    """All inputs are per rank.  The collective term prices
    ``totals.collective_bytes`` with ``hetero_wire_seconds`` over the
    ``model`` axis (``n_dev``), NVLink within an 8-GPU host and the NICs
    between hosts (``HW``): every time here is modelled from data-sheet
    peaks."""
    coll_b = float(sum(totals.collective_bytes.values()))
    t_compute = flops / HW.peak_flops_bf16
    t_memory = byts / HW.hbm_bw
    wire = hlo_cost.hetero_wire_seconds(
        totals, n_dev=n_dev, link_bw=HW.nvlink_bw,
        devices_per_host=HW.devices_per_host, inter_host_bw=HW.inter_host_bw)
    t_coll = float(sum(wire.values()))
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))[1]
    return {"flops": flops, "bytes": byts, "collective_bytes": coll_b,
            "t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "dominant": dom, "modeled": MODELED}


# ---------------------------------------------------------------------------
# running the combos
# ---------------------------------------------------------------------------
def fake_world(size: int) -> None:
    """This process as rank 0 of a ``fake`` world of ``size`` ranks (one
    run a process: a world's size is fixed once made)."""
    if dist.is_initialized():
        if dist.get_world_size() != size or dist.get_backend() != "fake":
            raise RuntimeError(f"this process already runs a {dist.get_backend()} "
                               f"world of {dist.get_world_size()} ranks; the dry "
                               f"run of a {size}-rank mesh needs a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _mesh_name(multi_pod: bool, mesh_shape) -> str:
    if mesh_shape is not None:
        return f"{mesh_shape[0]}x{mesh_shape[1]}"
    return "2x16x16" if multi_pod else "16x16"


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            verbose: bool = True, opts: Tuple[str, ...] = (),
            mesh_shape: Optional[Tuple[int, int]] = None,
            layers: Optional[int] = None, batch: Optional[int] = None,
            seq: Optional[int] = None, smoke: bool = False) -> Dict[str, Any]:
    """The record of one combo.  ``mesh_shape`` (data, model) runs a small
    mesh over a fake world of that size instead of the production one;
    ``smoke`` takes the arch's reduced config; ``layers``, ``batch`` and
    ``seq`` cut the config's depth and the shape (the global batch and the
    sequence)."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    data, model = mesh_shape if mesh_shape is not None else (
        (32 if multi_pod else 16), 16)
    fake_world(data * model)
    t0 = time.time()
    if shape_name == "dit_serve":
        shape = ShapeConfig("dit_serve", cfg.patch_tokens, batch or 4096, "prefill")
        mesh = make_mesh(ep=model, dp=data, backend="fake", device="meta")
        fn, args, spec_b = make_dit_step(cfg, mesh, global_batch=shape.global_batch)
        n_dev = model
    else:
        shape = INPUT_SHAPES[shape_name]
        if batch or seq:
            shape = ShapeConfig(shape.name, seq or shape.seq_len,
                                batch or shape.global_batch, shape.kind)
        if mesh_shape is not None:
            mesh = make_local_mesh(data, model, device="meta")
        else:
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        fn, args, spec_b = make_step(cfg, shape, mesh, opts=opts)
        n_dev = mesh.shape["model"]
    n_chips = data * model
    _, totals = hlo_cost.analyze_step(fn, *args)
    t_trace = time.time() - t0
    grad_b = 0
    if shape.kind == "train":
        # the gradient tree the step's lm_grads makes, measured (another
        # run of it on the same arguments, outside the analysis)
        from repro_torch.launch.train import lm_grads
        grad_b = _bytes(lm_grads(args[0], args[2], cfg, mesh=mesh,
                                 **train_kwargs(cfg, shape, opts))[1])
    rl = roofline(totals.flops, totals.bytes, totals, n_dev=n_dev)
    # 6ND for train (fwd+bwd), 2ND for inference; N = routed-active params
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch
    params = args[0]
    param_b = _bytes(params)
    mem = {
        "argument_bytes": totals.argument_bytes,
        "output_bytes": totals.output_bytes,
        "temp_bytes": totals.peak_bytes - totals.argument_bytes,
        "peak_bytes": totals.peak_bytes,
        "param_bytes": param_b,
        "grad_bytes": grad_b,
        "opt_bytes": _bytes(args[1]) if shape.kind == "train" else 0,
    }
    res = {
        "arch": arch, "shape": shape_name,
        "mesh": _mesh_name(multi_pod, mesh_shape),
        "opts": list(opts),
        "n_chips": n_chips,
        "t_trace_s": round(t_trace, 1),
        "memory": mem,
        "spec_argument_bytes": spec_b,
        "fits": totals.peak_bytes <= HW.hbm_bytes,
        "roofline": rl,
        "collectives": totals.collective_bytes,
        "collective_counts": totals.collective_counts,
        "kernels": totals.kernel_totals(),
        "loops": [],          # the port's layers run in a Python loop, counted as run
        "raw_cost_analysis": {"flops": totals.aten_flops, "bytes": totals.aten_bytes},
        "model_flops_global": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "useful_flop_ratio": (model_flops / n_chips) / rl["flops"]
        if rl["flops"] else None,
    }
    if layers or batch or seq or smoke:
        res["cut"] = {"smoke": smoke, "layers": cfg.num_layers, "global_batch": shape.global_batch,
                      "seq_len": shape.seq_len}
    if verbose:
        print(json.dumps(res, indent=2, default=str))
    return res


def error_row(arch: str, shape: str, mesh_name: str, exc) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape, "mesh": mesh_name,
            "error": f"{type(exc).__name__}: {str(exc)[:500]}"}


def _child(arch: str, shape: str, multi_pod: bool, opts, out: Optional[str]):
    """One combo in a process of its own; returns its record or error row
    (the child has appended it to ``out``)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--opts", ",".join(opts), "--quiet"]
    if multi_pod:
        cmd.append("--multi-pod")
    if out:
        cmd += ["--out", out]
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(cmd, capture_output=True, text=True, env=env)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if lines:
        return json.loads(lines[-1])
    row = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod, None),
           "error": f"the process exited {p.returncode}: {p.stderr[-500:]}"}
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(row, default=str) + "\n")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default=None, help="comma list filter")
    ap.add_argument("--shapes", default=None, help="comma list filter")
    ap.add_argument("--opts", default="", help="comma list of perf levers "
                    "(cap1, cap_floor4, remat_dots, save_ffn, seq_shard, "
                    "attn_shard, attn_seq)")
    ap.add_argument("--out", default=None, help="JSONL, appended per combo")
    ap.add_argument("--quiet", action="store_true",
                    help="print the record on one line, not indented")
    ap.add_argument("--mesh", default=None, help="DATAxMODEL: one combo on a "
                    "small mesh over a fake world of that size")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--batch", type=int, default=None, help="the global batch")
    ap.add_argument("--seq", type=int, default=None, help="the sequence length")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opts.split(",") if o)
    mesh_shape = tuple(int(n) for n in args.mesh.split("x")) if args.mesh else None

    def emit(res):
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res, default=str) + "\n")

    if not args.all:
        mesh_name = _mesh_name(args.multi_pod, mesh_shape)
        try:
            res = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                          opts=opts, verbose=not args.quiet, mesh_shape=mesh_shape,
                          layers=args.layers, batch=args.batch, seq=args.seq)
        except Exception as e:  # noqa: BLE001  (the sweep's error row)
            res = error_row(args.arch, args.shape, mesh_name, e)
            emit(res)
            print(json.dumps(res, default=str))
            return 1
        emit(res)
        if args.quiet:
            print(json.dumps(res, default=str))
        return 0

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if "error" not in r:
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass
    archs = args.archs.split(",") if args.archs else ASSIGNED_ARCHS
    shapes = args.shapes.split(",") if args.shapes else list(INPUT_SHAPES)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in (False, True):
                mesh_name = _mesh_name(mp, None)
                if (arch, shape, mesh_name) in done:
                    print(f"SKIP {arch:24s} {shape:12s} {mesh_name} (cached)")
                    continue
                r = _child(arch, shape, mp, opts, args.out)
                if "error" in r:
                    n_fail += 1
                    print(f"FAIL {arch:24s} {shape:12s} {mesh_name:8s} "
                          f"{r['error']}", flush=True)
                else:
                    print(f"OK   {arch:24s} {shape:12s} {r['mesh']:8s} "
                          f"trace {r['t_trace_s']:6.1f}s peak "
                          f"{r['memory']['peak_bytes'] / 1e9:.2f} GB "
                          f"(fits {r['fits']}) dominant "
                          f"{r['roofline']['dominant']} (modelled)", flush=True)
    print(f"sweep complete, {n_fail} failures")
    return 0


if __name__ == "__main__":
    sys.exit(main())
