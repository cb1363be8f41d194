"""What each rank of the port's mesh tests runs.

``repro_torch.launch.mesh.spawn`` starts one process per rank and calls
one of these functions in each with the rank's mesh; the functions
must be importable by name, so they live here and not in the test
modules (which import JAX: the ranks import only torch and the port).
Each returns what rank 0 reports to the test; what must hold on every
rank is gathered to rank 0 with ``all_gather_object``.
"""
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.common import sharding as shard_lib
from repro_torch.core import conditional
from repro_torch.core import moe as moe_lib
from repro_torch.core import overlap as overlap_lib
from repro_torch.core.schedules import DiceConfig
from repro_torch.launch import serve
from repro_torch.models.dit_moe import init_dit
from repro_torch.sampling.rectified_flow import rf_sample

STEPS = 6


def _every_rank(value):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def sample_runs(mesh, tree, runs, noise, classes, guidance=1.0):
    """``rf_sample`` over the mesh for each ``(label, cfg, dcfg)`` of
    ``runs``, on the params of the numpy ``tree``.  Returns {label:
    (samples, stats, step keys of every rank)}."""
    params = bridge.from_jax_params(tree, device="cpu")
    out = {}
    for label, cfg, dcfg in runs:
        x, st = rf_sample(params, cfg, dcfg, num_steps=STEPS,
                          classes=torch.as_tensor(classes),
                          noise=torch.as_tensor(noise), guidance=guidance,
                          mesh=mesh)
        out[label] = (x, st, _every_rank(st["step_keys"]))
    return out


def mesh_layout(mesh, x):
    """Each rank's coordinates on the mesh, and whether its collectives
    give their expected values: the mean over every rank, the patch
    group's all-gather, and ``gather_samples`` of this rank's block of the
    global (B, T, C) ``x`` (its lane's rows, its patch's tokens).  Also
    whether ``make_mesh`` refuses a shape other than the world's."""
    from repro_torch.launch import mesh as mesh_lib
    x = torch.as_tensor(x)
    block = shard_lib.hier_place_tokens(x, mesh)
    n = mesh.world_size
    mean = mesh.all_reduce_mean(torch.tensor([float(mesh.rank)]))
    ok = {"gather_samples": torch.equal(mesh.gather_samples(block), x),
          "mean": float(mean) == (n - 1) / 2}
    if "patch" in mesh.axis_names:
        g = mesh.patch_all_gather(torch.tensor([float(mesh.rank)]))
        base = mesh.rank - mesh.rank_in("patch")
        ok["patch_all_gather"] = g.tolist() == [
            float(base + p) for p in range(mesh.shape["patch"])]
    try:
        mesh_lib.make_mesh(ep=n, dp=2, backend="gloo", device="cpu")
        ok["refuses_other_shapes"] = False
    except ValueError:
        ok["refuses_other_shapes"] = True
    coords = {a: mesh.rank_in(a) for a in ("dp", "ep", "patch")}
    return _every_rank((mesh.rank, mesh.axis_names, dict(mesh.shape),
                        coords, mesh.lane, ok))


def dp_invariance(mesh, probs, idx, counts):
    """``load_balance_loss`` over the mesh on this rank's ep shard of
    (probs, idx), and the mean over the ranks of its ep shard's expert
    counts, as bytes: every dp replica holds the same rows."""
    from repro_torch.launch import mesh as mesh_lib
    n = mesh_lib.axis_size(mesh, "ep")
    e = mesh.rank_in("ep")
    probs, idx, counts = (torch.as_tensor(a) for a in (probs, idx, counts))
    rows = probs.shape[0] // n
    mine = slice(e * rows, (e + 1) * rows)
    lb = moe_lib.load_balance_loss(probs[mine], idx[mine], probs.shape[1],
                                   mesh=mesh)
    cnt = mesh.all_reduce_mean(counts[e])
    return _every_rank((lb.numpy().tobytes(), cnt.numpy().tobytes()))


def patch_continuous_refused(mesh, tree, cfg):
    """``serve_continuous`` on a patch mesh: the message it raises."""
    params = bridge.from_jax_params(tree, device="cpu")
    server = serve.DiceServer(cfg, DiceConfig.dice(), params=params,
                              mesh=mesh)
    try:
        serve.serve_continuous(server, [serve.Request(1, 0)], max_batch=4,
                               num_steps=2)
    except ValueError as e:
        return str(e)
    return None


def topology_ring(mesh, tree, cfg, noise, classes, devices_per_host):
    """``DiceServer.generate`` with the ring in the topology-aware hop
    order (``devices_per_host``) and with blocking all-to-alls: the hop
    order and both samples."""
    from repro_torch.compress.codecs import CompressConfig
    params = bridge.from_jax_params(tree, device="cpu")
    reqs = [serve.Request(int(c), i) for i, c in enumerate(classes)]
    out = {}
    for overlap in ("ring", "blocking"):
        server = serve.DiceServer(
            cfg, DiceConfig.dice(overlap=overlap), params=params, mesh=mesh,
            compress=CompressConfig("int8_residual"),
            devices_per_host=devices_per_host)
        x, st = server.generate(reqs, num_steps=STEPS,
                                noise=torch.as_tensor(noise))
        out[overlap] = (server.hop_schedule, x, st["ring_hops"])
    return out


def exchange_and_lb(mesh, hop_schedules, lb_inputs):
    """The ring engine against the blocking all-to-alls on random chunks:
    per hop schedule, the largest difference and whether the output equals
    the first schedule's bit for bit; and ``load_balance_loss`` over the
    mesh on this rank's shard of ``lb_inputs`` (probs, idx)."""
    n, e_loc, C, d = mesh.size, 2, 5, 8
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    chunks = torch.randn((n, e_loc, C, d), generator=gen)
    w = torch.randn((e_loc, d, d), generator=gen)

    def ffn(c):                        # row-independent, like expert_ffn
        return torch.tanh(torch.einsum("ecd,edf->ecf", c, w))

    b = mesh.all_to_all(chunks).transpose(0, 1).reshape(e_loc, n * C, d)
    b = ffn(b).reshape(e_loc, n, C, d).transpose(0, 1)
    blocking = mesh.all_to_all(b)
    errs, first = {}, None
    for sched in hop_schedules:
        ring = overlap_lib.ring_expert_exchange(chunks, ffn, mesh=mesh,
                                                hop_schedule=sched)
        first = ring if first is None else first
        errs[sched] = (float((ring - blocking).abs().max()),
                       bool(torch.equal(ring, first)))
    probs, idx = (torch.as_tensor(a) for a in lb_inputs)
    rows = probs.shape[0] // n
    mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    lb = float(moe_lib.load_balance_loss(probs[mine], idx[mine],
                                         probs.shape[1], mesh=mesh))
    return _every_rank(errs), _every_rank(lb)


def continuous_runs(mesh, tree, cfg, runs, reqs, arrivals, seed, noise,
                    max_batch):
    """For each ``(label, dcfg, steps, fresh_batches)``:
    ``serve_continuous`` over the mesh, then the requests of
    ``fresh_batches`` again in fresh fixed batches over the mesh
    (``generate``, each request with its own noise).  Returns {label:
    (continuous samples, stats, fresh samples, step keys of every rank)}."""
    params = bridge.from_jax_params(tree, device="cpu")
    out = {}
    for label, dcfg, steps, fresh_batches in runs:
        server = serve.DiceServer(cfg, dcfg, params=params, mesh=mesh)
        reqs_ = [serve.Request(c, r) for c, r in reqs]
        got, stats = serve.serve_continuous(
            server, reqs_, max_batch=max_batch, num_steps=steps, seed=seed,
            arrival_steps=arrivals, noise=noise)
        keys = _every_rank(stats["step_keys"])
        fresh = {}
        for batch in fresh_batches:
            batch = [serve.Request(c, r) for c, r in batch]
            x0 = torch.stack([torch.as_tensor(noise[r.rid]) if r.rid in noise
                              else serve.request_noise(seed, r.rid, cfg)
                              for r in batch])
            x, _ = server.generate(batch, num_steps=steps, noise=x0)
            fresh.update({r.rid: x[i] for i, r in enumerate(batch)})
        out[label] = (got, stats, fresh, keys)
    return out


def continuous_and_masks(mesh, tree, cfg, runs, reqs, arrivals, seed,
                         noise, max_batch):
    """:func:`continuous_runs`, then the "random" policy's mask of tick 0
    on each rank (16 tokens, k = 2), gathered from every rank."""
    out = continuous_runs(mesh, tree, cfg, runs, reqs, arrivals, seed, noise,
                          max_batch)
    gen = serve._tick_generator(seed, 0, mesh.device, mesh.rank)
    masks = _every_rank(conditional.policy_mask("random", 16, 2,
                                                generator=gen))
    return out, masks


def mesh_transports(mesh):
    """What the mesh's exchanges rest on, on the mesh's device: the
    all-to-all, all-gather and all-reduce mean, each against its expected
    value and with its result on that device, and one ring hop through
    ``EPMesh.exchange`` (staged through pinned host memory for gloo on a
    card).  Returns every rank's {name: ok}."""
    n, r = mesh.size, mesh.rank
    x = torch.arange(4 * n, dtype=torch.float32, device=mesh.device) + 100 * r
    rows = [torch.arange(4 * n, dtype=torch.float32) + 100 * j
            for j in range(n)]
    a2a = mesh.all_to_all(x)
    gathered = mesh.all_gather(x)
    mean = mesh.all_reduce_mean(x)
    got = torch.empty_like(x)
    mesh.exchange(x, (r + 1) % n, got, (r - 1) % n, tag=1)()
    on_card = all(t.device == mesh.device for t in (a2a, gathered, mean, got))
    return _every_rank({
        "all_to_all": torch.equal(
            a2a.cpu(), torch.cat([rows[j][4 * r:4 * r + 4] for j in range(n)])),
        "all_gather": torch.equal(gathered.cpu(), torch.cat(rows)),
        "all_reduce_mean": torch.allclose(mean.cpu(), sum(rows) / n),
        "exchange": torch.equal(got.cpu(), rows[(r - 1) % n]),
        "results_on_card": on_card,
    })


def checkpoint_slices(mesh, path, cfg):
    """Each rank's params read from ``path`` with only its experts kept
    (as the CLI's ``--ckpt`` reads over a mesh), as flattened (path,
    tensor) pairs, gathered from every rank."""
    params = ckpt_io.load_checkpoint(
        path, init_dit(cfg, generator=None), device=mesh.device,
        experts=shard_lib.expert_slice(cfg.num_experts, mesh))
    return _every_rank(ckpt_io.flatten(params)[0])


def obs_blocks(mesh, tree, cfg, dcfg, noise, classes, steps):
    """``rf_sample`` with telemetry on over the mesh: every rank's
    per-step (L, NUM_FIELDS) blocks and the samples."""
    from repro_torch.obs import ObsConfig
    params = bridge.from_jax_params(tree, device="cpu")
    x, st = rf_sample(params, cfg, dcfg, num_steps=steps,
                      classes=torch.as_tensor(classes),
                      noise=torch.as_tensor(noise), mesh=mesh,
                      obs=ObsConfig(enabled=True))
    return x, _every_rank([torch.as_tensor(t) for t in st["telemetry"]])


def fault_ladder(mesh, tree, cfg, noise):
    """Two runs of ``serve_continuous`` over the mesh.  (a) The ring under
    a watchdog, with rank 1 alone made slow from its 8th device sync on
    (each tick syncs once; its clock jumps a minute at each, so the breach
    does not hang on the host's load): the ranks must agree on the wall
    time and so demote at the same tick, else the next exchange would mix
    the ring and the all-to-alls.  (b) Four slots, two a rank: request 3
    lands in slot 3 (rank 1) at tick 2, and ``poison_tick=4`` poisons it
    when it is the only live slot; both ranks must quarantine it.  Returns
    every rank's outcomes."""
    import time
    import types
    from repro_torch.resilience.faults import (FaultConfig,
                                               ResilienceConfig)
    params = bridge.from_jax_params(tree, device="cpu")
    syncs, offset = [0], [0.0]
    real_sync = serve._sync

    def slow_sync(device):
        syncs[0] += 1
        if mesh.rank == 1 and syncs[0] >= 8:
            offset[0] += 60.0
        real_sync(device)

    clock = types.SimpleNamespace(
        perf_counter=lambda: time.perf_counter() + offset[0],
        sleep=time.sleep)

    res = ResilienceConfig(demote_after=2, step_deadline_factor=4.0)
    server = serve.DiceServer(cfg, DiceConfig.dice(overlap="ring"),
                              params=params, mesh=mesh, resilience=res)
    reqs = [serve.Request(i % 4, i) for i in range(6)]
    serve._sync, serve.time = slow_sync, clock
    try:
        out_a, st_a = serve.serve_continuous(
            server, reqs, max_batch=2, num_steps=4, seed=0, noise=noise,
            arrival_steps=[0.0] * 6)
    finally:
        serve._sync, serve.time = real_sync, time
    res_b = ResilienceConfig(faults=FaultConfig(seed=3, poison_tick=4))
    server = serve.DiceServer(cfg, DiceConfig.dice(), params=params,
                              mesh=mesh, resilience=res_b)
    out_b, st_b = serve.serve_continuous(
        server, [serve.Request(i % 4, i) for i in range(4)], max_batch=4,
        num_steps=4, seed=0, noise=noise, arrival_steps=[0.0, 0.0, 0.0, 2.0])
    keep = ("demotions", "demotion_ticks", "watchdog_breaches",
            "quarantined", "requeued", "shed", "ticks")
    return _every_rank(({k: st_a[k] for k in keep}, sorted(out_a),
                        {k: st_b[k] for k in keep}, sorted(out_b))), out_b


def online_placement(mesh, tree, cfg, bias, noise, steps):
    """``serve_continuous`` over the mesh with the routers biased by
    ``bias`` (one expert hot), once with online greedy placement (one
    replicated expert, a short warm-up and a low drift threshold) and once
    without.  Returns ((samples, stats) greedy, (samples, stats)
    identity, the greedy run's step keys on every rank)."""
    from repro_torch.core.placement import PlacementConfig
    params = bridge.from_jax_params(tree, device="cpu")
    for blk in params["blocks"]:
        blk["moe"]["router_bias"] = torch.as_tensor(bias)
    reqs = [serve.Request(i % 4, i) for i in range(8)]
    out = []
    for pcfg in (PlacementConfig(mode="greedy", replicate_top=1,
                                 warmup_ticks=2, drift_threshold=0.05),
                 None):
        server = serve.DiceServer(cfg, DiceConfig.dice(), params=params,
                                  mesh=mesh, placement=pcfg)
        got, stats = serve.serve_continuous(
            server, reqs, max_batch=2, num_steps=steps, seed=0, noise=noise,
            arrival_steps=[0.0, 0.0, 2.0, 2.0, 4.0, 4.0, 6.0, 6.0])
        stats = {k: v for k, v in stats.items() if k != "tick_plans"}
        out.append((got, stats))
    return out[0], out[1], _every_rank(out[0][1]["step_keys"])


def paging_runs(mesh, trees, runs, noise, classes, fault_specs,
                serve_cfg):
    """Expert paging over the mesh.  ``runs``: (label, tree key, cfg,
    dcfg) for ``rf_sample`` (a run that raises ``ValueError`` records its
    message instead); then, on ``trees["e8"]``, ``DiceServer.generate``
    under each ``--faults`` spec of ``fault_specs`` with paging at the auto
    budget (samples and the pool's counts summed over the ranks), the
    greedy-placement refusal, and ``serve_continuous`` of 3 requests on
    ``serve_cfg`` with the registry's paging series.  Returns {label:
    (samples, stats, step keys of every rank) or the message}."""
    from repro_torch.core import paging
    from repro_torch.core.placement import PlacementConfig
    from repro_torch.resilience.faults import parse_resilience
    params = {k: bridge.from_jax_params(t, device="cpu")
              for k, t in trees.items()}
    out = {}
    for label, key, cfg, dcfg in runs:
        try:
            x, st = rf_sample(params[key], cfg, dcfg, num_steps=STEPS,
                              classes=torch.as_tensor(classes),
                              noise=torch.as_tensor(noise), guidance=1.0,
                              mesh=mesh)
        except ValueError as e:
            out[label] = str(e)
            continue
        out[label] = (x, st, _every_rank(st["step_keys"]))
    cfg = runs[0][2]
    reqs = [serve.Request(int(c), i) for i, c in enumerate(classes)]
    spec = paging.PagingSpec(budget_bytes=0)
    for fspec in fault_specs:
        server = serve.DiceServer(cfg, DiceConfig.dice(), params=params["e8"],
                                  mesh=mesh, paging=spec,
                                  resilience=parse_resilience(fspec))
        x, st = server.generate(reqs, num_steps=STEPS, guidance=1.0,
                                noise=torch.as_tensor(noise))
        out[fspec] = (x, paging.ledger_totals(server.expert_pool,
                                              mesh.ep_mesh))
    try:
        serve.DiceServer(cfg, DiceConfig.dice(), params=params["e8"],
                         mesh=mesh, paging=spec,
                         placement=PlacementConfig(mode="greedy"))
    except ValueError as e:
        out["greedy"] = str(e)
    server = serve.DiceServer(serve_cfg, DiceConfig.dice(),
                              params=params["e8"], mesh=mesh, paging=spec,
                              resilience=parse_resilience(fault_specs[0]))
    got, st = serve.serve_continuous(
        server, reqs[:3], max_batch=4, num_steps=STEPS, seed=0, guidance=1.0,
        noise={r.rid: noise[r.rid] for r in reqs[:3]},
        arrival_steps=[0.0, 0.0, 2.0])
    series = {n: server.metrics.value(n, {"schedule": "dice",
                                          "engine": "continuous"})
              for n in ("dice_paged_transfers_total",
                        "dice_paged_bytes_in_total",
                        "dice_peak_resident_expert_bytes",
                        "dice_expert_hbm_budget_bytes",
                        "dice_paging_fetch_errors_total",
                        "dice_paging_fetch_retries_total",
                        "dice_paging_stale_fallbacks_total")}
    out["continuous"] = (got, {k: v for k, v in st.items()
                               if k != "tick_plans"}, series)
    return out


def ring_step_collectives(mesh, tree, cfg, runs, noise, classes):
    """One profiled step of each plan variant of each (label, dcfg,
    guidance) of ``runs`` over the mesh: the c10d collectives it issued
    (``launch.hlo_cost.collective_counts``), and what
    ``check_ring_lowering`` made of it (its counts, or its message).
    Returns {label: [(moe layer calls, counts, check result), ...]}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import plan as plan_lib
    from repro_torch.core import staleness as stale_lib
    from repro_torch.launch import hlo_cost
    from repro_torch.sampling.rectified_flow import make_rf_step
    params = bridge.from_jax_params(tree, device="cpu")
    x = shard_lib.hier_place_tokens(torch.as_tensor(noise), mesh)
    cls = shard_lib.hier_place_batch(torch.as_tensor(classes), mesh)
    out = {}
    for label, dcfg, guidance in runs:
        splan = plan_lib.compile_step_plans(
            dcfg, cfg.num_layers, STEPS,
            experts_per_token=cfg.experts_per_token)
        step = make_rf_step(params, cfg, dt=1.0 / STEPS, guidance=guidance,
                            mesh=mesh)
        res = []
        for plan in splan.variants:
            states = [stale_lib.init_planned_states(
                splan, num_tokens=x.shape[0] * x.shape[1],
                d_model=cfg.d_model, k=cfg.experts_per_token)
                for _ in range(2)]
            t = torch.zeros((x.shape[0],))
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                step(x, cls, *states, t, plan=plan)
            calls = cfg.num_layers * (2 if guidance != 1.0 else 1) * max(
                2 if a.mode == "staggered" else 1 for a in plan.actions)
            try:
                got = hlo_cost.check_ring_lowering(
                    prof, n_dev=mesh.size, moe_layer_calls=calls)
            except ValueError as e:
                got = str(e)
            res.append((calls, hlo_cost.collective_counts(prof), got))
        out[label] = res
    return _every_rank(out)
