"""What each rank of the port's expert-parallel tests runs.

``repro_torch.launch.mesh.spawn`` starts one process per ep rank and
calls one of these functions in each with the rank's mesh; the functions
must be importable by name, so they live here and not in the test
modules (which import JAX: the ranks import only torch and the port).
Each returns what rank 0 reports to the test; what must hold on every
rank is gathered to rank 0 with ``all_gather_object``.
"""
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.core import conditional
from repro_torch.core import moe as moe_lib
from repro_torch.core import overlap as overlap_lib
from repro_torch.launch import serve
from repro_torch.sampling.rectified_flow import rf_sample

STEPS = 6


def _every_rank(value):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def sample_runs(mesh, tree, runs, noise, classes):
    """``rf_sample`` over the mesh for each ``(label, cfg, dcfg)`` of
    ``runs``, on the params of the numpy ``tree``.  Returns {label:
    (samples, stats, step keys of every rank)}."""
    params = bridge.from_jax_params(tree, device="cpu")
    out = {}
    for label, cfg, dcfg in runs:
        x, st = rf_sample(params, cfg, dcfg, num_steps=STEPS,
                          classes=torch.as_tensor(classes),
                          noise=torch.as_tensor(noise), guidance=1.0,
                          mesh=mesh)
        out[label] = (x, st, _every_rank(st["step_keys"]))
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
