"""Rank jobs of ``tests/test_torch_remat_policy.py`` (imported by the
spawned gloo ranks, not collected)."""
import torch


def policy_a2a_job(mesh, name, policies, batch, seq):
    """One rank of a (data 1, model n) mesh: the f32 gradients of the smoke
    ``name`` under each remat policy and the collectives each step issued
    (a ``torch.profiler`` trace read by ``hlo_cost.collective_counts``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.sharding import local_rows, shard_lm_experts
    from repro_torch.configs import get_smoke
    from repro_torch.launch.hlo_cost import collective_counts
    from repro_torch.launch.train import lm_grads
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_smoke(name)
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0),
                                 dtype=torch.float32)
    params = shard_lm_experts(params, mesh)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g)
    rows = local_rows(batch, mesh)
    b = {"tokens": tokens[rows], "labels": torch.roll(tokens, -1, 1)[rows]}
    out = {}
    for policy in policies:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            loss, grads = lm_grads(params, b, cfg, mesh=mesh, remat_policy=policy)
        out[policy] = {"loss": loss, "grads": [t.clone() for t in tree_leaves(grads)],
                       "counts": collective_counts(prof)}
    return out
