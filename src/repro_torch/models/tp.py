"""Tensor parallelism over the ``model`` axis of a training mesh: the
differentiable collectives the LMs' training step runs, and one rank's view
of a tensor-parallel step (:class:`TP`).

The reference's dry run places every parameter by ``tree_param_specs`` and
lets GSPMD insert the collectives; the port cuts each leaf to its
``param_spec`` slice (:func:`repro_torch.common.sharding.shard_lm_params`)
and runs the collectives itself.  The spec of a leaf is a rule of its
stacked shape, not of its role: at full width ``wq`` (L, d, H Dh) is cut on
its heads, ``wk`` / ``wv`` (L, d, KVH Dh) on ``d``; in the smoke configs
``wq`` is cut on ``d`` too.  So the step follows the spec of each leaf:

* a leaf cut where the block can compute with its slice (the heads or
  hidden columns of ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``; the rows
  of ``wo``, ``w_down``; the vocabulary of ``embed`` / ``unembed``) is used
  as it is;
* any other cut leaf is all-gathered where it is used (:meth:`TP.use`);
* a whole leaf is used as it is; the routed experts stay cut over their
  expert dim, as ``train_lm`` cuts them.

Gradients.  Between a block's entry and its exit (:meth:`TP.enter`,
:meth:`TP.exit_partial`, :meth:`TP.exit_rows`) each rank computes its share
of the block (its heads, its hidden columns, its query rows) and the
gradient of every value there is *partial*: the true gradient is the sum of
the ranks'.  So a leaf gathered there has a backward that sums over
``model`` and keeps the rank's slice (a reduce-scatter), and a whole leaf
used there one that sums (an all-reduce).  Outside the blocks the residual
stream is either replicated over ``model`` (every rank computes the same,
so a gathered leaf keeps its slice of the gradient, which is the same on
every rank) or, under ``seq_shard``, cut by sequence rows, where the norms'
gradients are partial again.  After the backward every leaf's gradient on
a rank is the whole gradient of the rank's slice; the trainer only
averages over the batch group.

The collectives are conjugate pairs (forward / backward):

==================  =======================  ========================
class               forward                  backward
==================  =======================  ========================
``_ModelSlice``     keep the rank's slice    all-gather
``_ModelGather``    all-gather               keep the rank's slice
``_ModelGatherSum`` all-gather               reduce-scatter
``_ModelScatter``   reduce-scatter           all-gather
``_ModelReduce``    all-reduce               identity
``_ModelEnter``     identity                 all-reduce
==================  =======================  ========================

and, over the batch group, ``_BatchGather`` and ``_BatchMean``; ``_Share``
hands each ``model`` rank a 1 / n share of a cotangent (the MoE block's
fallback over replicated tokens).
"""
from __future__ import annotations

from typing import List, Optional

import torch


# ---------------------------------------------------------------------------
# differentiable collectives over "model"
# ---------------------------------------------------------------------------
def _own(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    k = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.rank_in("model") * k, k)


class _ModelSlice(torch.autograd.Function):
    """This rank's 1 / model slice of ``x`` along ``dim`` (``x`` the same on
    every ``model`` rank); the backward all-gathers the slices' cotangents
    over ``model``, so what produced ``x`` gets the whole cotangent, the
    same on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _own(x, mesh, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_gather(g, ctx.dim), None, None


class _ModelGather(torch.autograd.Function):
    """The ``model`` group's slices concatenated along ``dim``; the backward
    keeps this rank's slice of the cotangent (the same on every rank: all
    that reads the result is replicated)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_gather(y, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.mesh, ctx.dim), None, None


class _ModelGatherSum(torch.autograd.Function):
    """The ``model`` group's slices concatenated along ``dim``, read by each
    rank for its own share of the work: the backward sums the cotangents
    over ``model`` and keeps this rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_gather(y, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_reduce_scatter(g, ctx.dim), None, None


class _ModelScatter(torch.autograd.Function):
    """This rank's slice along ``dim`` of the sum over ``model`` of partial
    values (a reduce-scatter); the backward all-gathers the cotangents."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_reduce_scatter(y, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_gather(g, ctx.dim), None, None


class _ModelReduce(torch.autograd.Function):
    """The sum over ``model`` of partial values (an all-reduce); the result
    is the same on every rank, so is its cotangent, which each partial
    value takes whole."""

    @staticmethod
    def forward(ctx, y, mesh):
        return mesh.model_sum(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelEnter(torch.autograd.Function):
    """The identity, where a value the same on every ``model`` rank enters
    each rank's share of the work: the backward sums the ranks' partial
    cotangents (an all-reduce)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_sum(g), None


class _BatchGather(torch.autograd.Function):
    """Every batch shard's rows in lane order: the global batch, the same on
    every rank.  The backward sums the cotangents over the batch group and
    keeps this rank's rows: each rank's loss is its share of the one whose
    gradients the trainer averages over that group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.batch_gather(x)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[0] // ctx.mesh.lanes
        return ctx.mesh.batch_sum(g).narrow(0, ctx.mesh.lane * k, k), None


class _BatchMean(torch.autograd.Function):
    """The mean over the batch group (the ``pod x data`` ranks); its
    backward is the batch group's mean of the cotangent, since the trainer
    averages the gradients over that group."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.batch_mean(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.batch_mean(g), None


class _Share(torch.autograd.Function):
    """The identity, whose backward is 1 / n of the cotangent: a leaf that
    every ``model`` rank applies to the same tokens holds a 1 / n share of
    its gradient, which the trainer's sum over ``model`` adds up."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


# ---------------------------------------------------------------------------
# one rank's view of a tensor-parallel step
# ---------------------------------------------------------------------------
ATTN_SHARDS = (None, "heads", "seq")


class TP:
    """A tensor-parallel step on this rank of ``mesh`` (``model`` > 1).

    ``seq_shard``: the residual stream between blocks holds the rank's
    ``S / model`` sequence rows (the reference's ``constrain``), else all
    rows, the same on every ``model`` rank.  ``attn_shard``: the attention
    layout (:meth:`attn_layout`).  A leaf's ``cut`` is the dim its
    ``param_spec`` cuts over ``model`` (of the per-layer leaf inside a
    block), None where it is whole."""

    def __init__(self, mesh, *, seq_shard: bool = False, attn_shard=None):
        if attn_shard not in ATTN_SHARDS:
            raise ValueError(f"attn_shard {attn_shard!r} (one of {ATTN_SHARDS})")
        self.mesh, self.n, self.r = mesh, mesh.model, mesh.rank_in("model")
        self.seq, self.attn = bool(seq_shard), attn_shard

    # -- leaves -------------------------------------------------------------
    def use(self, t: torch.Tensor, cut: Optional[int], *, local: bool) -> torch.Tensor:
        """The whole leaf from this rank's ``t``: gathered over ``model``
        when ``cut``.  ``local``: read for the rank's own share of the work
        (inside a block, or on its own rows under ``seq_shard``), so the
        backward sums the ranks' gradients; else read the same on every
        rank, so the backward keeps the rank's slice."""
        if cut is None:
            return _ModelEnter.apply(t, self.mesh) if local else t
        return (_ModelGatherSum if local else _ModelGather).apply(t, self.mesh, cut)

    def norm(self, p, cut):
        """An RMS norm's params for the residual stream: its rows are the
        rank's own under ``seq_shard``."""
        return {"scale": self.use(p["scale"], cut["scale"], local=self.seq)}

    def part(self, t: torch.Tensor, cut: Optional[int], dim: int, start: int,
             size: int) -> torch.Tensor:
        """Rows or columns ``[start, start + size)`` along ``dim`` of the
        whole leaf, for the rank's share of a block: the rank's own slice
        when the leaf is cut there, else a slice of the leaf gathered on
        use."""
        if cut == dim and t.shape[dim] == size and start == self.r * size:
            return t
        return self.use(t, cut, local=True).narrow(dim, start, size)

    def full_dim(self, t: torch.Tensor, cut: Optional[int], dim: int) -> int:
        return t.shape[dim] * (self.n if cut == dim else 1)

    # -- activations --------------------------------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A block's input (B, S, d), every row: the residual stream as it
        is, or its rows gathered under ``seq_shard``."""
        if self.seq:
            return _ModelGatherSum.apply(x, self.mesh, 1)
        return _ModelEnter.apply(x, self.mesh)

    def exit_partial(self, y: torch.Tensor) -> torch.Tensor:
        """A block's output from partial sums (B, S, d): all-reduced, or
        reduce-scattered to the rank's rows under ``seq_shard``."""
        if self.seq:
            return _ModelScatter.apply(y, self.mesh, 1)
        return _ModelReduce.apply(y, self.mesh)

    def exit_rows(self, y: torch.Tensor) -> torch.Tensor:
        """A block's output on the rank's own rows (B, S / model, d): as it
        is under ``seq_shard``, else every rank's rows gathered."""
        return y if self.seq else _ModelGather.apply(y, self.mesh, 1)

    def to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream's layout from every row: the rank's rows
        under ``seq_shard``."""
        return _ModelSlice.apply(x, self.mesh, 1) if self.seq else x

    # -- attention ----------------------------------------------------------
    def attn_layout(self, H: int, S: int) -> str:
        """``"seq"`` (each rank its S / model query rows, every key) when
        ``attn_shard`` asks for it and the rows divide; else ``"heads"``
        (each rank its H / model query heads) where the heads divide, as
        the reference's ``"heads"`` constraint and Megatron's default
        place them; else ``"all"`` (every head on every rank, the output's
        columns then cut for the row-parallel ``wo``)."""
        if self.attn == "seq" and S % self.n == 0:
            return "seq"
        return "heads" if H % self.n == 0 else "all"

    def seq_offset(self, S: int) -> int:
        """Position of the rank's first query row in the ``"seq"`` layout."""
        return self.r * (S // self.n)

    def kv_heads_for(self, first: int, count: int, G: int) -> List[int]:
        """The kv head each of query heads ``first .. first + count - 1``
        reads (GQA: query head h reads kv head h // G)."""
        return [(first + i) // G for i in range(count)]
