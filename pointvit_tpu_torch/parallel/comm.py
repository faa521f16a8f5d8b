"""Differentiable collectives and the global-batch context of a data-parallel
step.

The JAX package writes one SPMD program over a mesh and lets XLA transpose
its collectives; here each rank is a process, so the few collectives the
parallel layers need are autograd functions whose backward is the
collective that transposes them:

- :func:`all_reduce_sum`: a sum whose every rank's loss depends on the
  result (global BatchNorm statistics, the MoE load-balance terms); the
  backward sums the ranks' gradients too.
- :func:`reduce_to_replicated`: a sum whose result feeds one computation
  replicated on every rank (the pipeline's last-stage output); the backward
  passes the gradient through, as JAX's ``psum`` to a replicated output.
- :func:`all_to_all`: ``all_to_all_single`` with optional splits; the
  backward is the reverse exchange (expert dispatch, Ulysses, a ring hop).
- :func:`all_gather` (rows, or any axis): the backward keeps this rank's
  part of the ranks' summed gradients.

:func:`global_batch` marks a forward as one rank's contiguous rows of a
global batch over a data group. Inside it the random draws (FPS starts,
dropout and drop-path masks) are taken for the global batch from the shared
generator and sliced to this rank's rows, train-mode BatchNorm takes
statistics over the group, and an MoE layer routes as the global batch
would, so that W ranks compute the one-process step's numbers.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = [
    "GlobalBatch",
    "all_gather",
    "all_reduce_sum",
    "all_to_all",
    "current_batch",
    "draw_rows",
    "global_batch",
    "group_rank",
    "group_size",
    "reduce_to_replicated",
    "ring_shift",
]


def group_size(group) -> int:
    """Ranks in ``group`` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class _ReduceToReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits):
        ctx.group, ctx.in_splits, ctx.out_splits = group, in_splits, out_splits
        ctx.shape = x.shape
        x = x.contiguous()
        rows = sum(out_splits) if out_splits is not None else x.shape[0]
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, out_splits, in_splits, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty(ctx.shape)
        dist.all_to_all_single(out, grad, ctx.in_splits, ctx.out_splits, group=ctx.group)
        return out, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = _AllReduceSum.apply(grad.contiguous(), ctx.group)
        part = grad.chunk(dist.get_world_size(ctx.group), dim=ctx.dim)[dist.get_rank(ctx.group)]
        return part.contiguous(), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of ``x``; the backward sums the gradients over the
    group as well. Without a group, ``x`` itself."""
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of ``x`` for a computation that every rank then
    repeats on the same value: the backward passes the (equal) gradient
    through, as JAX's ``psum`` to a replicated output."""
    return x if group is None else _ReduceToReplicated.apply(x, group)


def all_to_all(x: torch.Tensor, group, in_splits=None, out_splits=None) -> torch.Tensor:
    """``all_to_all_single`` over axis 0 of ``x`` (equal parts, or the row
    counts ``in_splits`` sent to and ``out_splits`` received from each
    rank); differentiable, the backward is the reverse exchange."""
    return _AllToAll.apply(x, group, in_splits, out_splits)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order. The
    backward gives this rank its part of the gradient summed over the
    group (each rank may use any part of the result)."""
    return x if group is None else _AllGather.apply(x, group, dim)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """This rank's ``x`` goes to rank ``r + step`` of ``group`` and rank
    ``r − step``'s arrives: one ring hop as an all-to-all whose splits send
    the whole block to one rank, so the backward is the reverse hop. At a
    group of one, a copy."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    r = group_rank(group)
    rows = x.shape[0]
    in_splits = [rows if j == (r + step) % n else 0 for j in range(n)]
    out_splits = [rows if j == (r - step) % n else 0 for j in range(n)]
    return all_to_all(x, group, in_splits, out_splits)


@dataclass(frozen=True)
class GlobalBatch:
    """This rank's rows ``[offset, offset + rows)`` of a global batch of
    ``total`` rows spread over the data ``group``."""

    group: object
    offset: int
    rows: int
    total: int

    @property
    def size(self) -> int:
        return group_size(self.group)


_CURRENT: contextvars.ContextVar[GlobalBatch | None] = contextvars.ContextVar(
    "pointvit_global_batch", default=None)


@contextlib.contextmanager
def global_batch(group, rows: int):
    """Inside, a forward over ``rows`` rows is this rank's contiguous part of
    a global batch of ``rows × W`` rows over the data ``group`` (rank r holds
    rows ``[r·rows, (r+1)·rows)``, as ``P('data')`` splits axis 0)."""
    ctx = GlobalBatch(group, group_rank(group) * rows, rows, group_size(group) * rows)
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def current_batch() -> GlobalBatch | None:
    """The :func:`global_batch` in force, or None."""
    return _CURRENT.get()


def draw_rows(draw, shape) -> torch.Tensor:
    """``draw(shape)`` (a random draw of that shape from the shared
    generator) for the global batch, this rank's rows kept. Axis 0 of
    ``shape`` is the local batch or a multiple of it (clouds × views, say)
    whose rows follow the clouds' order; outside :func:`global_batch`, the
    draw itself."""
    ctx = current_batch()
    if ctx is None or ctx.size == 1:
        return draw(tuple(shape))
    lead = shape[0]
    if lead % ctx.rows:
        raise ValueError(f"a draw of {lead} rows is not a multiple of the local batch {ctx.rows}")
    per = lead // ctx.rows
    full = draw((ctx.total * per,) + tuple(shape[1:]))
    return full[ctx.offset * per:(ctx.offset + ctx.rows) * per]
