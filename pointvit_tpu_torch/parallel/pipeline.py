"""GPipe pipeline parallelism over the transformer trunk.

Counterpart of ``pointvit_tpu/parallel/pipeline.py``: the trunk's blocks
(``blocks.0 … blocks.{L-1}``) stacked on a leading axis, contiguous groups of
L/n blocks per rank of a ``pipe`` mesh axis, and microbatches streamed
through the stages on the GPipe schedule of ``n_microbatches + n − 1``
ticks. As in the JAX program, every rank computes at every tick (the fill
and drain ticks on zeros or stale rows, masked out of the output), so every
rank runs the same collectives in the same order, forward and backward:
activations move stage to stage by a differentiable ring hop whose backward
is the reverse hop, and the last stage's outputs reach every pipe rank by a
masked sum (JAX's ``psum``), whose backward hands each rank the gradient of
the replicated output.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from pointvit_tpu_torch.parallel.comm import reduce_to_replicated, ring_shift

__all__ = ["stack_block_params", "unstack_block_params", "pipeline_blocks"]


def _block_keys(state: dict, prefix: str) -> dict[int, list[str]]:
    blocks: dict[int, list[str]] = {}
    for key in state:
        if not key.startswith(prefix):
            continue
        index, _, rest = key[len(prefix):].partition(".")
        if index.isdigit() and rest:
            blocks.setdefault(int(index), []).append(rest)
    return blocks


def stack_block_params(params: dict, prefix: str = "blocks."):
    """Stack the per-block entries ``{prefix}{i}.{name}`` of a state dict on
    a new axis 0: ``({name: (L, …)}, L)``. Every block has the same names
    (they are instances of one module)."""
    blocks = _block_keys(params, prefix)
    if not blocks:
        raise ValueError(f"no '{prefix}*' entries in params")
    order = sorted(blocks)
    names = sorted(blocks[order[0]])
    stacked = {n: torch.stack([params[f"{prefix}{i}.{n}"] for i in order]) for n in names}
    return stacked, len(order)


def unstack_block_params(stacked: dict, prefix: str = "blocks.") -> dict:
    """Inverse of :func:`stack_block_params`."""
    length = next(iter(stacked.values())).shape[0]
    return {f"{prefix}{i}.{n}": t[i] for i in range(length) for n, t in stacked.items()}


def pipeline_blocks(
    block_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: dict,
    tokens: torch.Tensor,
    mesh,
    *,
    n_microbatches: int,
    pipe_axis: str = "pipe",
    data_axis: str | None = None,
    remat: bool = False,
) -> torch.Tensor:
    """Apply L stacked blocks to ``tokens`` pipelined over ``pipe_axis``.

    ``block_apply(one_block_params, x) -> x`` applies one block (e.g.
    ``lambda p, x: torch.func.functional_call(block, p, (x,))``);
    ``stacked_params`` holds all L blocks (:func:`stack_block_params`) and
    this rank applies its contiguous L/n. ``tokens`` are this rank's rows
    (its data shard with ``data_axis``), the same on every pipe rank, cut
    into ``n_microbatches``; the output, the same shape, is on every pipe
    rank. ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``). Gradients: a rank's blocks get theirs
    here (the others' are zero), the tokens' arrive on the first stage:
    sum them over the pipe group for the whole.
    """
    del data_axis  # the data group holds other rows; the schedule is per row
    group = mesh.get_group(pipe_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(pipe_axis))
    depth = next(iter(stacked_params.values())).shape[0]
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    n_micro = n_microbatches
    if tokens.shape[0] % n_micro:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by microbatches ({n_micro})")
    stage = mesh.get_local_rank(pipe_axis)
    per = depth // n_stages
    mine = [{n: t[stage * per + i] for n, t in stacked_params.items()} for i in range(per)]
    apply_one = (lambda p, h: checkpoint(block_apply, p, h, use_reentrant=False)) if remat \
        else block_apply

    micro = tokens.reshape((n_micro, tokens.shape[0] // n_micro) + tuple(tokens.shape[1:]))
    first = torch.tensor(stage == 0, device=tokens.device)
    last = torch.tensor(stage == n_stages - 1, device=tokens.device)
    state = torch.zeros_like(micro[0])
    outs = list(torch.zeros_like(micro).unbind(0))
    for t in range(n_micro + n_stages - 1):
        # Stage s > 0 takes its predecessor's output of the last tick; stage
        # 0 takes microbatch t (past the last, a stale one the mask drops).
        recv = ring_shift(state, group, 1)
        x = torch.where(first, micro[min(t, n_micro - 1)], recv)
        for p in mine:
            x = apply_one(p, x).to(x.dtype)
        m = t - (n_stages - 1)  # the microbatch the last stage finishes now
        mc = min(max(m, 0), n_micro - 1)
        outs[mc] = torch.where(last & (m >= 0), x, outs[mc])
        state = x
    out = torch.stack(outs)
    out = reduce_to_replicated(torch.where(last, out, torch.zeros_like(out)), group)
    return out.reshape(tokens.shape)
