"""FSDP / ZeRO-3 sharding of the parameters over the data axis.

Counterpart of ``pointvit_tpu/parallel/fsdp.py``. The JAX package gives each
parameter leaf a sharding over the mesh's ``data`` axis and lets GSPMD
gather a layer's weights before use and reduce-scatter its gradient after.
Here the same plan drives FSDP2 (``torch.distributed.fsdp.fully_shard``):

- :func:`fsdp_shardings`: the JAX rule, a pure function of a leaf's shape:
  ``Shard(d)`` on the largest dimension divisible by the shard count, and
  replicated below ``min_shard_elems`` elements or with no such dimension.
- :func:`shard_fsdp`: ``fully_shard`` on each transformer block and on the
  model, with ``shard_placement_fn`` giving each parameter its planned
  dimension. A replicated leaf stays outside FSDP (``ignored_params``):
  FSDP does not reduce its gradient, so the trainer averages it over the
  data group itself (:func:`replicated_parameters`).
- :func:`per_device_bytes` / :func:`replicated_bytes`: the bytes one rank
  holds under a plan, counted from shapes alone, so a plan can be sized on
  ``meta`` tensors without allocating (the renderer's vit_l_16 trunk).

AdamW's moments are made by the optimizer in their parameter's layout, so
the optimizer state is sharded with the parameters, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = [
    "fsdp_shardings",
    "shard_fsdp",
    "per_device_bytes",
    "replicated_bytes",
    "replicated_parameters",
]


@dataclass(frozen=True)
class LeafSharding:
    """A leaf's plan: sharded on ``dim`` over ``shards`` ranks, or
    replicated (``dim`` None, ``shards`` 1)."""

    dim: int | None
    shards: int

    @property
    def placement(self):
        from torch.distributed.tensor import Replicate, Shard

        return Replicate() if self.dim is None else Shard(self.dim)


def _leaf_plan(shape: tuple[int, ...], n: int, min_shard_elems: int) -> LeafSharding:
    """Shard the largest dimension divisible by the shard count; else
    replicate. Tiny leaves (biases, norm scales) stay replicated: sharding
    them buys nothing and costs a gather."""
    size = 1
    for d in shape:
        size *= d
    if size < min_shard_elems:
        return LeafSharding(None, 1)
    divisible = [i for i, d in enumerate(shape) if d % n == 0 and d >= n]
    if not divisible:
        return LeafSharding(None, 1)
    return LeafSharding(max(divisible, key=lambda i: shape[i]), n)


def _leaves(tree) -> dict:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def _shard_count(mesh, axis_name) -> int:
    names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    n = 1
    for name in names:
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return n


def fsdp_shardings(tree, mesh, *, axis_name="data", min_shard_elems: int = 2**11) -> dict:
    """The ZeRO-3 plan of ``tree`` (a module's parameters, or a map of
    tensors, ``meta`` ones too) over ``axis_name`` of ``mesh`` (or a shard
    count): name → :class:`LeafSharding`. The rule depends only on the
    leaf's shape, so AdamW's moments land on their parameter's layout."""
    n = mesh if isinstance(mesh, int) else _shard_count(mesh, axis_name)
    return {name: _leaf_plan(tuple(t.shape), n, min_shard_elems)
            for name, t in _leaves(tree).items()}


def _units(model: torch.nn.Module):
    """The transformer blocks: each becomes an FSDP unit of its own, so that
    its weights are gathered just before it runs."""
    from pointvit_tpu_torch.nn.moe import MoEViTBlock

    return [m for m in model.modules() if m is not model
            and (hasattr(m, "_launch") or isinstance(m, MoEViTBlock))]


def shard_fsdp(model: torch.nn.Module, mesh, *, axis_name: str = "data",
               min_shard_elems: int = 2**11) -> torch.nn.Module:
    """Shard ``model``'s parameters with :func:`fsdp_shardings`' plan over
    the ``axis_name`` dimension of ``mesh`` (FSDP2, in place; the model
    should be on the mesh's device). Returns the model. Replicated leaves
    keep their tensors; :func:`replicated_parameters` names them."""
    from torch.distributed.fsdp import fully_shard

    plan = fsdp_shardings(model, mesh, axis_name=axis_name, min_shard_elems=min_shard_elems)
    data_mesh = mesh[axis_name] if mesh.ndim > 1 else mesh
    named = dict(model.named_parameters())
    placement = {id(p): plan[n].placement for n, p in named.items() if plan[n].dim is not None}
    ignored = {p for n, p in named.items() if plan[n].dim is None}

    def shard_placement_fn(param):
        return placement.get(id(param))

    for unit in _units(model):
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=shard_placement_fn,
                    ignored_params=ignored)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=shard_placement_fn,
                ignored_params=ignored)
    return model


def replicated_parameters(model: torch.nn.Module) -> list[str]:
    """Names of the parameters :func:`shard_fsdp` left whole (not DTensors):
    their gradients are averaged over the data group by the caller."""
    from torch.distributed.tensor import DTensor

    return [n for n, p in model.named_parameters() if not isinstance(p, DTensor)]


def per_device_bytes(tree, shardings: dict) -> int:
    """Bytes one rank holds of ``tree`` (a module or a map of tensors, real
    or ``meta``) under ``shardings`` (:func:`fsdp_shardings`' plan)."""
    return int(sum(t.numel() * t.element_size() // shardings[n].shards
                   for n, t in _leaves(tree).items()))


def replicated_bytes(tree) -> int:
    """Bytes one rank holds when ``tree`` is replicated."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(tree).values()))
