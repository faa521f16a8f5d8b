"""Device meshes, batch sharding and the tensor-parallel layout.

Counterpart of ``pointvit_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of a process group, one
process per device as ``torchrun`` starts them (NCCL on the card, gloo on
the CPU); the JAX package's one program over the mesh becomes one process a
rank:

- :func:`make_mesh`, :func:`make_hybrid_mesh` (data × model) and
  :func:`make_multihost_mesh` (replica × data × model; on one host
  (1, W/mp, mp)). Without a process group they start one: from
  ``torchrun``'s environment, else a group of this process alone.
- :func:`batch_sharding` / :func:`shard_batch`: this rank's contiguous rows
  of a global batch, as ``P('data')`` splits axis 0; :func:`replicate`
  broadcasts rank 0's tensors.
- :func:`batch_shard_map`: every rank runs ``f`` (a kernel wrapper, say) on
  its rows of the global batch and the results are gathered.
- :func:`transformer_tp_shardings`: the Megatron layout as a
  ``parallelize_module`` plan, ``ColwiseParallel`` on ``qkv``/``fc1`` and
  ``RowwiseParallel`` on ``proj``/``fc2``, matched by module path with the
  JAX package's markers. Under it a rank holds ``num_heads/tp`` heads of
  each attention and ``4E/tp`` hidden units of each MLP
  (:func:`tp_linear`, :func:`tp_attention`). The hand-written block kernels
  take whole weights, as GSPMD cannot partition a Pallas call: a kernel
  path handed tensor-parallel weights raises, and tensor parallelism runs
  the plain path (``implementation='torch'``).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from pointvit_tpu_torch.parallel.comm import all_gather, all_reduce_sum, reduce_to_replicated

try:
    from torch.distributed.tensor import DTensor as DTENSOR
except ImportError:  # a build without distributed support
    DTENSOR = None

__all__ = [
    "make_mesh",
    "make_hybrid_mesh",
    "make_multihost_mesh",
    "batch_sharding",
    "shard_batch",
    "replicate",
    "transformer_tp_shardings",
    "batch_shard_map",
    "tp_linear",
    "tp_attention",
]


def _ensure_process_group(device_type: str) -> None:
    """Start the default process group if none is: from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), else this
    process alone through a file store. NCCL for the card, gloo for the
    CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="pointvit_pg_"), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def _device_mesh(device_type: str, ranks, shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_process_group(device_type)
    ranks = list(range(dist.get_world_size())) if ranks is None else [int(r) for r in ranks]
    n = 1
    for d in shape:
        n *= d
    if n != len(ranks):
        raise ValueError(f"mesh shape {shape} does not hold {len(ranks)} ranks")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def make_mesh(devices=None, axis_name: str = "data", *, device_type: str = "cuda"):
    """1-D mesh over all ranks (or the ranks in ``devices``)."""
    _ensure_process_group(device_type)
    n = dist.get_world_size() if devices is None else len(devices)
    return _device_mesh(device_type, devices, (n,), (axis_name,))


def make_hybrid_mesh(devices=None, model_parallel: int = 1, *, data_axis: str = "data",
                     model_axis: str = "model", device_type: str = "cuda"):
    """2-D (data × model) mesh for hybrid DP×TP; ``model_parallel=1`` is
    plain data parallelism."""
    _ensure_process_group(device_type)
    n = dist.get_world_size() if devices is None else len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return _device_mesh(device_type, devices, (n // model_parallel, model_parallel),
                        (data_axis, model_axis))


def make_multihost_mesh(model_parallel: int = 1, *, replica_axis: str = "replica",
                        data_axis: str = "data", model_axis: str = "model",
                        device_type: str = "cuda"):
    """3-D (replica × data × model) mesh: hosts on the outer axis (the
    gradient all-reduce alone crosses them), data × model within a host
    (``LOCAL_WORLD_SIZE`` ranks, as ``torchrun`` sets it). One host gives
    shape (1, W/mp, mp)."""
    _ensure_process_group(device_type)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local % model_parallel:
        raise ValueError(f"{local} local devices not divisible by model_parallel={model_parallel}")
    return _device_mesh(device_type, None, (world // local, local // model_parallel, model_parallel),
                        (replica_axis, data_axis, model_axis))


def _dims(axis_name) -> tuple[str, ...]:
    return axis_name if isinstance(axis_name, tuple) else (axis_name,)


@dataclass(frozen=True)
class BatchSharding:
    """Rows of axis 0 split in ``count`` parts: this rank holds part
    ``index``."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"batch {n} not divisible by {self.count} shards")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh, axis_name="data") -> BatchSharding:
    """The split of axis 0 over ``axis_name`` (a mesh dimension, or a tuple
    of them, outer first)."""
    index, count = 0, 1
    for name in _dims(axis_name):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        index = index * size + mesh.get_local_rank(name)
        count *= size
    return BatchSharding(index, count)


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, *arrays, axis_name="data"):
    """This rank's rows of each array (numpy or tensor), on the mesh's
    device. Batch sizes must divide the shard count."""
    sharding = batch_sharding(mesh, axis_name)
    dev = _device(mesh)
    out = tuple(torch.as_tensor(a)[sharding.rows(len(a))].to(dev) for a in arrays)
    return out[0] if len(out) == 1 else out


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(tree, mesh):
    """Make every rank of ``mesh`` hold rank 0's values of the tensors in
    ``tree`` (a module, a tensor, or dicts and lists of them), in place;
    returns ``tree``."""
    with torch.no_grad():
        for t in _tensors(tree):
            for name in mesh.mesh_dim_names:  # along each dimension from coordinate 0
                group = mesh.get_group(name)
                if dist.get_world_size(group) > 1:
                    dist.broadcast(t.data, src=dist.get_global_rank(group, 0), group=group)
    return tree


def batch_shard_map(f, mesh, *, axis_names=("data",), n_outputs: int = 1):
    """``f`` over a global batch as one SPMD program: each rank runs ``f``
    on its rows of axis 0 of every input (kernel wrappers are per-device
    programs, as Pallas kernels are inside ``shard_map``), and the outputs'
    rows are gathered from the ranks in order. Anything replicated should
    be closed over."""
    axes = tuple(axis_names)

    def run(*inputs):
        sharding = batch_sharding(mesh, axes)
        outs = f(*(x[sharding.rows(x.shape[0])] for x in inputs))
        single = n_outputs == 1
        outs = (outs,) if single else tuple(outs)
        gathered = []
        for y in outs:
            for name in reversed(axes):  # inner dimension first: rows stay in order
                y = all_gather(y, mesh.get_group(name))
            gathered.append(y)
        return gathered[0] if single else tuple(gathered)

    return run


def _flax_key(path: str) -> str:
    from pointvit_tpu_torch.convert import _flax_path

    return "/".join(_flax_path(path))


def transformer_tp_shardings(model: torch.nn.Module, mesh, *, model_axis: str = "model",
                             column_markers: tuple[str, ...] = ("qkv", "fc1"),
                             row_markers: tuple[str, ...] = ("/proj/", "fc2")) -> dict:
    """Megatron-style tensor-parallel plan for ``parallelize_module(model,
    mesh[model_axis], plan)``: each linear layer whose JAX kernel path
    matches a column marker gets ``ColwiseParallel`` (a rank holds a slice of
    its outputs: heads, hidden units), each matching a row marker
    ``RowwiseParallel`` (partial sums all-reduced). Matching is by the flax
    path (``blocks_0/attn/qkv/kernel``), as in JAX. Only pairs inside one
    attention (qkv → proj) or one MLP (fc1 → fc2) are sharded: a column
    slice must meet its row layer, so a head's ``fc1``, whose BatchNorm
    needs every unit, stays replicated where GSPMD would reshard it."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    from pointvit_tpu_torch.nn.layers import Attention, Mlp

    del mesh, model_axis  # the plan is applied over mesh[model_axis] by the caller
    plan = {}
    for name, module in model.named_modules():
        if isinstance(module, Attention):
            pair = ("qkv", "proj")
        elif isinstance(module, Mlp):
            pair = ("fc1", "fc2")
        else:
            continue
        col, row = (f"{name}.{p}" if name else p for p in pair)
        col_ok = any(m in _flax_key(col) + "/kernel" for m in column_markers)
        row_ok = any(m in f"/{_flax_key(row)}/kernel/" for m in row_markers)
        if col_ok and row_ok:
            plan[col] = ColwiseParallel()
            plan[row] = RowwiseParallel()
    return plan


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, gradient summed over the group: a replicated
    activation entering column-parallel products."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.group), None


def tp_linear(x: torch.Tensor, lin: torch.nn.Linear) -> torch.Tensor:
    """``lin`` applied in x's dtype to a tensor-parallel layer. Column
    (weight ``Shard(0)``): replicated x → this rank's output slice. Row
    (weight ``Shard(1)``): x this rank's input slice → the full output,
    partial products summed over the group, bias added once."""
    from torch.distributed.tensor import Shard

    w = lin.weight
    group = w.device_mesh.get_group()
    placement = w.placements[0]
    if not isinstance(placement, Shard):
        raise ValueError(f"a tensor-parallel layer's weight must be sharded, got {placement}")
    weight = w.to_local().to(x.dtype)
    bias = lin.bias.to_local().to(x.dtype) if lin.bias is not None else None
    if placement.dim == 0:
        return torch.nn.functional.linear(_CopyToGroup.apply(x, group), weight, bias)
    out = reduce_to_replicated(torch.nn.functional.linear(x, weight), group)
    return out if bias is None else out + bias


def tp_attention(x: torch.Tensor, attn, implementation: str | None) -> torch.Tensor:
    """An attention layer with a column-parallel ``qkv`` and a row-parallel
    ``proj``: the qkv slices are gathered, this rank attends with its
    ``num_heads/tp`` heads and ``proj`` sums the heads' partial products."""
    from pointvit_tpu_torch.ops.attention_kernel import fused_mha_qkv

    group = attn.qkv.weight.device_mesh.get_group()
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    if attn.num_heads % tp:
        raise ValueError(f"{attn.num_heads} heads not divisible by {tp} tensor-parallel ranks")
    qkv = all_gather(tp_linear(x, attn.qkv), group, dim=-1)
    E = qkv.shape[-1] // 3
    width = E // tp
    mine = torch.cat([qkv[..., i * E + r * width:i * E + (r + 1) * width] for i in range(3)], -1)
    att = fused_mha_qkv(mine.contiguous(), attn.num_heads // tp, implementation)
    return tp_linear(att, attn.proj)
