"""The training engine of the port.

Counterpart of ``pointvit_tpu/train/trainer.py``: masked AdamW on a
schedule, label-smoothed cross-entropy, gradient accumulation, EMA weights,
a non-finite guard, the metrics CSV and best/interval checkpoints, with the
JAX trainer's arguments and file layout. What differs is PyTorch's: the
step runs eagerly (no jit, no donated state), frozen parameters are frozen
by ``requires_grad`` and left out of the optimizer (where JAX routes them
to ``optax.set_to_zero``), and randomness comes from one ``torch.Generator``
on the training device, seeded from ``seed``, which every train forward
draws its FPS starts, dropout and drop-path masks from.

With ``mesh`` (a ``DeviceMesh`` from :mod:`pointvit_tpu_torch.parallel`, one
process per rank as ``torchrun`` starts them) the step is the JAX trainer's
SPMD step over the mesh: each rank takes its contiguous rows of the global
batch and the update equals the one-process update on that batch. The model
is wrapped in DDP over the ``data`` dimension (``fsdp=False``), sharded by
FSDP2 with the JAX plan (``fsdp=True``, :func:`~pointvit_tpu_torch.parallel.shard_fsdp`),
or, with a ``model`` dimension above 1, laid out by the tensor-parallel plan
with its gradients averaged over the data group. Inside the step
(:func:`~pointvit_tpu_torch.parallel.comm.global_batch`) every rank draws the
global batch's FPS starts and dropout masks from the shared generator and
keeps its rows, train-mode BatchNorm takes the global batch's statistics,
and an MoE trunk routes as the global batch. The non-finite guard and the
clip's global norm are reduced over the ranks; checkpoints are gathered to
whole tensors and written by rank 0, and a resume shards them again.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from pointvit_tpu_torch.data.loader import Loader, Prefetcher, to_device, transfer
from pointvit_tpu_torch.parallel.comm import global_batch
from pointvit_tpu_torch.train.checkpoint import SUFFIX, load_checkpoint, save_checkpoint
from pointvit_tpu_torch.train.train_utils import save_configs

__all__ = [
    "MaskedAdamW",
    "Trainer",
    "TrainingDivergedError",
    "build_optimizer",
    "clip_by_global_norm",
    "cross_entropy_loss",
    "set_trainable",
]


class TrainingDivergedError(RuntimeError):
    """Raised by ``Trainer(nan_guard='raise')`` when an epoch's mean train
    loss is non-finite; the last checkpoint is the recovery point."""


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor in its dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-example cross-entropy on f32 logits with torch-style label
    smoothing: the target is (1 − s)·onehot + s/K."""
    logits = logits.float()
    k = logits.shape[-1]
    target = F.one_hot(labels.long(), k).to(logits.dtype)
    if label_smoothing > 0:
        target = (1.0 - label_smoothing) * target + label_smoothing / k
    return -(target * F.log_softmax(logits, dim=-1)).sum(dim=-1)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its own storage), or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _sharded_group(t: torch.Tensor):
    """The group over which a DTensor is sharded (None when replicated or
    a plain tensor)."""
    placements = getattr(t, "placements", None)
    if placements is None or not any(p.is_shard() for p in placements):
        return None
    return t.device_mesh.get_group()


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` by ``max_norm / norm`` where their
    global L2 norm reaches ``max_norm`` (``optax.clip_by_global_norm``);
    returns the norm before clipping. Sharded gradients (FSDP, tensor
    parallelism) add their shards' squares over their group, so every rank
    clips by the same norm, and a rank that holds whole tensors sums the same
    squares in the same order as a process without shards."""
    grads = [p.grad for p in params if p.grad is not None]
    squares = torch.stack([torch.linalg.vector_norm(_local(g).float()) ** 2 for g in grads])
    groups = {}
    for i, g in enumerate(grads):
        group = _sharded_group(g)
        if group is not None:
            groups.setdefault(group, []).append(i)
    for group, rows in groups.items():  # a shard's square summed over its group
        part = squares[rows]
        torch.distributed.all_reduce(part, group=group)
        squares[rows] = part
    norm = torch.sqrt(squares.sum())
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        _local(g).mul_(scale.to(g.dtype))
    return norm


class MaskedAdamW:
    """``torch.optim.AdamW`` over the trainable parameters only, with its lr
    read from ``schedule`` at the update count before the increment (as
    optax does), optional global-norm clipping first, and weight decay off
    for the names in ``no_decay``. Frozen parameters (``requires_grad``
    False) get neither update nor decay. ``masked`` records whether the JAX
    optimizer this one stands for took a trainable mask, which decides the
    layout of its state in a JAX-format checkpoint
    (:func:`~pointvit_tpu_torch.convert.adamw_to_optax`)."""

    def __init__(
        self,
        named_parameters,
        schedule: Callable[[int], float],
        *,
        weight_decay: float,
        grad_clip: float | None = None,
        no_decay=frozenset(),
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        masked: bool = False,
    ) -> None:
        self._options = dict(weight_decay=weight_decay, no_decay=no_decay, betas=betas, eps=eps)
        self.schedule = schedule
        self._build(named_parameters)
        self.grad_clip = grad_clip
        self.count = 0
        self.masked = masked
        self.decay_masked = bool(no_decay)

    def _build(self, named_parameters) -> None:
        o = self._options
        named = [(n, p) for n, p in named_parameters if p.requires_grad]
        self.params = [p for _, p in named]
        layout = [(o["weight_decay"], [p for n, p in named if n not in o["no_decay"]]),
                  (0.0, [p for n, p in named if n in o["no_decay"]])]
        # A state dict keeps one group of the decayed parameters and one of
        # the rest (``_layout``). torch's multi-tensor AdamW takes DTensors
        # (FSDP, tensor parallelism) and plain tensors in separate lists, so
        # the optimizer splits each of those groups by kind, with the same
        # options; ``_of`` names the group each part belongs to.
        self._layout = [ps for _, ps in layout if ps]
        groups, self._of = [], []
        for j, (wd, ps) in enumerate((wd, ps) for wd, ps in layout if ps):
            for sharded in (False, True):
                part = [p for p in ps if hasattr(p, "to_local") == sharded]
                if part:
                    groups.append({"params": part, "weight_decay": wd})
                    self._of.append(j)
        self.optimizer = torch.optim.AdamW(groups, lr=self.schedule(0), betas=o["betas"],
                                           eps=o["eps"])

    def rebind(self, named_parameters) -> None:
        """Hold the parameters a wrap made in place of the ones given at
        construction (FSDP and tensor parallelism replace them with
        DTensors), with the same options; call it before the first step."""
        if self.count or self.optimizer.state:
            raise RuntimeError("rebind an optimizer before its first step")
        self._build(named_parameters)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip is not None and self.grad_clip > 0:
            clip_by_global_norm(self.params, self.grad_clip)
        lr = float(self.schedule(self.count))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        """The AdamW state in the layout of ``_layout`` (whatever the split by
        kind), so a checkpoint loads under any distribution, and the count."""
        sd = self.optimizer.state_dict()
        flat = [p for g in self.optimizer.param_groups for p in g["params"]]
        where = {id(p): i for i, p in enumerate(p for ps in self._layout for p in ps)}
        groups, start = [], 0
        for j, ps in enumerate(self._layout):
            groups.append({**sd["param_groups"][self._of.index(j)],
                           "params": list(range(start, start + len(ps)))})
            start += len(ps)
        state = {where[id(flat[i])]: v for i, v in sd["state"].items()}
        return {"adamw": {"state": state, "param_groups": groups}, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        saved = state["adamw"]
        if len(saved["param_groups"]) != len(self._layout):
            raise ValueError(f"the state has {len(saved['param_groups'])} parameter groups, "
                             f"this optimizer {len(self._layout)}")
        where = {id(p): i for i, p in enumerate(p for ps in self._layout for p in ps)}
        flat = [p for g in self.optimizer.param_groups for p in g["params"]]
        groups, start = [], 0
        for g, j in zip(self.optimizer.param_groups, self._of):
            groups.append({**saved["param_groups"][j],
                           "params": list(range(start, start + len(g["params"])))})
            start += len(g["params"])
        moments = {i: saved["state"][where[id(p)]] for i, p in enumerate(flat)
                   if where[id(p)] in saved["state"]}
        self.optimizer.load_state_dict({"state": moments, "param_groups": groups})
        self.count = int(state["count"])


def set_trainable(model: torch.nn.Module, names) -> None:
    """Train exactly the parameters named in ``names`` (``requires_grad``);
    the others are frozen. Raises on a name the model does not have."""
    names = set(names)
    own = dict(model.named_parameters())
    unknown = sorted(names - set(own))
    if unknown:
        raise KeyError(f"not parameters of the model: {unknown}")
    for n, p in own.items():
        p.requires_grad_(n in names)


def build_optimizer(
    model: torch.nn.Module,
    schedule: Callable[[int], float],
    *,
    weight_decay: float,
    grad_clip: float | None = None,
    trainable_mask=None,
    no_decay=frozenset(),
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
) -> MaskedAdamW:
    """AdamW with optional global-norm clipping, a frozen-parameter mask and
    a no-decay set (``pointvit_tpu/train/trainer.py::build_optimizer``).
    ``trainable_mask`` is a set of parameter names (e.g. from
    :func:`~pointvit_tpu_torch.models.apf_trainable_mask`); it is applied to
    the model through ``requires_grad``. None trains every parameter."""
    unknown = sorted(set(no_decay) - {n for n, _ in model.named_parameters()})
    if unknown:
        raise KeyError(f"not parameters of the model: {unknown}")
    set_trainable(model, [n for n, _ in model.named_parameters()]
                  if trainable_mask is None else trainable_mask)
    return MaskedAdamW(model.named_parameters(), schedule, weight_decay=weight_decay,
                       grad_clip=grad_clip, no_decay=set(no_decay), betas=betas, eps=eps,
                       masked=trainable_mask is not None)


class Trainer:
    """Generic trainer engine (arguments as in the JAX ``Trainer``).

    Args:
        model: a module with ``forward(points, train=..., generator=...)`` →
            logits (the port's ``AdaptPointFormer``).
        train_dataset / test_dataset: indexable ``(points, label)`` datasets.
        optimizer: a :class:`MaskedAdamW` over ``model`` (:func:`build_optimizer`).
        schedule: step → lr, logged to the CSV (the optimizer holds its own).
        batch_size, epochs, label_smoothing, output_dir, model_config,
            dataset_config, train_config, log_lr, best_filename,
            save_interval, save_best, seed, save_config_snapshot: as in the
            JAX trainer.
        device: where the model trains (default the card, ``"cuda"``; the
            model is moved there).
        train_loader / test_loader: iterables of numpy ``(points, labels)``
            batches (default the numpy ``Loader`` of
            :mod:`pointvit_tpu_torch.data.loader` over the datasets).
        epoch_hooks: callables ``hook(trainer, epoch)`` run after each
            epoch's checkpoints and before its log line (the renderer's
            rendered-view PNGs plug in here).
        prefetch: batches prepared ahead on a background thread (0: none).
        nan_guard: None, 'skip' (a step with a non-finite loss or gradient
            leaves parameters, optimizer state, update count, EMA and
            BatchNorm statistics as they were) or 'raise'
            (:class:`TrainingDivergedError` on a non-finite epoch loss).
        grad_accum: microbatches per step; microbatch ``a`` takes global
            rows ``a, A+a, 2A+a, …`` (the JAX row order) and BatchNorm
            statistics update sequentially.
        ema_decay: keep f32 averages ``e·d + (1−d)·p`` of the trainable
            parameters and the BatchNorm statistics (frozen parameters are
            their own average); with ``ema_eval`` the test epochs and
            :meth:`predict` use them.
        mesh: a ``DeviceMesh`` (:func:`~pointvit_tpu_torch.parallel.make_mesh`,
            ``make_hybrid_mesh``) with a ``data`` dimension and optionally a
            ``model`` one; every rank builds the trainer with the same
            arguments and the same global batches. ``batch_size`` must
            divide by ranks × ``grad_accum``. None: every rank of the
            default process group when one of several ranks is started (as
            JAX's trainer takes every device), else one device.
        fsdp: shard parameters, gradients, optimizer state and EMA over the
            data dimension (FSDP2 with the JAX plan) instead of replicating
            them; without ``mesh``, over every rank (``make_mesh()``).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        train_dataset,
        test_dataset,
        optimizer: MaskedAdamW,
        schedule: Callable[[int], float] | None = None,
        batch_size: int,
        epochs: int,
        label_smoothing: float = 0.0,
        output_dir: str = "./output",
        model_config: dict | None = None,
        dataset_config: dict | None = None,
        train_config: dict | None = None,
        log_lr: bool = False,
        best_filename: str = "model_best",
        save_interval: int = 0,
        save_best: bool = True,
        seed: int = 0,
        device=None,
        mesh=None,
        train_loader=None,
        test_loader=None,
        epoch_hooks: tuple = (),
        save_config_snapshot: bool = True,
        prefetch: int = 2,
        nan_guard: str | None = None,
        grad_accum: int = 1,
        ema_decay: float | None = None,
        ema_eval: bool = True,
        fsdp: bool = False,
    ) -> None:
        if nan_guard not in (None, "skip", "raise"):
            raise ValueError(f"nan_guard must be None|'skip'|'raise', got {nan_guard!r}")
        if ema_decay is not None and not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        if grad_accum < 1 or batch_size % grad_accum:
            raise ValueError(
                f"grad_accum={grad_accum} must be >= 1 and divide batch_size={batch_size}"
            )
        self.device = torch.device(device if device is not None else "cuda")
        self.model = model.to(self.device)
        self._distribute(mesh, fsdp, optimizer, batch_size, grad_accum)
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.optimizer = optimizer
        self.schedule = schedule
        self.batch_size = batch_size
        self.epochs = epochs
        self.label_smoothing = label_smoothing
        self.output_dir = output_dir
        self.model_config = model_config or {}
        self.dataset_config = dataset_config or {}
        self.train_config = train_config or {}
        self.log_lr = log_lr
        self.best_filename = best_filename
        self.save_interval = save_interval
        self.save_best = save_best
        self.prefetch = prefetch
        self.nan_guard = nan_guard
        self.nan_skipped_total = 0
        self.grad_accum = grad_accum
        self.ema_decay = ema_decay
        self.ema_eval = ema_eval
        self.epoch_hooks = epoch_hooks
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.train_loader = train_loader if train_loader is not None else Loader(
            train_dataset, batch_size, shuffle=True, drop_last=True, seed=seed
        )
        self.test_loader = test_loader if test_loader is not None else Loader(
            test_dataset, batch_size, shuffle=False, drop_last=False, seed=seed
        )
        os.makedirs(output_dir, exist_ok=True)
        self.metrics_csv_path = os.path.join(output_dir, "training_metrics.csv")
        if save_config_snapshot and self.is_main:
            save_configs(self.model_config, self.dataset_config, self.train_config, output_dir,
                         device=str(self.device))
        self._bn_stats = {
            n: b for n, b in self.model.named_buffers()
            if n.endswith(("running_mean", "running_var"))
        }
        self.ema = self._ema_seed() if ema_decay is not None else None
        self.start_epoch = 0
        self.best_acc = 0.0

    # -- distribution ---------------------------------------------------

    def _distribute(self, mesh, fsdp: bool, optimizer, batch_size: int, grad_accum: int) -> None:
        """Lay the model out over ``mesh``: DDP, FSDP2 or the
        tensor-parallel plan (see the class docstring)."""
        self._ddp = None
        self._data_group = self._model_group = None
        self.world = 1
        self.fsdp = bool(fsdp)
        several = (torch.distributed.is_available() and torch.distributed.is_initialized()
                   and torch.distributed.get_world_size() > 1)
        if mesh is None and (fsdp or several):  # every rank, as JAX's default mesh
            from pointvit_tpu_torch.parallel import make_mesh

            mesh = make_mesh(device_type=self.device.type)
        self.mesh = mesh
        if mesh is None:
            return
        from pointvit_tpu_torch.parallel import replicate, shard_fsdp
        from pointvit_tpu_torch.parallel.comm import group_size

        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train on {self.device}")
        names = mesh.mesh_dim_names
        if "data" not in names:
            raise ValueError(f"the mesh needs a 'data' dimension, has {names}")
        self._data_group = mesh.get_group("data")
        self.world = group_size(self._data_group)
        tp = "model" in names and mesh.size(names.index("model")) > 1
        if tp:
            self._model_group = mesh.get_group("model")
        if batch_size % (self.world * grad_accum):
            raise ValueError(f"batch_size={batch_size} must divide by {self.world} data ranks "
                             f"x grad_accum={grad_accum}")
        replicate(self.model, mesh)  # every rank starts from rank 0's weights
        if tp:
            if self.fsdp:
                raise ValueError("fsdp=True with a tensor-parallel model dimension is not "
                                 "supported: shard over the data dimension only")
            from torch.distributed.tensor.parallel import parallelize_module

            from pointvit_tpu_torch.parallel import transformer_tp_shardings

            parallelize_module(self.model, mesh["model"],
                               transformer_tp_shardings(self.model, mesh))
        elif self.fsdp:
            shard_fsdp(self.model, mesh)
        else:
            from torch.nn.parallel import DistributedDataParallel

            ids = None
            if self.device.type == "cuda":
                ids = [self.device.index if self.device.index is not None
                       else torch.cuda.current_device()]
            self._ddp = DistributedDataParallel(self.model, device_ids=ids,
                                                process_group=self._data_group,
                                                broadcast_buffers=False)
        optimizer.rebind(self.model.named_parameters())
        if self.fsdp:
            from pointvit_tpu_torch.parallel.fsdp import replicated_parameters

            whole = set(replicated_parameters(self.model))
            self._averaged = [p for n, p in self.model.named_parameters() if n in whole]
        elif tp:
            self._averaged = list(self.model.parameters())

    @property
    def is_main(self) -> bool:
        """Whether this process writes the files (rank 0, or no mesh)."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _average_gradients(self) -> None:
        """Average over the data group the gradients no wrapper reduced
        (FSDP's replicated leaves; every gradient under tensor parallelism)."""
        if self._ddp is not None or self._data_group is None:
            return
        for p in self._averaged:
            if p.grad is not None:
                g = _local(p.grad)
                torch.distributed.all_reduce(g, group=self._data_group)
                g.div_(self.world)

    def _all_ranks_true(self, flag: torch.Tensor) -> bool:
        """A per-rank boolean made one for every rank (all of them true)."""
        if self._data_group is None:
            return bool(flag)
        v = flag.to(torch.int32).reshape(1)
        for group in (self._data_group, self._model_group):
            if group is not None:
                torch.distributed.all_reduce(v, op=torch.distributed.ReduceOp.MIN, group=group)
        return bool(v)

    def _rows(self, *arrays):
        """This rank's contiguous rows of a global batch (numpy arrays)."""
        if self.world == 1:
            return arrays
        r = torch.distributed.get_rank(self._data_group)
        return tuple(a[r * (len(a) // self.world):(r + 1) * (len(a) // self.world)]
                     if isinstance(a, np.ndarray) and a.ndim else a for a in arrays)

    def _sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        if self._data_group is not None:
            t = t.clone()
            torch.distributed.all_reduce(t, group=self._data_group)
        return t

    def _reshard(self) -> None:
        """Free FSDP's gathered weights, so that the next forward gathers the
        shards anew (after the shards changed outside a step)."""
        if self.fsdp:
            from torch.distributed.fsdp import FSDPModule

            for m in self.model.modules():
                if isinstance(m, FSDPModule):
                    m.reshard()

    def _full(self, t: torch.Tensor) -> torch.Tensor:
        """A whole tensor on every rank from a DTensor (a collective)."""
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def _shard_like(self, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``full`` laid out as ``like``: this rank's part as a DTensor when
        ``like`` is one, else ``full`` on ``like``'s device."""
        if not hasattr(like, "to_local"):
            return full.to(like.device, like.dtype)
        from torch.distributed.tensor import DTensor

        local = full
        for dim, placement in enumerate(like.placements):
            if placement.is_shard():
                mesh = like.device_mesh
                local = local.chunk(mesh.size(dim), placement.dim)[mesh.get_local_rank(dim)]
        return DTensor.from_local(local.to(_local(like).device, like.dtype).contiguous(),
                                  like.device_mesh, like.placements, run_check=False)

    def _load_model_state(self, state: dict) -> None:
        """Copy whole tensors into the model's parameters and buffers, a
        rank's part into a sharded one; raises on a missing or extra key."""
        own = {k: v for k, v in self.model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        given = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
        if set(own) != set(given):
            raise KeyError(f"checkpoint does not match the model: missing "
                           f"{sorted(set(own) - set(given))}, unused {sorted(set(given) - set(own))}")
        with torch.no_grad():
            for k, t in own.items():
                _local(t).copy_(_local(self._shard_like(given[k].float(), t)))
        self._reshard()

    def _reshard_optimizer_state(self) -> None:
        """Lay the optimizer's restored moments out as their parameters."""
        state = self.optimizer.optimizer.state
        for p in self.optimizer.params:
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state.get(p, {}) and hasattr(p, "to_local") \
                        and not hasattr(state[p][key], "to_local"):
                    state[p][key] = self._shard_like(state[p][key], p)

    # -- state ------------------------------------------------------------

    @property
    def step(self) -> int:
        """Updates applied so far."""
        return self.optimizer.count

    def _ema_names(self) -> list[str]:
        """What the EMA averages: the trainable parameters and the BatchNorm
        statistics."""
        return [n for n, p in self.model.named_parameters() if p.requires_grad] + list(self._bn_stats)

    def _ema_seed(self) -> dict[str, torch.Tensor]:
        """f32 copies of the trainable parameters and the BatchNorm statistics."""
        current = dict(self.model.named_parameters()) | self._bn_stats
        return {n: current[n].detach().float().clone() for n in self._ema_names()}

    def _ema_update(self) -> None:
        d = self.ema_decay
        current = dict(self.model.named_parameters()) | self._bn_stats
        with torch.no_grad():
            for n, e in self.ema.items():
                e.mul_(d).add_(current[n].float(), alpha=1.0 - d)

    # -- steps ------------------------------------------------------------

    def train_step(self, points: torch.Tensor, labels: torch.Tensor):
        """One update on a device batch (under a mesh, this rank's rows of
        the global batch). Returns (mean loss, correct count, skipped) with
        the first two as device scalars, this rank's under a mesh. The loss
        of an MoE model adds ``train_config['moe_aux_weight']`` (default
        0.01) times the mean router load-balance loss."""
        from pointvit_tpu_torch.nn.moe import collect_moe_aux_loss

        a_n = self.grad_accum
        saved = ({n: b.clone() for n, b in self._bn_stats.items()}
                 if self.nan_guard == "skip" else None)
        self.optimizer.zero_grad()
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        forward = self._ddp if self._ddp is not None else self.model
        moe = bool(getattr(self.model, "moe_experts", 0))
        aux_weight = float(self.train_config.get("moe_aux_weight", 0.01))
        for a in range(a_n):
            pts, lbl = (points, labels) if a_n == 1 else (points[a::a_n], labels[a::a_n])
            last = a == a_n - 1
            sync = contextlib.nullcontext()
            if self._ddp is not None and not last:
                sync = self._ddp.no_sync()
            elif self.fsdp:
                self.model.set_requires_gradient_sync(last)
            rows = global_batch(self._data_group, len(lbl)) if self.mesh is not None \
                else contextlib.nullcontext()
            with sync, rows:
                logits = forward(pts, train=True, generator=self.generator)
                loss = cross_entropy_loss(logits, lbl, self.label_smoothing).mean()
                if moe:
                    loss = loss + aux_weight * collect_moe_aux_loss(self.model).to(loss.device)
                (loss / a_n).backward()
            loss_sum += loss.detach()
            correct += (logits.detach().argmax(-1) == lbl).sum()
        self._average_gradients()
        loss = loss_sum / a_n
        if saved is not None:
            finite = torch.isfinite(loss)
            for p in self.optimizer.params:
                if p.grad is not None:
                    finite &= torch.isfinite(_local(p.grad)).all()
            if not self._all_ranks_true(finite):
                with torch.no_grad():
                    for n, b in self._bn_stats.items():
                        b.copy_(saved[n])
                self.optimizer.zero_grad()
                return torch.zeros_like(loss), torch.zeros_like(correct), True
        self.optimizer.step()
        if self.ema is not None:
            self._ema_update()
        return loss, correct, False

    def _eval_forward(self, points: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            if self.ema is not None and self.ema_eval:
                return functional_call(self.model, self.ema, (points,), {"train": False})
            return self.model(points, train=False)
        with global_batch(self._data_group, len(points)):
            if self.ema is None or not self.ema_eval:
                return self.model(points, train=False)
            # The EMA lies in the parameters' layout (sharded under FSDP):
            # swap it in, run, swap the weights back.
            current = dict(self.model.named_parameters()) | self._bn_stats
            kept = {n: current[n].detach().clone() for n in self.ema}
            with torch.no_grad():
                for n, e in self.ema.items():
                    current[n].copy_(e)
            self._reshard()
            try:
                return self.model(points, train=False)
            finally:
                with torch.no_grad():
                    for n, t in kept.items():
                        current[n].copy_(t)
                self._reshard()

    @torch.no_grad()
    def _eval_step(self, points, labels, weights):
        logits = self._eval_forward(points)
        per_example = cross_entropy_loss(logits, labels, self.label_smoothing)
        loss_sum = (per_example * weights).sum()
        correct = ((logits.argmax(-1) == labels).float() * weights).sum()
        return loss_sum, correct

    # -- epochs -----------------------------------------------------------

    def _batches(self, loader, prepare=None):
        if self.world > 1:  # this rank's rows of each global batch
            shard = prepare
            prepare = (lambda *b: self._rows(*shard(*b))) if shard else self._rows
        if self.prefetch > 0:
            return iter(Prefetcher(loader, self.device, prepare, depth=self.prefetch))
        return (transfer(b, self.device, prepare) for b in loader)

    def _train_epoch(self, epoch: int) -> tuple[float, float]:
        loss_sum = torch.zeros((), device=self.device)
        correct_sum = torch.zeros((), dtype=torch.int64, device=self.device)
        count = num_batches = skipped = 0
        for pts, lbl in self._batches(self.train_loader):
            loss, correct, skip = self.train_step(pts, lbl)
            loss_sum += loss
            correct_sum += correct
            skipped += int(skip)
            count += len(lbl)
            num_batches += 1
        if num_batches == 0:
            return 0.0, 0.0
        if self.world > 1:  # the ranks' means of equal row counts, and their counts
            loss_sum = self._sum_over_ranks(loss_sum) / self.world
            correct_sum = self._sum_over_ranks(correct_sum)
            count *= self.world
        if skipped:
            self.nan_skipped_total += skipped
            print(f"warning: epoch {epoch + 1}: skipped {skipped} non-finite train step(s)")
            if skipped >= num_batches:
                return float("nan"), float("nan")
            num_batches -= skipped
            count = max(count - skipped * self.batch_size, 1)
        train_loss = float(loss_sum) / num_batches
        train_acc = float(correct_sum) / count
        if self.nan_guard == "raise" and not math.isfinite(train_loss):
            raise TrainingDivergedError(
                f"non-finite mean train loss at epoch {epoch + 1}; "
                "restore the last checkpoint to recover"
            )
        return train_loss, train_acc

    def _pad_eval_batch(self, points, labels):
        """Pad a ragged final batch to the batch size with zero-weight rows."""
        n = len(labels)
        weights = np.zeros((self.batch_size,), np.float32)
        weights[:n] = 1.0
        if n < self.batch_size:
            pad = self.batch_size - n
            points = np.concatenate([points, np.repeat(points[:1], pad, axis=0)], axis=0)
            labels = np.concatenate([labels, np.repeat(labels[:1], pad)], axis=0)
        return points, labels, weights, n

    def _test_epoch(self) -> tuple[float, float]:
        loss_sum = torch.zeros((), device=self.device)
        correct_sum = torch.zeros((), device=self.device)
        count = 0
        for pts, lbl, w, n in self._batches(self.test_loader, self._pad_eval_batch):
            loss, correct = self._eval_step(pts, lbl, w)
            loss_sum += loss
            correct_sum += correct
            count += n
        loss_sum, correct_sum = self._sum_over_ranks(loss_sum), self._sum_over_ranks(correct_sum)
        if count == 0:
            return 0.0, 0.0
        return float(loss_sum) / count, float(correct_sum) / count

    # -- metrics / checkpoints -------------------------------------------

    def _prepare_metrics_csv(self) -> None:
        """Fresh run: write the header. Resumed run: keep the history up to
        the restored epoch and append from there."""
        if not self.is_main:
            return
        headers = ["epoch", "train_loss", "train_accuracy", "test_loss", "test_accuracy"]
        if self.log_lr:
            headers.append("learning_rate")
        if self.start_epoch > 0 and os.path.exists(self.metrics_csv_path):
            with open(self.metrics_csv_path, newline="") as f:
                rows = list(csv.reader(f))
            kept = [r for r in rows[1:] if r and int(r[0]) <= self.start_epoch]
            with open(self.metrics_csv_path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(rows[0] if rows else headers)
                w.writerows(kept)
            return
        with open(self.metrics_csv_path, "w", newline="") as f:
            csv.writer(f).writerow(headers)

    def _current_lr(self) -> float:
        return 0.0 if self.schedule is None else float(self.schedule(self.step))

    def _update_metrics_csv(self, epoch, train_loss, train_acc, test_loss, test_acc) -> None:
        if not self.is_main:
            return
        row = [epoch + 1, train_loss, train_acc, test_loss, test_acc]
        if self.log_lr:
            row.append(self._current_lr())
        with open(self.metrics_csv_path, "a", newline="") as f:
            csv.writer(f).writerow(row)

    def _save_checkpoint(self, filename: str, epoch: int, accuracy: float) -> str:
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "ema": self.ema,
        }
        if self.mesh is not None:  # whole tensors, gathered by every rank, written by rank 0
            state = _map_tensors(state, self._full)
        path = os.path.join(self.output_dir, filename)
        if self.is_main:
            path = save_checkpoint(
                self.output_dir, filename, epoch=epoch, accuracy=accuracy, state=state,
                model_config=self.model_config, dataset_config=self.dataset_config,
            )
        if self.mesh is not None:
            torch.distributed.barrier(self._data_group)
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore the model, optimizer, update count and EMA from a
        checkpoint and continue after its epoch: a port trainer's ``.pt``
        or a JAX trainer's ``.msgpack`` (:meth:`_restore_jax`)."""
        restored = load_checkpoint(path, map_location=self.device)
        if "model" in restored:
            if self.mesh is None:
                self.model.load_state_dict(restored["model"])
            else:
                self._load_model_state(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            if self.ema_decay is not None:
                # A checkpoint written without EMA seeds the average from the
                # restored weights.
                self.ema = restored.get("ema") or self._ema_seed()
        else:
            self._restore_jax(restored)
        if self.mesh is not None:
            self._reshard_optimizer_state()
            if self.ema is not None:
                current = dict(self.model.named_parameters()) | self._bn_stats
                self.ema = {n: e if hasattr(e, "to_local") else
                            self._shard_like(e.float(), current[n]).float()
                            for n, e in self.ema.items()}
        self.start_epoch = int(restored["epoch"]) + 1
        self.best_acc = float(restored.get("accuracy") or 0.0)
        # The best checkpoint's sidecar, of this trainer's files or of a
        # JAX trainer's, keeps the best bar from falling on a resume from an
        # interval checkpoint.
        for suffix in (SUFFIX, ".msgpack"):
            best_meta = os.path.join(self.output_dir, f"{self.best_filename}{suffix}.json")
            if os.path.exists(best_meta):
                with open(best_meta) as f:
                    self.best_acc = max(self.best_acc, float(json.load(f).get("accuracy") or 0.0))
        print(f"Loaded checkpoint from epoch {restored['epoch']} "
              f"with accuracy {restored['accuracy']:.4f}")

    def _restore_jax(self, restored: dict) -> None:
        """A JAX trainer's checkpoint (``pointvit_tpu/train/trainer.py:845-873``):
        params and batch statistics through the weight bridge, the optax
        AdamW state onto the optimizer
        (:func:`~pointvit_tpu_torch.convert.load_optax_state`), and the EMA
        trees, or the restored weights when there are none, as ``self.ema``."""
        from pointvit_tpu_torch.convert import flax_to_state_dict, load_flax_variables, load_optax_state

        variables = {"params": restored["params"]}
        if restored.get("batch_stats"):
            variables["batch_stats"] = restored["batch_stats"]
        if self.mesh is None:
            load_flax_variables(self.model, variables)
        else:
            self._load_model_state(flax_to_state_dict(variables, self.model.state_dict().keys()))
        load_optax_state(self.model, self.optimizer, restored["opt_state"])
        if self.ema_decay is not None:
            tree = {"params": restored.get("ema_params", restored["params"])}
            stats = restored.get("ema_batch_stats") or restored.get("batch_stats")
            if stats:
                tree["batch_stats"] = stats
            averaged = flax_to_state_dict(tree, self.model.state_dict().keys())
            self.ema = {n: averaged[n].to(self.device) for n in self._ema_names()}

    # -- main loop --------------------------------------------------------

    def train(self) -> float:
        """Run the training loop; returns the best test accuracy."""
        self._prepare_metrics_csv()
        best_acc = self.best_acc
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.time()
            train_loss, train_acc = self._train_epoch(epoch)
            test_loss, test_acc = self._test_epoch()
            self._update_metrics_csv(epoch, train_loss, train_acc, test_loss, test_acc)
            if test_acc > best_acc:
                best_acc = test_acc
                if self.save_best:
                    self._save_checkpoint(f"{self.best_filename}{SUFFIX}", epoch, test_acc)
            if self.save_interval and (epoch + 1) % self.save_interval == 0:
                self._save_checkpoint(f"model_epoch_{epoch + 1}{SUFFIX}", epoch, test_acc)
            for hook in self.epoch_hooks:
                hook(self, epoch)
            if not self.is_main:
                continue
            msg = (
                f"Epoch {epoch + 1}/{self.epochs} [{time.time() - t0:.1f}s]  "
                f"train loss {train_loss:.4f} acc {train_acc:.4f}  "
                f"test loss {test_loss:.4f} acc {test_acc:.4f}"
            )
            if self.log_lr:
                msg += f"  lr {self._current_lr():.6f}"
            print(msg)
        self.best_acc = best_acc
        if self.is_main:
            print(f"\nTraining completed. Best test accuracy: {best_acc:.4f}")
            print(f"Training metrics saved to {self.metrics_csv_path}")
        return best_acc

    # -- inference --------------------------------------------------------

    @torch.no_grad()
    def predict(self, points: np.ndarray) -> np.ndarray:
        """Class predictions for a batch of clouds."""
        logits = self._eval_forward(to_device(np.asarray(points, np.float32), self.device))
        return logits.argmax(-1).cpu().numpy()
