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

Data parallelism over a mesh and FSDP are not ported yet (ROADMAP A11): one
trainer drives one device.
"""

from __future__ import annotations

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


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` by ``max_norm / norm`` where their
    global L2 norm reaches ``max_norm`` (``optax.clip_by_global_norm``);
    returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class MaskedAdamW:
    """``torch.optim.AdamW`` over the trainable parameters only, with its lr
    read from ``schedule`` at the update count before the increment (as
    optax does), optional global-norm clipping first, and weight decay off
    for the names in ``no_decay``. Frozen parameters (``requires_grad``
    False) get neither update nor decay."""

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
    ) -> None:
        named = [(n, p) for n, p in named_parameters if p.requires_grad]
        self.params = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if n not in no_decay], "weight_decay": weight_decay},
            {"params": [p for n, p in named if n in no_decay], "weight_decay": 0.0},
        ]
        self.optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=schedule(0), betas=betas, eps=eps
        )
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0

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
        return {"adamw": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["adamw"])
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
                       grad_clip=grad_clip, no_decay=set(no_decay), betas=betas, eps=eps)


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
        mesh / fsdp: not ported (ROADMAP A11); raise.
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
        if mesh is not None or fsdp:
            raise NotImplementedError(
                "mesh data parallelism and FSDP are not ported yet (ROADMAP A11); "
                "the port's Trainer drives one device"
            )
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
        if save_config_snapshot:
            save_configs(self.model_config, self.dataset_config, self.train_config, output_dir,
                         device=str(self.device))
        self._bn_stats = {
            n: b for n, b in self.model.named_buffers()
            if n.endswith(("running_mean", "running_var"))
        }
        self.ema = self._ema_seed() if ema_decay is not None else None
        self.start_epoch = 0
        self.best_acc = 0.0

    # -- state ------------------------------------------------------------

    @property
    def step(self) -> int:
        """Updates applied so far."""
        return self.optimizer.count

    def _ema_seed(self) -> dict[str, torch.Tensor]:
        """f32 copies of the trainable parameters and the BatchNorm statistics."""
        own = dict(self.model.named_parameters())
        names = [n for n, p in own.items() if p.requires_grad]
        out = {n: own[n].detach().float().clone() for n in names}
        out.update({n: b.detach().float().clone() for n, b in self._bn_stats.items()})
        return out

    def _ema_update(self) -> None:
        d = self.ema_decay
        current = dict(self.model.named_parameters()) | self._bn_stats
        with torch.no_grad():
            for n, e in self.ema.items():
                e.mul_(d).add_(current[n].float(), alpha=1.0 - d)

    # -- steps ------------------------------------------------------------

    def train_step(self, points: torch.Tensor, labels: torch.Tensor):
        """One update on a device batch. Returns (mean loss, correct count,
        skipped) with the first two as device scalars."""
        a_n = self.grad_accum
        saved = ({n: b.clone() for n, b in self._bn_stats.items()}
                 if self.nan_guard == "skip" else None)
        self.optimizer.zero_grad()
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for a in range(a_n):
            pts, lbl = (points, labels) if a_n == 1 else (points[a::a_n], labels[a::a_n])
            logits = self.model(pts, train=True, generator=self.generator)
            loss = cross_entropy_loss(logits, lbl, self.label_smoothing).mean()
            (loss / a_n).backward()
            loss_sum += loss.detach()
            correct += (logits.detach().argmax(-1) == lbl).sum()
        loss = loss_sum / a_n
        if saved is not None:
            finite = torch.isfinite(loss)
            for p in self.optimizer.params:
                if p.grad is not None:
                    finite &= torch.isfinite(p.grad).all()
            if not bool(finite):
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
        if self.ema is not None and self.ema_eval:
            return functional_call(self.model, self.ema, (points,), {"train": False})
        return self.model(points, train=False)

    @torch.no_grad()
    def _eval_step(self, points, labels, weights):
        logits = self._eval_forward(points)
        per_example = cross_entropy_loss(logits, labels, self.label_smoothing)
        loss_sum = (per_example * weights).sum()
        correct = ((logits.argmax(-1) == labels).float() * weights).sum()
        return loss_sum, correct

    # -- epochs -----------------------------------------------------------

    def _batches(self, loader, prepare=None):
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
        if count == 0:
            return 0.0, 0.0
        return float(loss_sum) / count, float(correct_sum) / count

    # -- metrics / checkpoints -------------------------------------------

    def _prepare_metrics_csv(self) -> None:
        """Fresh run: write the header. Resumed run: keep the history up to
        the restored epoch and append from there."""
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
        row = [epoch + 1, train_loss, train_acc, test_loss, test_acc]
        if self.log_lr:
            row.append(self._current_lr())
        with open(self.metrics_csv_path, "a", newline="") as f:
            csv.writer(f).writerow(row)

    def _save_checkpoint(self, filename: str, epoch: int, accuracy: float) -> str:
        return save_checkpoint(
            self.output_dir, filename, epoch=epoch, accuracy=accuracy,
            state={
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "ema": self.ema,
            },
            model_config=self.model_config, dataset_config=self.dataset_config,
        )

    def load_checkpoint(self, path: str) -> None:
        """Restore the model, optimizer, update count and EMA from a
        checkpoint and continue after its epoch."""
        restored = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(restored["model"])
        self.optimizer.load_state_dict(restored["optimizer"])
        if self.ema_decay is not None:
            # A checkpoint written without EMA seeds the average from the
            # restored weights.
            self.ema = restored.get("ema") or self._ema_seed()
        self.start_epoch = int(restored["epoch"]) + 1
        self.best_acc = float(restored.get("accuracy") or 0.0)
        best_meta = os.path.join(self.output_dir, f"{self.best_filename}{SUFFIX}.json")
        if os.path.exists(best_meta):
            with open(best_meta) as f:
                self.best_acc = max(self.best_acc, float(json.load(f).get("accuracy") or 0.0))
        print(f"Loaded checkpoint from epoch {restored['epoch']} "
              f"with accuracy {restored['accuracy']:.4f}")

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
            msg = (
                f"Epoch {epoch + 1}/{self.epochs} [{time.time() - t0:.1f}s]  "
                f"train loss {train_loss:.4f} acc {train_acc:.4f}  "
                f"test loss {test_loss:.4f} acc {test_acc:.4f}"
            )
            if self.log_lr:
                msg += f"  lr {self._current_lr():.6f}"
            print(msg)
        self.best_acc = best_acc
        print(f"\nTraining completed. Best test accuracy: {best_acc:.4f}")
        print(f"Training metrics saved to {self.metrics_csv_path}")
        return best_acc

    # -- inference --------------------------------------------------------

    @torch.no_grad()
    def predict(self, points: np.ndarray) -> np.ndarray:
        """Class predictions for a batch of clouds."""
        logits = self._eval_forward(to_device(np.asarray(points, np.float32), self.device))
        return logits.argmax(-1).cpu().numpy()
