"""Learning-rate schedules, as plain functions ``step → lr``.

Counterparts of ``pointvit_tpu/train/schedules.py``, formula for formula.
The reference trainers step their schedulers once per epoch, so each
schedule quantises the global step to its epoch: the lr is constant within
an epoch. Values are Python floats (the JAX versions compute in f32, so the
two agree to f32 rounding).
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = [
    "timm_cosine_schedule",
    "warmup_then_cosine_schedule",
    "cosine_annealing_schedule",
    "constant_schedule",
]

Schedule = Callable[[int], float]


def timm_cosine_schedule(
    base_lr: float,
    epochs: int,
    steps_per_epoch: int,
    warmup_epochs: int = 10,
    warmup_lr_init: float = 1e-3,
    min_lr: float = 0.0,
) -> Schedule:
    """timm ``CosineLRScheduler(t_initial=epochs, warmup_t, warmup_lr_init)``
    as the APF trainer uses it: linear warm-up from ``warmup_lr_init`` to
    ``base_lr`` over ``warmup_epochs``, then cosine from ``base_lr`` to
    ``min_lr`` over the whole ``epochs`` horizon (warm-up epochs count in
    the cosine's progress)."""

    def schedule(step: int) -> float:
        t = float(min(int(step) // steps_per_epoch, epochs - 1))
        if t < warmup_epochs:
            return warmup_lr_init + t * (base_lr - warmup_lr_init) / max(warmup_epochs, 1)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t / epochs))

    return schedule


def warmup_then_cosine_schedule(
    base_lr: float,
    steps_per_epoch: int,
    warmup_epochs: int,
    t_max: int,
    min_lr: float = 1e-6,
) -> Schedule:
    """torch ``SequentialLR(LambdaLR((e+1)/warmup), CosineAnnealingLR(t_max))``
    (the Pix4Point trainer); the cosine phase is clamped at ``t_max``."""

    def schedule(step: int) -> float:
        epoch = float(int(step) // steps_per_epoch)
        if epoch < warmup_epochs:
            return base_lr * (epoch + 1.0) / max(warmup_epochs, 1)
        t = min(max(epoch - warmup_epochs, 0.0), float(t_max))
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t / t_max))

    return schedule


def cosine_annealing_schedule(
    base_lr: float, epochs: int, steps_per_epoch: int, min_lr: float = 1e-6
) -> Schedule:
    """torch ``CosineAnnealingLR(T_max=epochs)`` (the renderer trainer)."""

    def schedule(step: int) -> float:
        epoch = min(float(int(step) // steps_per_epoch), float(epochs))
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * epoch / epochs))

    return schedule


def constant_schedule(base_lr: float) -> Schedule:
    def schedule(step: int) -> float:
        return float(base_lr)

    return schedule
