"""Training: the generic trainer, schedules, checkpoints, the APF trainer."""

from pointvit_tpu_torch.train.apf_trainer import APFTrainer
from pointvit_tpu_torch.train.schedules import (
    constant_schedule,
    cosine_annealing_schedule,
    timm_cosine_schedule,
    warmup_then_cosine_schedule,
)
from pointvit_tpu_torch.train.trainer import (
    MaskedAdamW,
    Trainer,
    TrainingDivergedError,
    build_optimizer,
    cross_entropy_loss,
    set_trainable,
)

__all__ = [
    "APFTrainer",
    "MaskedAdamW",
    "Trainer",
    "TrainingDivergedError",
    "build_optimizer",
    "constant_schedule",
    "cosine_annealing_schedule",
    "cross_entropy_loss",
    "set_trainable",
    "timm_cosine_schedule",
    "warmup_then_cosine_schedule",
]
