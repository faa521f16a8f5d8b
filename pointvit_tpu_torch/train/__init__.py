"""Training: the generic trainer, schedules, checkpoints, the APF,
Pix4Point and renderer trainers."""

from pointvit_tpu_torch.train.apf_trainer import APFTrainer
from pointvit_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pointvit_tpu_torch.train.pix4point_trainer import Pix4PointTrainer
from pointvit_tpu_torch.train.renderer_trainer import RendererTrainer
from pointvit_tpu_torch.train.schedules import (
    constant_schedule,
    cosine_annealing_schedule,
    timm_cosine_schedule,
    warmup_then_cosine_schedule,
)
from pointvit_tpu_torch.train.train_utils import native_loaders, save_configs
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
    "Pix4PointTrainer",
    "RendererTrainer",
    "Trainer",
    "TrainingDivergedError",
    "build_optimizer",
    "constant_schedule",
    "cosine_annealing_schedule",
    "cross_entropy_loss",
    "load_checkpoint",
    "native_loaders",
    "save_checkpoint",
    "save_configs",
    "set_trainable",
    "timm_cosine_schedule",
    "warmup_then_cosine_schedule",
]
