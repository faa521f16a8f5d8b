"""Pix4Point trainer with the reference's config-dict API.

Counterpart of ``pointvit_tpu/train/pix4point_trainer.py``: the same
``model_config`` / ``dataset_config`` / ``train_config`` keys, ScanObjectNN
train and test splits (seeds ``seed`` and ``seed + 1``), linear warm-up then
cosine annealing, AdamW with global-norm clipping from ``grad_norm_clip``
and the reference's no-decay groups, the ViT trunk frozen with
``frozen``, plain cross-entropy, no learning-rate CSV column, ``best_model``
checkpoints and the native loaders, driving
:class:`~pointvit_tpu_torch.train.trainer.Trainer`.

``pretrained`` (default True, as in JAX) raises: loading timm weights into
the trunk is not ported yet (ROADMAP A10), and training from random weights
instead would silently give a different model.
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch.data.scanobjectnn import ScanObjectNN
from pointvit_tpu_torch.models.factory import build_model
from pointvit_tpu_torch.models.pix4point import pix4point_trainable_mask
from pointvit_tpu_torch.train.schedules import warmup_then_cosine_schedule
from pointvit_tpu_torch.train.train_utils import native_loaders
from pointvit_tpu_torch.train.trainer import Trainer, build_optimizer

__all__ = ["Pix4PointTrainer", "no_decay_names", "pix4point_optimizer"]


def no_decay_names(model: torch.nn.Module) -> set[str]:
    """Names of the parameters AdamW does not decay, the port's counterpart
    of the JAX ``weight_decay_mask`` (``pix4point_trainer.py:25-43``): every
    bias, ``cls_token`` and ``cls_pos``, and every parameter with ``norm``
    in its name. BatchNorm scales still decay, as in the reference, whose
    BatchNorms have no ``norm`` in their names."""
    return {
        name for name, _ in model.named_parameters()
        if name.split(".")[-1] == "bias" or "cls_token" in name or "cls_pos" in name
        or "norm" in name
    }


def pix4point_optimizer(model: torch.nn.Module, train_config: dict, steps_per_epoch: int, *,
                        frozen: bool = False) -> tuple:
    """The schedule and the optimizer the trainer builds
    (``pix4point_trainer.py:80-107``): warm-up then cosine from
    ``learning_rate`` (``warmup_epochs`` 10, ``t_max``, ``min_lr`` 1e-6),
    AdamW with ``weight_decay`` off for :func:`no_decay_names`, gradients
    clipped to ``grad_norm_clip``, and with ``frozen`` the trunk frozen
    (:func:`~pointvit_tpu_torch.models.pix4point_trainable_mask`)."""
    schedule = warmup_then_cosine_schedule(
        train_config["learning_rate"], steps_per_epoch,
        warmup_epochs=train_config.get("warmup_epochs", 10),
        t_max=train_config["t_max"],
        min_lr=train_config.get("min_lr", 1e-6),
    )
    optimizer = build_optimizer(
        model, schedule,
        weight_decay=train_config["weight_decay"],
        grad_clip=train_config.get("grad_norm_clip"),
        trainable_mask=pix4point_trainable_mask(model, frozen=frozen),
        no_decay=no_decay_names(model),
    )
    return schedule, optimizer


class Pix4PointTrainer(Trainer):
    """Trainer for Pix4Point on ScanObjectNN."""

    def __init__(
        self,
        model_config: dict,
        dataset_config: dict,
        train_config: dict,
        device: str = "cuda",
        output_dir: str = "./output_pix4point",
        seed: int = 0,
    ) -> None:
        if model_config.get("pretrained", True):
            raise NotImplementedError(
                "pretrained=True: loading timm ViT weights into the trunk is not ported "
                "yet (ROADMAP A10); pass pretrained=False to train from the seeded init"
            )
        model = build_model(model_config, "pix4point")

        common = dict(
            root_dir=dataset_config["root_dir"],
            variant=dataset_config["variant"],
            augmentation=dataset_config["augmentation"],
            num_points=dataset_config["num_points"],
            normalize=dataset_config["normalize"],
            sampling_method=dataset_config.get("sampling_method", "all"),
            device=device,
        )
        train_dataset = ScanObjectNN(
            split="training",
            use_custom_augmentation=dataset_config.get("use_custom_augmentation", False),
            seed=seed, **common,
        )
        test_dataset = ScanObjectNN(split="test", use_custom_augmentation=False, seed=seed + 1,
                                    **common)

        batch_size = train_config["batch_size"]
        schedule, optimizer = pix4point_optimizer(
            model, train_config, max(len(train_dataset) // batch_size, 1),
            frozen=model_config.get("frozen", False),
        )
        train_loader, test_loader = native_loaders(
            train_dataset, test_dataset, batch_size, dataset_config, train_config, seed
        )

        super().__init__(
            model,
            train_dataset=train_dataset,
            test_dataset=test_dataset,
            optimizer=optimizer,
            schedule=schedule,
            batch_size=batch_size,
            epochs=train_config["epochs"],
            label_smoothing=0.0,
            output_dir=output_dir,
            model_config=model_config,
            dataset_config=dataset_config,
            train_config=train_config,
            log_lr=False,
            best_filename="best_model",
            save_interval=train_config.get("save_interval", 0),
            save_best=train_config.get("save_best", True),
            seed=seed,
            device=device,
            train_loader=train_loader,
            test_loader=test_loader,
            prefetch=train_config.get("prefetch", 2),
            nan_guard=train_config.get("nan_guard"),
            grad_accum=train_config.get("grad_accum", 1),
            ema_decay=train_config.get("ema_decay"),
            ema_eval=train_config.get("ema_eval", True),
            fsdp=train_config.get("fsdp", False),
        )
