"""APF trainer with the reference's config-dict API.

Counterpart of ``pointvit_tpu/train/apf_trainer.py`` (``apf_trainer.py:73-256``):
the same ``model_config`` / ``dataset_config`` / ``train_config`` keys, the
same dict-transform pipelines (scale → centre/normalise + heights → rotate
for train, centre/normalise for test), the timm cosine schedule with
warm-up, the trainable mask (ViT trunk frozen), label smoothing 0.3, the
native ``FastLoader`` branch, a learning-rate CSV column and ``model_best``
checkpoints, driving :class:`~pointvit_tpu_torch.train.trainer.Trainer`.

``pretrained`` (default True, as in JAX) raises: loading timm weights into
the trunk is not ported yet (ROADMAP A10), and training the frozen trunk
from random weights instead would silently give a different model.
"""

from __future__ import annotations

import numpy as np
import torch

from pointvit_tpu_torch.models.apf import AdaptPointFormer, apf_trainable_mask
from pointvit_tpu_torch.train.schedules import timm_cosine_schedule
from pointvit_tpu_torch.train.trainer import Trainer, build_optimizer

__all__ = ["APFTrainer"]


def _build_model(model_config: dict) -> AdaptPointFormer:
    """The APF construction of ``pointvit_tpu/models/factory.py::build_model``:
    ``bf16`` (default True) picks the compute dtype; parameters are f32."""
    if model_config.get("quantized", False):
        raise NotImplementedError("quantized=True is not ported yet (queue B item 10)")
    return AdaptPointFormer(
        num_classes=model_config["num_classes"],
        in_channels=model_config["in_channels"],
        embedding_dim=model_config.get("embedding_dim", 768),
        npoint=model_config.get("npoint", 196),
        nsample=model_config.get("nsample", 32),
        dropout_rate=model_config.get("dropout_rate", 0.1),
        # The reference reads drop_path_rate while its entry script supplies
        # dropout_path_rate: both spellings are honoured, as in JAX.
        dropout_path_rate=model_config.get(
            "drop_path_rate", model_config.get("dropout_path_rate", 0.1)
        ),
        depth=model_config.get("depth", 12),
        num_heads=model_config.get("num_heads", 12),
        dtype=torch.bfloat16 if model_config.get("bf16", True) else torch.float32,
        encoder_second_width=model_config.get("encoder_second_width"),
    )


class _TransformedDataset:
    """The APF dict-transform pipeline (+ optional heights channel) over a
    raw (points, label) dataset: the ModelNet40 adapter of the APF data
    path (ScanObjectNN applies its transforms itself)."""

    def __init__(self, base, transforms, use_height: bool = False):
        self.base = base
        self.transforms = transforms
        self.use_height = use_height
        # The attributes FastLoader relies on, with the first-num_points
        # protocol applied so vectorised slicing matches __getitem__.
        self.data = base.data[:, : base.num_points]
        self.labels = base.labels
        self.num_classes = base.num_classes
        self.sampling_method = "all"

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        points, label = self.base[idx]
        heights = None
        if self.transforms:
            data = {"xyz": points, "label": label}
            for fn in self.transforms:
                data = fn(data)
            points, label, heights = data["xyz"], data["label"], data.get("heights")
        if self.use_height and heights is not None:
            points = np.concatenate([points.astype(np.float32), heights.astype(np.float32)], axis=1)
        return points.astype(np.float32), label


class APFTrainer(Trainer):
    """Trainer for AdaptPointFormer on ScanObjectNN (or ModelNet40)."""

    def __init__(
        self,
        model_config: dict,
        dataset_config: dict,
        train_config: dict,
        device: str = "cuda",
        output_dir: str = "./output",
        seed: int = 0,
    ) -> None:
        if model_config.get("pretrained", True):
            raise NotImplementedError(
                "pretrained=True: loading timm ViT weights into the trunk is not ported "
                "yet (ROADMAP A10); pass pretrained=False to train from the seeded init"
            )
        # The datasets and transforms are the JAX package's numpy code.
        from pointvit_tpu.data.augment import (
            center_and_normalize_point_cloud,
            rotate_point_cloud,
            scale_point_cloud,
        )
        from pointvit_tpu_torch.data.scanobjectnn import ScanObjectNN

        model = _build_model(model_config)

        train_transforms = [scale_point_cloud, center_and_normalize_point_cloud, rotate_point_cloud]
        test_transforms = [center_and_normalize_point_cloud]
        use_height = dataset_config.get("use_height", False)
        if dataset_config.get("dataset", "scanobjectnn") == "modelnet40":
            from pointvit_tpu.data.modelnet40 import ModelNet40

            common = dict(normalize=dataset_config.get("normalize", False))
            train_dataset = _TransformedDataset(
                ModelNet40(
                    dataset_config["root_dir"], split="training",
                    num_points=dataset_config["train_num_points"],
                    use_custom_augmentation=dataset_config.get("use_custom_augmentation", False),
                    augmentation_probability=dataset_config.get("augmentation_probability", 0.5),
                    seed=seed, **common,
                ),
                train_transforms, use_height=use_height,
            )
            test_dataset = _TransformedDataset(
                ModelNet40(dataset_config["root_dir"], split="test",
                           num_points=dataset_config["test_num_points"], seed=seed + 1, **common),
                test_transforms, use_height=use_height,
            )
        else:
            common = dict(
                root_dir=dataset_config["root_dir"],
                variant=dataset_config["variant"],
                augmentation=dataset_config["augmentation"],
                background=dataset_config.get("background", False),
                use_newsplit=dataset_config.get("use_newsplit", False),
                normalize=dataset_config.get("normalize", False),
                sampling_method=dataset_config.get("sampling_method", "fps"),
                use_height=use_height,
                use_custom_augmentation=dataset_config.get("use_custom_augmentation", False),
                augmentation_probability=dataset_config.get("augmentation_probability", 0.0),
            )
            train_dataset = ScanObjectNN(
                split="training", num_points=dataset_config["train_num_points"],
                transform=train_transforms, seed=seed, **common,
            )
            test_dataset = ScanObjectNN(
                split="test", num_points=dataset_config["test_num_points"],
                transform=test_transforms, seed=seed + 1, **common,
            )

        epochs = train_config["epochs"]
        batch_size = train_config["batch_size"]
        steps_per_epoch = max(len(train_dataset) // batch_size, 1)
        schedule = timm_cosine_schedule(
            train_config["learning_rate"], epochs, steps_per_epoch,
            warmup_epochs=train_config.get("warmup_epochs", 10),
            warmup_lr_init=train_config.get("warmup_lr_init", 1e-3),
        )
        # Freeze the ViT trunk; train adapters, head, final norm and point
        # encoder (or the reference's exact frozen set with reference_quirks).
        mask = apf_trainable_mask(model, reference_quirks=model_config.get("reference_quirks", False))
        optimizer = build_optimizer(
            model, schedule, weight_decay=train_config["weight_decay"], trainable_mask=mask,
            betas=(0.9, 0.999), eps=1e-8,
        )

        # Batch-level native augmentation when the sampling mode allows
        # vectorised slicing; train_config['native_pipeline'] = False keeps
        # the per-item path.
        train_loader = test_loader = None
        if train_config.get("native_pipeline", True) and dataset_config.get(
            "sampling_method", "fps"
        ) in ("all", "fps"):
            from pointvit_tpu.data import BatchAugmenter, FastLoader, native_available

            if native_available():
                normalize = dataset_config.get("normalize", False)
                train_loader = FastLoader.for_dataset(
                    train_dataset, batch_size,
                    BatchAugmenter(
                        normalize=normalize,
                        custom=dataset_config.get("use_custom_augmentation", False),
                        custom_prob=dataset_config.get("augmentation_probability", 0.0),
                        apf_transforms=True, seed=seed,
                    ),
                    use_height=use_height, shuffle=True, drop_last=True, seed=seed,
                )
                test_loader = FastLoader.for_dataset(
                    test_dataset, batch_size,
                    BatchAugmenter(normalize=normalize, apf_test_transforms=True, seed=seed + 1),
                    use_height=use_height, seed=seed + 1,
                )

        super().__init__(
            model,
            train_dataset=train_dataset,
            test_dataset=test_dataset,
            optimizer=optimizer,
            schedule=schedule,
            batch_size=batch_size,
            epochs=epochs,
            label_smoothing=train_config.get("label_smoothing", 0.3),
            output_dir=output_dir,
            model_config=model_config,
            dataset_config=dataset_config,
            train_config=train_config,
            log_lr=True,
            best_filename="model_best",
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
