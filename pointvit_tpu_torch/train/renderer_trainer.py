"""Renderer-classifier trainer with the reference's config-dict API.

Counterpart of ``pointvit_tpu/train/renderer_trainer.py``: the same
``model_config`` / ``dataset_config`` / ``train_config`` keys, ScanObjectNN
train and test splits (seeds ``seed`` and ``seed + 1``), a constant
learning rate or, with ``use_lr_scheduler``, cosine annealing, AdamW with
weight decay on every trainable parameter and optional global-norm clipping
(``clip_grad_norm``; 0 clips nothing), only the adapters trained inside the
ViT (:func:`~pointvit_tpu_torch.models.renderer_trainable_mask`), plain
cross-entropy, no learning-rate CSV column, ``best_model`` checkpoints and
the native loaders, driving :class:`~pointvit_tpu_torch.train.trainer.Trainer`.
Every ``save_views_interval`` epochs an epoch hook renders the first test
cloud from all views and saves the views as a PNG grid under
``<output_dir>/rendered_views/`` (when matplotlib is installed).

``pretrained`` (default True, as in JAX) raises: loading torchvision ViT
weights into the trunk is not ported yet (ROADMAP A10), and training from
random weights instead would silently give a different model.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pointvit_tpu_torch.data.loader import to_device
from pointvit_tpu_torch.data.scanobjectnn import ScanObjectNN
from pointvit_tpu_torch.models.factory import build_model
from pointvit_tpu_torch.models.renderer import renderer_trainable_mask
from pointvit_tpu_torch.train.schedules import constant_schedule, cosine_annealing_schedule
from pointvit_tpu_torch.train.train_utils import native_loaders
from pointvit_tpu_torch.train.trainer import Trainer, build_optimizer

__all__ = ["RendererTrainer", "renderer_optimizer"]


def renderer_optimizer(model: torch.nn.Module, train_config: dict, steps_per_epoch: int) -> tuple:
    """The schedule and the optimizer the trainer builds
    (``renderer_trainer.py:79-103``): ``learning_rate`` constant, or with
    ``use_lr_scheduler`` cosine annealing over ``epochs`` down to ``min_lr``
    (1e-6); AdamW with ``weight_decay`` on every trainable parameter,
    gradients clipped to ``clip_grad_norm`` (none when 0 or absent), and
    only :func:`~pointvit_tpu_torch.models.renderer_trainable_mask` trained."""
    if train_config.get("use_lr_scheduler", False):
        schedule = cosine_annealing_schedule(
            train_config["learning_rate"], train_config["epochs"], steps_per_epoch,
            min_lr=train_config.get("min_lr", 1e-6),
        )
    else:
        schedule = constant_schedule(train_config["learning_rate"])
    optimizer = build_optimizer(
        model, schedule,
        weight_decay=train_config["weight_decay"],
        grad_clip=train_config.get("clip_grad_norm") or None,
        trainable_mask=renderer_trainable_mask(model),
    )
    return schedule, optimizer


class RendererTrainer(Trainer):
    """Trainer for PointCloudRendererClassifier on ScanObjectNN."""

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
                "pretrained=True: loading torchvision ViT weights into the trunk is not ported "
                "yet (ROADMAP A10); pass pretrained=False to train from the seeded init"
            )
        model = build_model(model_config, "renderer")

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
        schedule, optimizer = renderer_optimizer(
            model, train_config, max(len(train_dataset) // batch_size, 1))

        self.save_views_interval = train_config.get("save_views_interval", 5)
        self.views_dir = os.path.join(output_dir, "rendered_views")
        os.makedirs(self.views_dir, exist_ok=True)

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
            epoch_hooks=(_save_views_hook,),
            prefetch=train_config.get("prefetch", 2),
            nan_guard=train_config.get("nan_guard"),
            grad_accum=train_config.get("grad_accum", 1),
            ema_decay=train_config.get("ema_decay"),
            ema_eval=train_config.get("ema_eval", True),
            fsdp=train_config.get("fsdp", False),
        )

    # -- rendered-view observability --------------------------------------

    def save_rendered_views(self, points: np.ndarray, epoch: int) -> str | None:
        """Render the views of the first cloud of ``points`` and save them as
        a PNG grid; returns its path, or None without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # matplotlib is optional
            return None

        with torch.no_grad():
            views = self.model.render_views(to_device(np.asarray(points[:1], np.float32),
                                                      self.device))
        views = views[0].float().cpu().numpy()  # (V, H, W)

        num_views = views.shape[0]
        cols = min(num_views, 3)
        rows = int(np.ceil(num_views / 3))
        fig = plt.figure(figsize=(cols * 4, rows * 4))
        for i in range(num_views):
            ax = fig.add_subplot(rows, cols, i + 1)
            ax.imshow(np.clip(views[i], 0, 1), cmap="gray")
            ax.axis("off")
            ax.set_title(f"View {i}")
        fig.tight_layout()
        path = os.path.join(self.views_dir, f"test_views_epoch_{epoch}.png")
        fig.savefig(path)
        plt.close(fig)
        print(f"Test rendered views saved to {path}")
        return path

    def get_predicted_views(self, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The learned view angles of ``points`` in degrees, each (B, V)."""
        with torch.no_grad():
            az, el = self.model.predict_views(to_device(np.asarray(points, np.float32),
                                                        self.device))
        return az.float().cpu().numpy(), el.float().cpu().numpy()


def _save_views_hook(trainer: RendererTrainer, epoch: int) -> None:
    if epoch % trainer.save_views_interval == 0 and len(trainer.test_dataset) > 0:
        points, _ = trainer.test_dataset[0]
        trainer.save_rendered_views(points[None], epoch)
