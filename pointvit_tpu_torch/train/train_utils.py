"""Experiment-config snapshot and the native loaders (counterpart of
``pointvit_tpu/train/train_utils.py``)."""

from __future__ import annotations

import os
from datetime import datetime

from pointvit_tpu_torch.data.loader import FastLoader
from pointvit_tpu_torch.data.native import BatchAugmenter, native_available

__all__ = ["native_loaders", "save_configs"]


def native_loaders(
    train_dataset,
    test_dataset,
    batch_size: int,
    dataset_config: dict,
    train_config: dict,
    seed: int = 0,
):
    """``FastLoader`` pairs over the batch augmenter for the standard
    (normalise + custom-augment) pipeline (``train_utils.py:11-52``), or
    (None, None) when ``train_config['native_pipeline']`` is False, the
    sampling mode needs per-item work, or the native library is missing.
    The Pix4Point and renderer trainers use them; the APF trainer builds
    its own with its dict transforms on top."""
    if not train_config.get("native_pipeline", True):
        return None, None
    if dataset_config.get("sampling_method", "all") not in ("all", "fps"):
        return None, None
    if not native_available():
        return None, None
    normalize = dataset_config.get("normalize", False)
    train_loader = FastLoader.for_dataset(
        train_dataset, batch_size,
        BatchAugmenter(
            normalize=normalize,
            custom=dataset_config.get("use_custom_augmentation", False),
            custom_prob=dataset_config.get("augmentation_probability", 0.2),
            seed=seed,
        ),
        shuffle=True, drop_last=True, seed=seed,
    )
    test_loader = FastLoader.for_dataset(
        test_dataset, batch_size, BatchAugmenter(normalize=normalize, seed=seed + 1), seed=seed + 1,
    )
    return train_loader, test_loader


def save_configs(
    model_config: dict,
    dataset_config: dict,
    train_config: dict,
    output_dir: str,
    device: str,
) -> str:
    """Write ``experiment_config_<timestamp>.txt`` with all three config
    dicts, in the JAX trainer's layout."""
    timestamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    config_path = os.path.join(output_dir, f"experiment_config_{timestamp}.txt")
    sections = (
        ("== MODEL CONFIGURATION ==", model_config),
        ("\n== DATASET CONFIGURATION ==", dataset_config),
        ("\n== TRAINING CONFIGURATION ==", train_config),
    )
    with open(config_path, "w") as f:
        f.write("======== EXPERIMENT CONFIGURATION ========\n\n")
        for title, cfg in sections:
            f.write(title + "\n")
            for key, value in cfg.items():
                f.write(f"{key}: {value}\n")
        f.write("\n== ENVIRONMENT ==\n")
        f.write(f"Device: {device}\n")
        f.write(f"Output directory: {output_dir}\n")
        f.write(f"Timestamp: {timestamp}\n")
    print(f"Configuration saved to {config_path}")
    return config_path
