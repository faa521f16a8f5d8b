"""Experiment-config snapshot (counterpart of ``pointvit_tpu/train/train_utils.py``)."""

from __future__ import annotations

import os
from datetime import datetime

__all__ = ["save_configs"]


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
