"""Trainer checkpoints with ``torch.save``, under the JAX trainer's names.

Counterpart of ``pointvit_tpu/train/checkpoint.py``. A checkpoint holds
what the JAX one holds (``checkpoint.py:105-116``): the epoch, the model's
``state_dict`` (parameters and BatchNorm statistics), the optimizer state,
the update count, the EMA tensors when the trainer keeps them, and the test
accuracy; a JSON sidecar ``<file>.json`` carries the epoch, accuracy and the
model and dataset configs. File names follow the JAX trainer's, with the
``.pt`` suffix of a torch file in place of ``.msgpack``: ``model_best.pt``
on a new best test accuracy, ``model_epoch_<N>.pt`` every ``save_interval``
epochs. Both files are written to a temporary name and renamed, so a reader
never sees half a file. Reading the JAX trainer's msgpack files is not
ported yet (ROADMAP A1).
"""

from __future__ import annotations

import json
import os

import torch

__all__ = ["SUFFIX", "save_checkpoint", "load_checkpoint"]

SUFFIX = ".pt"


def save_checkpoint(
    output_dir: str,
    filename: str,
    *,
    epoch: int,
    accuracy: float,
    state: dict,
    model_config: dict,
    dataset_config: dict,
) -> str:
    """Write ``state`` (a dict of tensors, state dicts and ints) with the
    epoch and accuracy to ``output_dir/filename``; returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    payload = {"epoch": int(epoch), "accuracy": float(accuracy), **state}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta = {
        "epoch": int(epoch),
        "accuracy": float(accuracy),
        "model_config": model_config,
        "dataset_config": dataset_config,
    }
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    os.replace(path + ".json.tmp", path + ".json")
    return path


def load_checkpoint(path: str, map_location=None) -> dict:
    """The dict :func:`save_checkpoint` wrote, with the sidecar under
    ``"meta"`` when it exists."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            payload["meta"] = json.load(f)
    return payload
