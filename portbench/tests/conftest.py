"""Fixtures of the benchmark's tests: tiny copies of the cells' files for
the CPU, and ``card``, which skips a test on a machine without a CUDA card
(the tests marked ``cuda`` run on the card)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny(config: str, traffic: str) -> tuple[dict, dict]:
    """The cell's configuration and traffic at a size the CPU runs in
    seconds: the same families, paths and checks, narrower and shallower."""
    c = copy.deepcopy(_json(HERE / "configs" / f"{config}.json"))
    t = copy.deepcopy(_json(HERE / "traffic" / f"{traffic}.json"))
    if c["family"] == "apf":
        c["model"].update(embedding_dim=64, num_heads=4, npoint=32, depth=2,
                          encoder_second_width=32, num_classes=10)
    else:
        c["model"].update(embed_dim=64, num_heads=4, depth=2, num_classes=5)
    c["points"] = 256
    for spec in c.get("marks", {}).values():
        spec["marks"] = [[p.replace("blocks.11", "blocks.1"), w] for p, w in spec["marks"]]
    if t["kind"] == "train":
        t.update(batch=8, train_set=64)
    else:
        t.update(pool=32, warm_s=0.2, clients=min(t["clients"], 4))
        t.update({"batch": 8} if t["kind"] == "batch" else {"max_batch": 8})
    return c, t


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
