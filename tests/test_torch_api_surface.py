"""The port's public surface against the JAX package's: every name in the
``__all__`` of ``pointvit_tpu.models``, ``.ops``, ``.train``,
``.pretrained``, ``.nn`` and ``.parallel`` has a
counterpart of the same name in the port's package, or is listed below with
the ROADMAP item that will bring it (and ROADMAP.md names it there), or is
left out by design (and ROADMAP.md's "Not ported, by design" paragraph
names it and says why). Also the C6 names themselves against JAX."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.models import apf_serving_preset as japf_serving_preset
from pointvit_tpu.ops import knn_group as jknn_group
from pointvit_tpu_torch.models import AdaptPointFormer, apf_serving_preset
from pointvit_tpu_torch.ops import knn_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX names with no port counterpart yet, by the ROADMAP item that brings them.
NOT_PORTED = {
    "models": {},
    "ops": {"fps_sampling_with_knn": "A12", "benchmark_fps_implementations": "A12"},
    "train": {},
    "pretrained": {},
    "nn": {},
    "parallel": {},
}
# JAX names the port leaves out by design: the port keeps a trainer's state
# in the module's and the optimizer's state dicts, not in a flax struct.
BY_DESIGN = {"models": set(), "ops": set(), "train": {"TrainState"}, "pretrained": set(),
             "nn": set(), "parallel": set()}


def _roadmap_item(item: str) -> str:
    """The text of ROADMAP.md's queue-A entry for ``item`` (e.g. 'A9')."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    found = re.search(rf"^\d+\. \*\*{item}\b.*?(?=\n\d+\. \*\*A|\n### )", text, re.S | re.M)
    assert found, f"ROADMAP.md has no entry {item}"
    return found.group(0)


def _by_design_paragraph() -> str:
    """ROADMAP.md's paragraph on what is not ported by design."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    found = re.search(r"^\*\*Not ported, by design\.\*\*.*?(?=\n\n)", text, re.S | re.M)
    assert found, "ROADMAP.md has no 'Not ported, by design' paragraph"
    return found.group(0)


@pytest.mark.parametrize("package", sorted(NOT_PORTED))
def test_every_jax_export_has_a_port_counterpart_or_a_roadmap_item(package):
    jax_names = set(importlib.import_module(f"pointvit_tpu.{package}").__all__)
    port = importlib.import_module(f"pointvit_tpu_torch.{package}")
    assert all(hasattr(port, name) for name in port.__all__)
    assert jax_names - set(port.__all__) == set(NOT_PORTED[package]) | BY_DESIGN[package]
    for name, item in NOT_PORTED[package].items():
        assert f"`{name}`" in _roadmap_item(item), (name, item)
    by_design = _by_design_paragraph()
    for name in BY_DESIGN[package]:
        assert f"`{name}`" in by_design, name


def test_apf_serving_preset_matches_jax():
    for overrides in ({}, {"npoint": 128, "encoder_second_width": None}):
        want = japf_serving_preset(**overrides)
        got = apf_serving_preset(**overrides)
        assert want.pop("dtype") == jnp.bfloat16 and got.pop("dtype") == torch.bfloat16
        assert got == want
    assert AdaptPointFormer(**apf_serving_preset(depth=1)).point_encoder.second_width == 768


def test_knn_group_matches_jax():
    rng = np.random.default_rng(0)
    points = rng.standard_normal((2, 100, 3)).astype(np.float32)
    centers = points[:, :10].copy()
    feats = rng.standard_normal((2, 100, 5)).astype(np.float32)
    want = jknn_group(jnp.asarray(points), jnp.asarray(centers), jnp.asarray(feats), 6)
    got = knn_group(torch.from_numpy(points), torch.from_numpy(centers), torch.from_numpy(feats), 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][:, :, 0].numpy(), centers)  # absolute coordinates
