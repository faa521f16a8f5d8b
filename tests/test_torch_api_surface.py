"""The port's public surface against the JAX package's: every name in the
``__all__`` of ``pointvit_tpu.models``, ``.ops``, ``.train``,
``.pretrained``, ``.nn``, ``.parallel``, ``.data`` and ``.utils`` has a
counterpart of the same name in the port's package, or is listed below with
the ROADMAP item that will bring it (and ROADMAP.md names it there), or is
left out by design (and ROADMAP.md's "Not ported, by design" paragraph
names it and says why). Also the C6 names themselves against JAX, and
every field of each class in the JAX ``nn.__all__`` against the port's
constructor keywords."""

import dataclasses
import importlib
import inspect
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
    "ops": {},
    "train": {},
    "pretrained": {},
    "nn": {},
    "parallel": {},
    "data": {},
    "utils": {},
}
# JAX names the port leaves out by design: the port keeps a trainer's state
# in the module's and the optimizer's state dicts, not in a flax struct.
BY_DESIGN = {"models": set(), "ops": set(), "train": {"TrainState"}, "pretrained": set(),
             "nn": set(), "parallel": set(), "data": set(), "utils": set()}


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


# Fields of the JAX ``nn`` modules that the port's constructors leave out,
# with the reason. The port's layers compute in their input's dtype (the
# blocks and encoders, which cast their input, keep ``dtype``); the JAX
# ``implementation='xla'`` is the port's ``implementation='torch'``, a value
# and not a keyword, so it needs no entry.
NN_FIELDS_BY_DESIGN = {
    ("Attention", "dtype"): "computes in x's dtype; the block casts x",
    ("Mlp", "dtype"): "computes in x's dtype; the block casts x",
    ("AdapterLayer", "dtype"): "computes in x's dtype; the block casts x",
    ("SimpleAdapter", "dtype"): "computes in x's dtype; the block casts x",
    ("ClassificationHead", "dtype"): "computes in the trunk's output dtype",
    ("ClsHead", "dtype"): "computes in the trunk's output dtype",
    ("RendererHead", "dtype"): "computes in the trunk's output dtype",
}
FLAX_FIELDS = {"parent", "name"}


def _jax_nn_classes():
    jnn = importlib.import_module("pointvit_tpu.nn")
    return sorted(n for n in jnn.__all__
                  if inspect.isclass(getattr(jnn, n)) and dataclasses.is_dataclass(getattr(jnn, n)))


@pytest.mark.parametrize("name", _jax_nn_classes())
def test_every_field_of_a_jax_nn_class_is_a_port_keyword_or_listed(name):
    jcls = getattr(importlib.import_module("pointvit_tpu.nn"), name)
    port = getattr(importlib.import_module("pointvit_tpu_torch.nn"), name)
    fields = {f.name for f in dataclasses.fields(jcls)} - FLAX_FIELDS
    keywords = set(inspect.signature(port.__init__).parameters)
    listed = {f for (cls, f) in NN_FIELDS_BY_DESIGN if cls == name}
    assert fields - keywords == listed, name
    assert not listed & keywords, name  # a listed field the port now takes
