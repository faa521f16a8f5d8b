"""Port parity for renderer-classifier serving on the CPU: the whole model's
logits and view angles against the JAX model on bridged weights, with the
learned views (``diff_renderer=True``: view-transformation network and
bilinear splat) and with the fixed camera ring (amax raster); the patchify
weight's layout through the weight bridge; the factory at the full
``train_renderer.py`` configuration; the serving session.

Small sizes: a ViT preset of patch 8, E=128, two blocks of two heads (head
dim 64), registered in both packages' preset tables for the test; 32×32
images, 2 views, adapter bottleneck 16, 128 points. f32 parity is to 1e-4
relative to the largest logit (the render, two blocks and the head, which
differ in summation order only) and 1e-5 for single modules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.models import factory as jfactory
from pointvit_tpu.models import renderer as jrenderer
from pointvit_tpu.nn.vit import ImageViT as JImageViT
from pointvit_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from pointvit_tpu_torch.models import PointCloudRendererClassifier, build_model
from pointvit_tpu_torch.models import renderer
from pointvit_tpu_torch.nn.vit import ImageViT
from pointvit_tpu_torch.serve import InferenceSession

T = torch.from_numpy
PRESET = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2)
CFG = dict(num_classes=15, vit_name="vit_tiny_test", adapter_dim=16, num_views=2, img_size=32,
           view_transform_hidden=16)
N_POINTS = 128
REL_TOL = 1e-5
LOGIT_REL_TOL = 1e-4
# train_renderer.py's model_config (vit_b_16, 6 learned views, 224² images)
RENDERER_CFG = {"num_classes": 15, "vit_name": "vit_b_16", "adapter_dim": 64, "num_views": 6,
                "img_size": 224, "pretrained": True, "dropout_rate": 0.1, "diff_renderer": True,
                "view_transform_hidden": 256}


def _assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


def _clouds(seed, B=3):
    """Clouds scaled into the unit sphere, as the dataset's normalisation."""
    pts = np.random.default_rng(seed).standard_normal((B, N_POINTS, 3)).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1).max(axis=1)[:, None, None]


def _live(tree, rng):
    """Random values for every leaf but the BatchNorm statistics' and the
    LN/BN scales' (near 1): zero-init adapters, cls token and heads would
    hide faults."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _live(v, rng)
        elif k == "scale":
            tree[k] = (1 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            tree[k] = (rng.standard_normal(v.shape) * fan_in**-0.5).astype(np.float32)
        elif k == "mean":
            tree[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "var":
            tree[k] = (0.5 + rng.random(v.shape)).astype(np.float32)
        else:
            tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        for table in (jrenderer.TORCHVISION_VIT_PRESETS, renderer.TORCHVISION_VIT_PRESETS):
            mp.setitem(table, "vit_tiny_test", PRESET)
        yield


@pytest.fixture(scope="module", params=[True, False], ids=["learned_views", "fixed_views"])
def case(request):
    cfg = {**CFG, "diff_renderer": request.param}
    points = _clouds(0)
    jmodel = jrenderer.PointCloudRendererClassifier(**cfg)
    variables = jax.tree.map(lambda a: np.array(a, np.float32),
                             jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(points[:1])))
    _live(variables, np.random.default_rng(2))
    model = load_flax_variables(PointCloudRendererClassifier(**cfg), variables).eval()
    return cfg, points, jmodel, variables, model


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_logits_match_the_jax_model(case, implementation):
    cfg, points, jmodel, variables, model = case
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p))(variables, jnp.asarray(points)))
    if implementation:
        plain = PointCloudRendererClassifier(**cfg, implementation=implementation)
        plain.load_state_dict(model.state_dict())
        model = plain.eval()
    with torch.inference_mode():
        got = model(T(points)).numpy()
    assert got.shape == (3, CFG["num_classes"]) and np.isfinite(got).all()
    _assert_rel(got, want, LOGIT_REL_TOL)


def test_bf16_model_tracks_f32(case):
    """The port's bf16 logits lie no further from JAX's f32 ones than JAX's
    own bf16 model's do, within a factor 1.5 (bf16 rounds at other points
    in the two frameworks)."""
    cfg, points, jmodel, variables, model = case
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p))(variables, jnp.asarray(points)))
    jbf = jrenderer.PointCloudRendererClassifier(**cfg, dtype=jnp.bfloat16)
    jax_bf16 = np.asarray(jax.jit(lambda v, p: jbf.apply(v, p))(variables, jnp.asarray(points)),
                          np.float32)
    bf = PointCloudRendererClassifier(**cfg, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    with torch.inference_mode():
        got = bf.eval()(T(points))
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    err = np.abs(got.float().numpy() - want).max() / scale
    jax_err = np.abs(jax_bf16 - want).max() / scale
    assert err <= 1.5 * jax_err, (err, jax_err)


def test_views_and_angles_match_the_jax_model(case):
    cfg, points, jmodel, variables, model = case
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(variables, jnp.asarray(points), method=jmodel.render_views)
    with torch.inference_mode():
        views = model.render_views(T(points))
        assert views.shape == (3, 2, 32, 32) and (views > 0).any()
        _assert_rel(views, want)
        if not cfg["diff_renderer"]:
            with pytest.raises(ValueError, match="diff_renderer"):
                model.predict_views(T(points))
            return
        az, el = model.predict_views(T(points))
    jaz, jel = jmodel.apply(variables, jnp.asarray(points), method=jmodel.predict_views)
    _assert_rel(az, jaz)
    _assert_rel(el, jel)
    assert az.abs().max() <= 180 and el.abs().max() <= 60


def test_view_transformation_network_starts_on_the_camera_ring():
    vtn = renderer.ViewTransformationNetwork(num_views=6, hidden_dim=16).eval()
    az, el = vtn(T(_clouds(3)))
    ring_az = np.tanh(np.deg2rad([0, 60, 120, 180, 240, 300])) * np.pi
    ring_el = np.tanh(np.deg2rad([0, 30, -30, 0, 0, 0])) * np.pi / 3
    np.testing.assert_allclose(az.detach().numpy(), np.broadcast_to(ring_az, (3, 6)), rtol=1e-6)
    np.testing.assert_allclose(el.detach().numpy(), np.broadcast_to(ring_el, (3, 6)), rtol=1e-6,
                               atol=1e-7)


def test_patchify_weight_keeps_the_flatten_order_of_the_jax_kernel():
    """The flax patchify kernel is (P, P, C, E). A plain transpose would give
    (E, C, Pw, Ph), the shape of a ``Conv2d`` weight with its spatial axes
    swapped; the bridge flattens it in (ph, pw, c) order instead. Held with a
    random kernel that no axis swap leaves unchanged."""
    rng = np.random.default_rng(4)
    jvit = JImageViT(depth=1, embed_dim=128, num_heads=2, patch_size=8, adapter_bottleneck=16)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jax.tree.map(lambda a: np.array(a, np.float32),
                             jvit.init(jax.random.PRNGKey(4), jnp.asarray(images)))
    kernel = rng.standard_normal((8, 8, 3, 128)).astype(np.float32)
    assert not np.allclose(kernel, kernel.transpose(1, 0, 2, 3))
    variables["params"]["conv_proj"]["kernel"] = kernel
    vit = load_flax_variables(ImageViT(1, 128, 2, 8, 32, 16), variables).eval()
    np.testing.assert_array_equal(vit.conv_proj.weight.detach().numpy(), kernel.reshape(-1, 128).T)
    with jax.default_matmul_precision("highest"):
        want = jvit.apply(variables, jnp.asarray(images))
    with torch.inference_mode():
        _assert_rel(vit(T(images)), want)
        _assert_rel(vit.conv_proj(T(images)), jnp.asarray(images).reshape(2, 4, 8, 4, 8, 3).transpose(
            0, 1, 3, 2, 4, 5).reshape(2, 16, -1) @ kernel.reshape(-1, 128)
            + variables["params"]["conv_proj"]["bias"])


def test_build_model_builds_the_jax_architecture_at_full_size():
    jm = jfactory.build_model({**RENDERER_CFG, "bf16": False})
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2048, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = build_model(RENDERER_CFG)
    assert isinstance(model, PointCloudRendererClassifier) and model.dtype == torch.bfloat16
    assert jfactory.detect_family(RENDERER_CFG) == "renderer"
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    bridged = {k: tuple(v.shape) for k, v in flax_to_state_dict(variables, own.keys()).items()}
    assert own == bridged
    assert own["vit.conv_proj.weight"] == (768, 768) and own["vit.pos_embedding"] == (1, 197, 768)
    assert len(model.vit.encoder_layer) == 12
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_session_padding_and_chunking_match_one_forward(case):
    _, _, _, _, model = case
    clouds = _clouds(5, B=5)
    with torch.inference_mode():
        want = model(T(clouds)).numpy()
    sess = InferenceSession(model, buckets=(2, 4), device="cpu")
    for n in (1, 3, 5):  # pad to 2, pad to 4, chunks 4 + 1
        np.testing.assert_allclose(sess.predict_logits(clouds[:n]), want[:n], rtol=1e-5, atol=1e-5)


def test_what_is_not_ported_raises():
    model = PointCloudRendererClassifier(**CFG, diff_renderer=True)
    logits = model(T(_clouds(6, B=2)), train=True, generator=torch.Generator().manual_seed(0))
    assert logits.shape == (2, CFG["num_classes"]) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="ViT model"):
        PointCloudRendererClassifier(**{**CFG, "vit_name": "vit_h_14"})
    with pytest.raises(ValueError, match="implementation"):
        PointCloudRendererClassifier(**CFG, implementation="xla")
