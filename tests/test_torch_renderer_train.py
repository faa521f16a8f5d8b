"""Port parity for renderer-classifier training on the CPU: the view
network's train-mode BatchNorms, the gradients of the splat and of the
differentiable render, the serial-adapter block's training forward and its
``jax.vjp``, one training step of the small classifier with learned and
with fixed views against ``jax.value_and_grad`` and optax, the trainable
mask, the optimizer the trainer builds and the renderer trainer end to end.

Small sizes: the tiny ViT preset of ``tests/test_torch_renderer.py`` (patch
8, E=128, two blocks of two heads, adapter bottleneck 16), 32×32 images, 2
views, view-network width 16, 4 clouds of 128 points scaled into the unit
sphere. f32 on both sides, the JAX side under
``jax.default_matmul_precision("highest")``; weights through the bridge,
made live by ``_live`` (zero-init view heads and adapter up projections
would give every layer below them an exactly zero gradient, which holds
nothing). The head's dropout is 0 on both sides in the step, so neither
draws random masks. Tolerances and why:

- angles, block outputs and BatchNorm running statistics ≤ 1e-5 of the
  largest entry (a running mean: of its BatchNorm's largest standard
  deviation), the loss ≤ 1e-5 relative, render gradients ≤ 1e-5 relative
  L2: summation order only;
- each trainable gradient of the step ≤ 1e-4 relative L2 (summation order
  through two blocks, the patchify, the splat and the view network's
  train-mode BatchNorms on 4 clouds). The biases ``view_transform_net.enc{0,
  1,2}.bias`` each feed a train-mode BatchNorm, so their gradients are
  exactly zero: both sides compute rounding noise there, held to ≤ 1e-6 of
  the global gradient norm instead;
- parameters after the masked AdamW update ≤ 1e-5 of the largest entry,
  with the update applied to the same (JAX) gradients on both sides.

A max over points sends its gradient to the largest point, and the hat
weights of the splat have kinks at integer pixel offsets: where two points
lie within the two sides' rounding of each other, or a pixel coordinate
within rounding of an integer, the two sides may send a gradient elsewhere.
So the step asserts that every positive point maximum of the view network
leads the next by more than 1e-5 relative and that no pixel coordinate
lies within 1e-4 of an integer (:func:`_margins`).
"""

import copy
import csv
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_renderer import CFG, N_POINTS, PRESET, _clouds, _live

from pointvit_tpu.data.synthetic import write_scanobjectnn_h5
from pointvit_tpu.models import renderer as jrenderer
from pointvit_tpu.nn.vit import SerialAdapterBlock as JBlock
from pointvit_tpu.ops import render as jrender
from pointvit_tpu.train import schedules as jschedules
from pointvit_tpu.train.trainer import build_optimizer as jbuild_optimizer
from pointvit_tpu.train.trainer import cross_entropy_loss as jcross_entropy
from pointvit_tpu_torch import convert
from pointvit_tpu_torch.models import (
    PointCloudRendererClassifier,
    ViewTransformationNetwork,
    renderer,
    renderer_trainable_mask,
)
from pointvit_tpu_torch.nn.layers import batch_norm, linear
from pointvit_tpu_torch.nn.vit import ImageViT, SerialAdapterBlock
from pointvit_tpu_torch.ops import render
from pointvit_tpu_torch.train import RendererTrainer
from pointvit_tpu_torch.train.renderer_trainer import renderer_optimizer
from pointvit_tpu_torch.train.trainer import cross_entropy_loss

T = torch.from_numpy
BATCH, LR, WD = 4, 1e-3, 0.05
REL_TOL = 1e-5
HIGHEST = functools.partial(jax.default_matmul_precision, "highest")
PRE_BN_BIASES = tuple(f"view_transform_net.enc{i}.bias" for i in range(3))


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        for table in (jrenderer.TORCHVISION_VIT_PRESETS, renderer.TORCHVISION_VIT_PRESETS):
            mp.setitem(table, "vit_tiny_test", PRESET)
        yield


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _names(tree, target_keys):
    """A flax tree's leaves, keyed by the port's state_dict names."""
    return convert.flax_to_state_dict(tree, target_keys)


def _assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


def _rel_l2(got, want):
    return np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(np.asarray(want))


def _pixel_margin(points_2d: torch.Tensor, size: int) -> float:
    """The least distance of a pixel coordinate of the splat to an integer."""
    pix = (points_2d.double() + 1.0) * 0.5 * size - 0.5
    return (pix - pix.round()).abs().min().item()


def _margins(model: PointCloudRendererClassifier, points: np.ndarray) -> tuple[float, float]:
    """The smallest relative lead of a positive point maximum over the next
    point in the train-mode view network, and the least distance of a pixel
    coordinate of the learned views to an integer."""
    vtn = copy.deepcopy(model.view_transform_net)  # train mode updates the statistics
    pts = T(points)
    with torch.no_grad():
        x = pts
        for i in range(3):
            x = torch.relu(batch_norm(linear(x, getattr(vtn, f"enc{i}")),
                                      getattr(vtn, f"enc_bn{i}"), train=True))
        top = x.topk(2, dim=1).values
        lead = ((top[:, 0] - top[:, 1]) / top[:, 0])[top[:, 0] > 0].min().item()
        az, el = vtn(pts, train=True)
        B, N, _ = pts.shape
        flat = pts[:, None].expand(B, model.num_views, N, 3).reshape(-1, N, 3)
        rotated = render.rotate_az_el(flat, az.reshape(-1), el.reshape(-1))
    return lead, _pixel_margin(rotated[..., :2], model.img_size)


# --------------------------------------------------------------- view network


def test_view_transformation_network_train_matches_the_jax_module():
    rng = np.random.default_rng(10)
    points = _clouds(10, B=BATCH)
    jmod = jrenderer.ViewTransformationNetwork(num_views=2, hidden_dim=16)
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(10), jnp.asarray(points)))
    _live(variables, rng)
    with HIGHEST():
        (jaz, jel), upd = jax.jit(lambda v, p: jmod.apply(v, p, train=True,
                                                           mutable=["batch_stats"]))(
            variables, jnp.asarray(points))
    mod = convert.load_flax_variables(ViewTransformationNetwork(2, 16), variables)
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    with torch.no_grad():
        az, el = mod(T(points), train=True)
    _assert_rel(az, jaz)
    _assert_rel(el, jel)
    stats = _names({"batch_stats": _np_tree(upd["batch_stats"])}, mod.state_dict().keys())
    assert len(stats) == 6
    for n, w in stats.items():
        got = mod.state_dict()[n]
        _assert_rel(got, w)
        assert not torch.equal(got, before[n]), f"{n} did not move"
    with torch.no_grad():  # inference keeps the running statistics
        assert not torch.equal(mod(T(points))[0], az)


# --------------------------------------------------------------- render gradients


@pytest.mark.parametrize("which", ["splat_bilinear", "render_diff_views"])
def test_render_gradients_match_the_jax_vjp(which):
    rng = np.random.default_rng(20)
    S, B, N = 32, 3, 96
    cot = rng.standard_normal((B, S, S)).astype(np.float32)
    if which == "splat_bilinear":
        inputs = (rng.uniform(-1.0, 1.0, (B, N, 2)).astype(np.float32),  # some straddle the border
                  rng.uniform(0.3, 1.0, (B, N)).astype(np.float32))
        assert _pixel_margin(T(inputs[0]), S) > 1e-4
        jfn, fn = (lambda p, f: jrender.splat_bilinear(p, f, S)), (
            lambda p, f: render.splat_bilinear(p, f, S))
    else:
        inputs = (_clouds(21, B=B)[:, :N].copy(), rng.uniform(-np.pi, np.pi, B).astype(np.float32),
                  rng.uniform(-np.pi / 3, np.pi / 3, B).astype(np.float32))
        with torch.no_grad():
            rotated = render.rotate_az_el(*map(T, inputs))
        assert _pixel_margin(rotated[..., :2], S) > 1e-4
        jfn, fn = (lambda p, a, e: jrender.render_diff_views(p, a, e, S)), (
            lambda p, a, e: render.render_diff_views(p, a, e, S))
    with HIGHEST():
        want, vjp = jax.vjp(jax.jit(jfn), *map(jnp.asarray, inputs))
        jgrads = vjp(jnp.asarray(cot))
    args = [T(a).requires_grad_() for a in inputs]
    got = fn(*args)
    _assert_rel(got.detach(), want)
    got.backward(T(cot))
    for a, g in zip(args, jgrads):
        assert np.abs(np.asarray(g)).max() > 0
        assert _rel_l2(a.grad, g) <= REL_TOL, _rel_l2(a.grad, g)


# --------------------------------------------------------------- serial block


def test_serial_block_train_matches_the_jax_block_and_its_vjp():
    rng = np.random.default_rng(30)
    E, S, H = 128, 17, 2
    x = rng.standard_normal((2, S, E)).astype(np.float32)
    cot = rng.standard_normal((2, S, E)).astype(np.float32)
    jblk = JBlock(H, adapter_bottleneck=16)
    variables = _np_tree(jax.jit(jblk.init)(jax.random.PRNGKey(30), jnp.asarray(x)))
    _live(variables, rng)

    def fwd(params, t):
        return jblk.apply({"params": params}, t, deterministic=False)

    with HIGHEST():
        want, vjp = jax.vjp(jax.jit(fwd), variables["params"], jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(cot))
    blk = convert.load_flax_variables(SerialAdapterBlock(E, H, 16), variables)
    xt = T(x).requires_grad_()
    got = blk(xt, train=True)
    _assert_rel(got.detach(), want)
    got.backward(T(cot))
    assert _rel_l2(xt.grad, jgx) <= 1e-4
    jg = _names({"params": _np_tree(jgp)}, blk.state_dict().keys())
    for n, p in blk.named_parameters():
        assert _rel_l2(p.grad, jg[n]) <= 1e-4, n


@pytest.mark.parametrize("module", ["block", "vit"])
def test_dropout_draws_from_the_generator(module):
    gen = torch.Generator().manual_seed(0)
    if module == "block":
        mod = SerialAdapterBlock(128, 2, 16, dropout_rate=0.1)
        x = torch.randn(2, 17, 128, generator=gen)
    else:
        mod = ImageViT(2, 128, 2, 8, 32, 16, dropout_rate=0.1)
        x = torch.rand(2, 32, 32, 3, generator=gen)
    run = lambda seed: mod(x, train=True, generator=torch.Generator().manual_seed(seed))  # noqa: E731
    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():  # no draws outside training
        assert torch.equal(mod(x), mod(x))
        if module == "block":
            _assert_rel(mod(x), mod.forward_unfused(x))


# --------------------------------------------------------------- one step


@pytest.fixture(scope="module", params=[True, False], ids=["learned_views", "fixed_views"])
def step(request):
    """One training step of the small renderer classifier on both sides."""
    cfg = {**CFG, "diff_renderer": request.param, "dropout_rate": 0.0}
    rng = np.random.default_rng(40)
    points = _clouds(41, B=BATCH)
    labels = rng.integers(0, cfg["num_classes"], BATCH)
    jmodel = jrenderer.PointCloudRendererClassifier(**cfg)
    variables = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(40), jnp.asarray(points[:1])))
    _live(variables, rng)
    stats = variables.get("batch_stats", {})

    def loss_fn(params):
        logits, upd = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(points),
                                   train=True, mutable=["batch_stats"])
        loss = jnp.mean(jcross_entropy(logits.astype(jnp.float32), jnp.asarray(labels), 0.0))
        return loss, upd.get("batch_stats", {})

    mask = jrenderer.renderer_trainable_mask(variables["params"])
    with HIGHEST():
        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        trainable = jax.tree.map(lambda g, m: g if m else jnp.zeros_like(g), jgrads, mask)
        clip = 0.5 * float(optax.global_norm(trainable))  # low enough to bind
        jparams = {}
        for c in (None, clip):
            tx = jbuild_optimizer(optax.constant_schedule(LR), weight_decay=WD, grad_clip=c,
                                  trainable_mask=mask)
            update = jax.jit(lambda g, p, tx=tx: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
            jparams[c] = update(jgrads, variables["params"])

    model = convert.load_flax_variables(PointCloudRendererClassifier(**cfg), variables)
    if cfg["diff_renderer"]:
        lead, margin = _margins(model, points)
        assert lead > 1e-5 and margin > 1e-4, (lead, margin)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    set_mask = renderer_trainable_mask(model)
    for n, p in model.named_parameters():
        p.requires_grad_(n in set_mask)
    logits = model(T(points), train=True)
    loss = cross_entropy_loss(logits, T(labels)).mean()
    loss.backward()
    keys = model.state_dict().keys()
    return dict(
        cfg=cfg, variables=variables, points=points, labels=labels,
        model=model, loss=loss.item(), before=before, clip=clip,
        grads={n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
        jloss=float(jloss), jgrads=_names({"params": _np_tree(jgrads)}, keys),
        jmask=_names({"params": jax.tree.map(np.float32, mask)}, keys),
        jparams={c: _names({"params": _np_tree(p)}, keys) for c, p in jparams.items()},
        jstats=_names({"batch_stats": _np_tree(jstats)}, keys),
    )


def test_step_loss_matches_jax(step):
    assert abs(step["loss"] - step["jloss"]) <= REL_TOL * abs(step["jloss"])


def test_step_gradients_match_jax(step):
    want, got = step["jgrads"], step["grads"]
    assert set(got) == {n for n, m in step["jmask"].items() if bool(m)}
    learned = step["model"].diff_renderer
    assert any(n.startswith("view_transform_net.") for n in got) == learned
    total = np.sqrt(sum(float((want[n] ** 2).sum()) for n in got))
    degenerate = set(PRE_BN_BIASES) & set(got)
    assert len(degenerate) == (3 if learned else 0)
    for n in sorted(got):
        g, w = got[n].numpy(), want[n].numpy()
        if n in degenerate:
            assert np.linalg.norm(g) <= 1e-6 * total and np.linalg.norm(w) <= 1e-6 * total, n
            continue
        assert np.abs(g).max() > 0, f"{n}: no gradient"
        assert _rel_l2(g, w) <= 1e-4, f"{n}: relative L2 error {_rel_l2(g, w):.3g}"


def test_step_batch_statistics_match_jax(step):
    """Variances ≤ 1e-5 of the largest entry; a mean ≤ 1e-5 of its
    BatchNorm's largest standard deviation, the scale of the values it
    sums."""
    sd, want = step["model"].state_dict(), step["jstats"]
    assert len(want) == (6 if step["model"].diff_renderer else 0)
    for n, w in want.items():
        got, w = sd[n].numpy(), w.numpy()
        scale = (np.sqrt(want[n.replace("_mean", "_var")].numpy()).max() if n.endswith("_mean")
                 else np.abs(w).max())
        assert np.abs(got - w).max() <= 1e-5 * scale, n
        assert not np.array_equal(got, step["before"][n].numpy()), f"{n} did not move"


@pytest.mark.parametrize("clipped", [False, True], ids=["no_clip", "clip"])
def test_masked_adamw_update_matches_optax(step, clipped):
    model = step["model"]
    clip = step["clip"] if clipped else None
    _, opt = renderer_optimizer(model, dict(learning_rate=LR, weight_decay=WD, epochs=1,
                                            clip_grad_norm=clip or 0.0), 1)
    assert opt.grad_clip == clip
    with torch.no_grad():
        model.load_state_dict(step["before"])
        for n, p in model.named_parameters():
            p.grad = step["jgrads"][n].clone() if p.requires_grad else None
    opt.step()
    sd = model.state_dict()
    want = step["jparams"][clip]
    for n, p in model.named_parameters():
        if p.requires_grad:
            _assert_rel(sd[n], want[n])
            assert not torch.equal(sd[n], step["before"][n]), f"{n} did not move"
        else:
            assert torch.equal(sd[n], step["before"][n]) and torch.equal(want[n], sd[n]), n


def test_bf16_step_tracks_f32_as_the_jax_bf16_step_does(step):
    """The port's bf16 step (bf16 view network, images, blocks and head; f32
    splat) lies no further from JAX's f32 gradients than JAX's own bf16 step
    does, within a factor 1.5 (bf16 rounds at other points in the two
    frameworks), over the view network's, the ViT adapters' and the head's
    gradients and over all of them together: bf16 moves the view network's
    gradients far from f32 in both frameworks, so the card's bf16 training
    gates hold the kernel path by its ratio to f32. The view aggregation's
    gradient (one entry a view) sums to zero through the softmax, so its
    entries are differences of nearly equal sums that bf16 rounds at other
    points in the two frameworks; it is held within the whole."""
    cfg, variables = step["cfg"], step["variables"]
    points, labels = step["points"], step["labels"]
    jmodel = jrenderer.PointCloudRendererClassifier(**cfg, dtype=jnp.bfloat16)

    def loss_fn(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": variables.get("batch_stats", {})},
                                 jnp.asarray(points), train=True, mutable=["batch_stats"])
        return jnp.mean(jcross_entropy(logits.astype(jnp.float32), jnp.asarray(labels), 0.0))

    with HIGHEST():
        jbf16 = _names({"params": _np_tree(jax.jit(jax.grad(loss_fn))(variables["params"]))},
                       step["model"].state_dict().keys())
    model = convert.load_flax_variables(
        PointCloudRendererClassifier(**cfg, dtype=torch.bfloat16), variables)
    mask = renderer_trainable_mask(model)
    for n, p in model.named_parameters():
        p.requires_grad_(n in mask)
    cross_entropy_loss(model(T(points), train=True), T(labels)).mean().backward()
    got = {n: p.grad.float() for n, p in model.named_parameters() if p.requires_grad}
    want = step["jgrads"]
    parts = ("view_transform_net.", "vit.", "classifier.", "")
    for part in parts[0 if cfg["diff_renderer"] else 1:]:
        names = sorted(n for n in got if n.startswith(part) and n not in PRE_BN_BIASES)
        flat = lambda g: torch.cat([g[n].float().flatten() for n in names]).numpy()  # noqa: E731
        err, jax_err = _rel_l2(flat(got), flat(want)), _rel_l2(flat(jbf16), flat(want))
        assert err <= 1.5 * jax_err, (part, err, jax_err)


# --------------------------------------------------------------- mask, optimizer


@pytest.mark.parametrize("diff_renderer", [True, False])
def test_trainable_mask_equals_the_jax_mask(diff_renderer):
    cfg = {**CFG, "diff_renderer": diff_renderer}
    model = PointCloudRendererClassifier(**cfg)
    params = jax.eval_shape(lambda: jrenderer.PointCloudRendererClassifier(**cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, N_POINTS, 3))))["params"]
    mask = _names({"params": jax.tree.map(np.float32, jrenderer.renderer_trainable_mask(params))},
                  model.state_dict().keys())
    got = renderer_trainable_mask(model)
    assert got == {n for n, m in mask.items() if bool(m)}
    vit = {n for n, _ in model.named_parameters() if n.startswith("vit.")}
    assert got & vit == {n for n in vit if "adapter" in n} and len(got & vit) == 16
    assert {"view_aggregation", "classifier.out.weight"} <= got
    assert any(n.startswith("view_transform_net.") for n in got) == diff_renderer


def test_renderer_optimizer_reads_the_train_config():
    model = PointCloudRendererClassifier(**CFG)
    cfg = dict(learning_rate=5e-4, weight_decay=5e-2, epochs=3, clip_grad_norm=0.0)
    schedule, opt = renderer_optimizer(model, cfg, 4)
    assert opt.grad_clip is None and [schedule(s) for s in (0, 5, 11)] == [5e-4] * 3
    assert {g["weight_decay"] for g in opt.optimizer.param_groups} == {5e-2}  # no decay mask
    schedule, opt = renderer_optimizer(model, {**cfg, "use_lr_scheduler": True, "min_lr": 1e-5,
                                               "clip_grad_norm": 2.0}, 4)
    want = jschedules.cosine_annealing_schedule(5e-4, 3, 4, min_lr=1e-5)
    assert opt.grad_clip == 2.0
    np.testing.assert_allclose([schedule(s) for s in range(14)],
                               [float(want(s)) for s in range(14)], rtol=1e-6)
    assert {n for n, p in model.named_parameters() if p.requires_grad} == renderer_trainable_mask(model)


# --------------------------------------------------------------- the trainer


def test_renderer_trainer_from_config_dicts(tmp_path):
    write_scanobjectnn_h5(str(tmp_path / "data"), num_train=8, num_test=8, num_points=64,
                          num_classes=2)
    model_config = dict(num_classes=2, vit_name="vit_tiny_test", adapter_dim=16, num_views=2,
                        img_size=32, dropout_rate=0.1, diff_renderer=True,
                        view_transform_hidden=16, bf16=False)
    dataset_config = dict(root_dir=str(tmp_path / "data"), variant="main_split", augmentation="base",
                          num_points=64, normalize=True, sampling_method="all",
                          use_custom_augmentation=True)
    train_config = dict(epochs=1, batch_size=4, learning_rate=5e-4, weight_decay=5e-2,
                        use_lr_scheduler=False, clip_grad_norm=0.0, save_views_interval=1)
    with pytest.raises(NotImplementedError, match="A10"):
        RendererTrainer(model_config, dataset_config, train_config, device="cpu",
                        output_dir=str(tmp_path / "refused"))
    out = tmp_path / "out"
    tr = RendererTrainer({**model_config, "pretrained": False}, dataset_config, train_config,
                         device="cpu", output_dir=str(out))
    init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    best = tr.train()
    with open(out / "training_metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "train_loss", "train_accuracy", "test_loss", "test_accuracy"]
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1])
    assert tr.label_smoothing == 0.0 and tr.step == 2 and tr.optimizer.grad_clip is None
    assert (out / "best_model.pt").exists() and best > 0.0
    assert (out / "rendered_views" / "test_views_epoch_0.png").exists()
    moved = {n for n, p in tr.model.named_parameters() if not torch.equal(p, init[n])}
    frozen = {n for n in init if n.startswith("vit.") and "adapter" not in n}
    assert frozen and moved.isdisjoint(frozen)
    assert {"view_transform_net.pred0.weight", "vit.encoder_layer.0.adapter1.down_proj.weight",
            "classifier.out.weight", "view_aggregation"} <= moved
    points = tr.test_dataset.data[:3]
    az, el = tr.get_predicted_views(points)
    with torch.no_grad():
        want = tr.model.predict_views(T(np.asarray(points, np.float32)))
    np.testing.assert_array_equal(az, want[0].numpy())
    np.testing.assert_array_equal(el, want[1].numpy())
    assert az.shape == (3, 2) and np.abs(az).max() <= 180 and np.abs(el).max() <= 60
