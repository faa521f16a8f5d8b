"""Port parity for Pix4Point training on the CPU: the P3 grouping with FPS
starts, the train-mode P3 stage, the ViT block's training forward, one
training step of the small Pix4Point against ``jax.value_and_grad`` and
optax, the trainable and no-decay masks, ``PointViT``'s options (C6) and
the Pix4Point trainer end to end.

Small sizes: E=128, depth 2, two heads of 64, k=8, 16 clouds of 128 points
(32 tokens + cls). f32 on both sides, the JAX side under
``jax.default_matmul_precision("highest")``, the JAX ``ClsHead`` dropout set
to 0 for the step (the port's too), so neither side draws random masks; FPS
starts at point 0 in the step. The port's grouping takes its packed-key kNN
at 128 points and JAX's CPU dispatch an exact top-k, so every case asserts
that its clouds have no near-tie at the k-th neighbour within the packed
key's resolution. Tolerances and why:

- tokens, block outputs and BatchNorm running statistics ≤ 1e-5 of the
  largest entry (a running mean after the step: of its BatchNorm's largest
  standard deviation), logits of whole models ≤ 1e-4: summation order only;
- loss ≤ 1e-5 relative; each trainable gradient ≤ 1e-4 relative L2
  (summation order, amplified by the train-mode BatchNorms of a 16-cloud
  batch). A bias that feeds a train-mode BatchNorm (and the final norm's
  bias, which reaches the head's first BatchNorm as a per-channel constant)
  has an exactly zero gradient; both sides compute rounding noise there,
  held to ≤ 1e-6 of the global gradient norm instead;
- parameters after the clipped, masked AdamW update ≤ 1e-5 of the largest
  entry, with the update applied to the same (JAX) gradients on both sides
  (see ``tests/test_torch_train.py`` for why).

The max over a group's k rows sends its gradient to the largest row, so
where two rows lie within the two sides' rounding of each other, the two
sides may send it to different rows and every gradient of the P3 stage
moves by ~1e-3 (seen on 16 clouds at seed 0; on 3 clouds, a near tie at
the first group max moved them by 0.5 against an f64 computation of the
same stage, which the port met within 2e-6). The step's clouds therefore
also assert that every positive group max of the train-mode stage leads
the next row by more than 1e-5 relative (:func:`_group_max_gap`): 16
clouds of 128 points hold 262,144 such maxima, and the seed was picked
from those whose gap passes.
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

import pointvit_tpu.models.pix4point as jp4p_module
from pointvit_tpu.data.synthetic import write_scanobjectnn_h5
from pointvit_tpu.models.pix4point import Pix4Point as JPix4Point
from pointvit_tpu.models.pix4point import PointViT as JPointViT
from pointvit_tpu.models.pix4point import pix4point_trainable_mask as jtrainable_mask
from pointvit_tpu.nn.heads import ClsHead as JClsHead
from pointvit_tpu.nn.pointnet import P3Embed as JP3Embed
from pointvit_tpu.nn.vit import ViTBlock as JBlock
from pointvit_tpu.ops import fps as jfps
from pointvit_tpu.ops import group as jgroup
from pointvit_tpu.train.pix4point_trainer import weight_decay_mask as jweight_decay_mask
from pointvit_tpu.train.trainer import build_optimizer as jbuild_optimizer
from pointvit_tpu.train.trainer import cross_entropy_loss as jcross_entropy
from pointvit_tpu_torch import convert
from pointvit_tpu_torch.models import Pix4Point, PointViT, pix4point_trainable_mask
from pointvit_tpu_torch.nn.layers import batch_norm, linear
from pointvit_tpu_torch.nn.pointnet import P3Embed
from pointvit_tpu_torch.nn.vit import ViTBlock
from pointvit_tpu_torch.ops.fps import farthest_point_sample
from pointvit_tpu_torch.ops.group import p3_group
from pointvit_tpu_torch.train import Pix4PointTrainer, schedules
from pointvit_tpu_torch.train.pix4point_trainer import no_decay_names
from pointvit_tpu_torch.train.trainer import build_optimizer, cross_entropy_loss

T = torch.from_numpy
CFG = dict(num_classes=10, embed_dim=128, depth=2, num_heads=2, k_neighbors=8)
N_POINTS, TOKENS, K, BATCH, LR, WD = 128, 32, 8, 16, 1e-3, 0.05
REL_TOL, LOGIT_REL_TOL = 1e-5, 1e-4
PACKED_KEY_RESOLUTION = 2.0**-12  # the key's stolen mantissa bits perturb by ≤ 2^-13 at N=128
HIGHEST = functools.partial(jax.default_matmul_precision, "highest")


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


def _clouds(seed, B=3, N=N_POINTS, starts=None):
    """Seeded clouds with no near-tie at the k-th neighbour of any FPS
    centre (from ``starts``, or point 0)."""
    points = np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)
    idx = np.asarray(farthest_point_sample(T(points), N // 4, starts, implementation="torch"))
    centers = points[np.arange(B)[:, None], idx]
    d = np.sort(((centers[:, :, None].astype(np.float64) - points[:, None]) ** 2).sum(-1), axis=-1)
    assert ((d[..., K] - d[..., K - 1]) / d[..., K]).min() > PACKED_KEY_RESOLUTION
    return points


def _group_max_gap(p3: P3Embed, points: np.ndarray) -> float:
    """The smallest relative gap between the largest and second-largest of
    the k rows at the train-mode P3 stage's two group maxima (g and the
    token), over the positive maxima: a near tie there sends the max's
    gradient to another row when the two sides' roundings differ, which
    moves every P3 gradient by ~1e-3."""
    def gap(h):
        top = h.topk(2, dim=-2).values
        t0, t1 = top[..., 0, :], top[..., 1, :]
        return ((t0 - t1) / t0)[t0 > 0].min().item()

    p3 = copy.deepcopy(p3)  # train-mode BatchNorm updates the running statistics
    pts = T(points)
    _, dp, fj = p3_group(pts, pts, pts.shape[1] // 4, p3.k)
    bn = lambda t, m: torch.relu(batch_norm(t, m, train=True))  # noqa: E731
    with torch.no_grad():
        h = bn(linear(linear(torch.cat([dp, fj], -1), p3.s0_conv1_0), p3.s0_conv1_1), p3.s0_conv1_bn)
        first = gap(h)
        h = torch.cat([h.amax(-2, keepdim=True).expand_as(h), h], -1)
        h = bn(linear(h, p3.s0_conv2_0), p3.s0_conv2_bn0)
        h = bn(linear(h, p3.s0_conv2_1), p3.s0_conv2_bn1)
    return min(first, gap(h))


def _live_norms(params, rng, E=128):
    """Live LayerNorm affines (the init is 1 and 0) in a flax params subtree."""
    for name, v in params.items():
        if name.startswith("norm") and "scale" in v:
            v["scale"] = (1 + 0.2 * rng.standard_normal(E)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(E)).astype(np.float32)
        elif isinstance(v, dict):
            _live_norms(v, rng, E)


# --------------------------------------------------------------- grouping


def test_p3_group_with_start_matches_the_jax_key():
    B, key = 3, jax.random.PRNGKey(7)
    start = np.array(jax.random.randint(key, (B,), 0, N_POINTS, dtype=jnp.int32))  # ops/fps.py:107
    points = _clouds(11, B, starts=T(start))
    feats = np.random.default_rng(12).standard_normal((B, N_POINTS, 4)).astype(np.float32)
    with HIGHEST():
        want_idx = jfps.farthest_point_sample(jnp.asarray(points), TOKENS, key=key)
        jc, jgp, jgf = jgroup.p3_group(jnp.asarray(points), jnp.asarray(feats), TOKENS, K, key=key)
    idx = farthest_point_sample(T(points), TOKENS, T(start))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert (idx[:, 0].numpy() == start).all()
    centers, gp, gf = p3_group(T(points), T(feats), TOKENS, K, start=T(start))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    _assert_rel(gp, jgp, 1e-6)
    _assert_rel(gf, jgf, 1e-6)
    assert not torch.equal(centers, p3_group(T(points), T(feats), TOKENS, K)[0])


# --------------------------------------------------------------- P3 stage


@pytest.mark.parametrize("layers", [4, 6])
def test_p3embed_train_matches_the_jax_module_and_its_batch_statistics(layers):
    rng = np.random.default_rng(layers)
    points = _clouds({4: 20, 6: 22}[layers])
    jmod = JP3Embed(k=K, layers=layers)
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(layers), jnp.asarray(points),
                                            jnp.asarray(points)))
    for v in variables["batch_stats"].values():  # live running statistics
        v["mean"] = 0.2 * rng.standard_normal(v["mean"].shape).astype(np.float32)
        v["var"] = (0.5 + rng.random(v["var"].shape)).astype(np.float32)
    with HIGHEST():
        (jc, jtok), upd = jax.jit(lambda v, p: jmod.apply(v, p, p, train=True,
                                                           mutable=["batch_stats"]))(
            variables, jnp.asarray(points))
    mod = convert.load_flax_variables(P3Embed(k=K, layers=layers), variables)
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    with torch.no_grad():
        centers, tokens = mod(T(points), T(points), train=True)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    _assert_rel(tokens, jtok)
    stats = _names({"batch_stats": _np_tree(upd["batch_stats"])}, mod.state_dict().keys())
    assert len(stats) == 2 * (layers // 2 + 1)
    for n, w in stats.items():
        got = mod.state_dict()[n]
        _assert_rel(got, w)
        assert not torch.equal(got, before[n]), f"{n} did not move"


def test_p3embed_draws_its_fps_starts_from_the_generator():
    points = T(_clouds(30))
    mod = P3Embed(k=K)
    run = lambda seed: mod(points, points, train=True,  # noqa: E731
                           generator=torch.Generator().manual_seed(seed))[0]
    a, b, c = run(0), run(0), run(1)
    start = torch.randint(0, N_POINTS, (3,), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, p3_group(points, points, TOKENS, K, start=start)[0])
    assert torch.equal(mod(points, points, train=True)[0], p3_group(points, points, TOKENS, K)[0])


# --------------------------------------------------------------- ViT block


def test_vit_block_train_matches_the_jax_block_and_its_vjp():
    rng = np.random.default_rng(40)
    E, S, H = 128, 33, 2
    x = rng.standard_normal((2, S, E)).astype(np.float32)
    pos = (0.5 * rng.standard_normal((2, S, E))).astype(np.float32)
    cot = rng.standard_normal((2, S, E)).astype(np.float32)
    jblk = JBlock(H)
    variables = _np_tree(jax.jit(jblk.init)(jax.random.PRNGKey(40), jnp.asarray(x)))
    _live_norms(variables["params"], rng)

    def fwd(params, t, q):
        return jblk.apply({"params": params}, t, pos=q, deterministic=False)

    with HIGHEST():
        want, vjp = jax.vjp(jax.jit(fwd), variables["params"], jnp.asarray(x), jnp.asarray(pos))
        jgp, jgx, jgpos = vjp(jnp.asarray(cot))
    blk = convert.load_flax_variables(ViTBlock(E, H), variables)
    xt, pt = T(x).requires_grad_(), T(pos).requires_grad_()
    got = blk(xt, pos=pt, train=True)
    _assert_rel(got.detach(), want)
    got.backward(T(cot))
    assert _rel_l2(xt.grad, jgx) <= 1e-4 and _rel_l2(pt.grad, jgpos) <= 1e-4
    jg = _names({"params": _np_tree(jgp)}, blk.state_dict().keys())
    for n, p in blk.named_parameters():
        assert _rel_l2(p.grad, jg[n]) <= 1e-4, n


def test_vit_block_dropout_draws_from_the_generator():
    blk = ViTBlock(128, 2, dropout_rate=0.1, drop_path_rate=0.1)
    x = torch.randn(4, 33, 128, generator=torch.Generator().manual_seed(0))
    run = lambda seed: blk(x, train=True, generator=torch.Generator().manual_seed(seed))  # noqa: E731
    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():  # no draws outside training
        _assert_rel(blk(x), blk.forward_unfused(x))


# --------------------------------------------------------------- one step


@pytest.fixture(scope="module")
def step():
    """One training step of the small Pix4Point on both sides."""
    rng = np.random.default_rng(0)
    points = _clouds(384, BATCH)
    labels = rng.integers(0, CFG["num_classes"], BATCH)
    head = functools.partial(JClsHead, dropout_rate=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp4p_module, "ClsHead", head)
        jmodel = JPix4Point(**CFG)
        variables = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)},
                                                  jnp.asarray(points[:1])))
        _live_norms(variables["params"], rng)

        def loss_fn(params):
            logits, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       jnp.asarray(points), train=True, mutable=["batch_stats"])
            loss = jnp.mean(jcross_entropy(logits.astype(jnp.float32), jnp.asarray(labels), 0.0))
            return loss, upd["batch_stats"]

        with HIGHEST():
            (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
            clip = 0.5 * float(optax.global_norm(jgrads))  # low enough to bind
            tx = jbuild_optimizer(optax.constant_schedule(LR), weight_decay=WD, grad_clip=clip,
                                  weight_decay_mask=jweight_decay_mask)
            updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
            jparams = optax.apply_updates(variables["params"], updates)

    model = convert.load_flax_variables(Pix4Point(**CFG), variables)
    model.cls_head.dropout.rate = 0.0
    assert _group_max_gap(model.model.patch_embed, points) > 1e-5
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(model, schedules.constant_schedule(LR), weight_decay=WD, grad_clip=clip,
                          no_decay=no_decay_names(model))
    logits = model(T(points), train=True)
    loss = cross_entropy_loss(logits, T(labels)).mean()
    loss.backward()
    keys = model.state_dict().keys()
    return dict(
        model=model, opt=opt, loss=loss.item(), before=before,
        grads={n: p.grad.clone() for n, p in model.named_parameters()},
        jloss=float(jloss), jgrads=_names({"params": _np_tree(jgrads)}, keys),
        jparams=_names({"params": _np_tree(jparams)}, keys),
        jstats=_names({"batch_stats": _np_tree(jstats)}, keys),
    )


def test_step_loss_matches_jax(step):
    assert abs(step["loss"] - step["jloss"]) <= 1e-5 * abs(step["jloss"])


def test_step_gradients_match_jax(step):
    want, got = step["jgrads"], step["grads"]
    assert set(got) == set(want)
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    pre_bn_bias = ("s0_conv1_1.bias", "cls_head.fc0.bias", "cls_head.fc1.bias", "model.norm.bias")
    degenerate = {n for n in got if n.endswith(pre_bn_bias)}
    assert len(degenerate) == 4
    for n in sorted(got):
        g, w = got[n].numpy(), want[n].numpy()
        if n in degenerate:
            assert np.linalg.norm(g) <= 1e-6 * total and np.linalg.norm(w) <= 1e-6 * total, n
            continue
        assert _rel_l2(g, w) <= 1e-4, f"{n}: relative L2 error {_rel_l2(g, w):.3g}"


def test_step_batch_statistics_match_jax(step):
    """Variances ≤ 1e-5 of the largest entry; a mean ≤ 1e-5 of its
    BatchNorm's largest standard deviation, the scale of the values it
    sums (the head's 16-row means nearly cancel: cls_head.bn1's lay
    1.06e-5 of their own largest entry)."""
    sd, want = step["model"].state_dict(), step["jstats"]
    assert len(want) == 10  # the P3 stage's 3 BatchNorms and the head's 2, mean and var
    for n, w in want.items():
        got, w = sd[n].numpy(), w.numpy()
        scale = (np.sqrt(want[n.replace("_mean", "_var")].numpy()).max() if n.endswith("_mean")
                 else np.abs(w).max())
        assert np.abs(got - w).max() <= 1e-5 * scale, n
        assert not np.array_equal(got, step["before"][n].numpy()), f"{n} did not move"


def test_clipped_masked_adamw_update_matches_optax(step):
    model, opt = step["model"], step["opt"]
    with torch.no_grad():
        model.load_state_dict(step["before"])
        for n, p in model.named_parameters():
            p.grad = step["jgrads"][n].clone()
    opt.step()
    sd = model.state_dict()
    for n, _ in model.named_parameters():
        _assert_rel(sd[n], step["jparams"][n])
        assert not torch.equal(sd[n], step["before"][n]), f"{n} did not move"


# --------------------------------------------------------------- masks


@pytest.mark.parametrize("frozen", [False, True])
def test_trainable_and_no_decay_names_equal_the_jax_masks(frozen):
    model = Pix4Point(**CFG)
    params = jax.eval_shape(lambda: JPix4Point(**CFG).init(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, N_POINTS, 3))))["params"]
    as_names = lambda mask: {n for n, m in _names(  # noqa: E731
        {"params": jax.tree.map(np.float32, mask)}, model.state_dict().keys()).items() if bool(m)}
    got = pix4point_trainable_mask(model, frozen=frozen)
    assert got == as_names(jtrainable_mask(params, frozen=frozen))
    trunk = {n for n, _ in model.named_parameters() if n.startswith(("model.blocks.", "model.norm."))}
    assert got.isdisjoint(trunk) == frozen and {"model.cls_token", "model.cls_pos"} <= got
    decayed = as_names(jweight_decay_mask(params))
    no_decay = no_decay_names(model)
    assert no_decay == {n for n, _ in model.named_parameters()} - decayed
    assert len(no_decay) == 32  # every bias, cls_token/cls_pos, every LayerNorm scale and bias
    assert "model.patch_embed.s0_conv1_bn.weight" not in no_decay  # BatchNorm scales decay


# --------------------------------------------------------------- C6


@pytest.mark.parametrize("global_features", ["cls", "max", "max,cls"])
def test_point_vit_options_match_the_jax_module(global_features):
    """``in_channels=4`` with a 4-channel ``features`` input, and each
    ``global_features`` order, against the JAX ``PointViT``."""
    rng = np.random.default_rng(50)
    points = _clouds(50)
    feats = rng.standard_normal((3, N_POINTS, 4)).astype(np.float32)
    kw = dict(embed_dim=128, depth=2, num_heads=2, k_neighbors=K, in_channels=4,
              global_features=global_features)
    jmod = JPointViT(**kw)
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(50), jnp.asarray(points),
                                            jnp.asarray(feats)))
    with HIGHEST():
        want = jax.jit(lambda v, p, f: jmod.apply(v, p, f))(variables, jnp.asarray(points),
                                                            jnp.asarray(feats))
    mod = convert.load_flax_variables(PointViT(**kw), variables).eval()
    with torch.inference_mode():
        got = mod(T(points), T(feats))
    assert mod.num_features == want.shape[-1] == 128 * len(global_features.split(","))
    _assert_rel(got, want, LOGIT_REL_TOL)


# --------------------------------------------------------------- the trainer


def test_pix4point_trainer_from_config_dicts(tmp_path):
    write_scanobjectnn_h5(str(tmp_path / "data"), num_train=8, num_test=8, num_points=64,
                          num_classes=2)
    model_config = dict(model_name="Pix4Point", num_classes=2, pretrained_model="vit_small_patch16_384",
                        k_neighbors=4, embed_dim=64, depth=1, num_heads=1, bf16=False)
    dataset_config = dict(root_dir=str(tmp_path / "data"), variant="main_split", augmentation="base",
                          num_points=64, normalize=True, sampling_method="all",
                          use_custom_augmentation=True)
    train_config = dict(epochs=1, batch_size=4, learning_rate=5e-4, weight_decay=5e-2, t_max=100,
                        warmup_epochs=10, min_lr=1e-6, grad_norm_clip=10)
    with pytest.raises(NotImplementedError, match="A10"):
        Pix4PointTrainer(model_config, dataset_config, train_config, device="cpu",
                         output_dir=str(tmp_path / "out"))
    runs = {}
    for frozen in (False, True):
        out = tmp_path / f"out_{frozen}"
        tr = Pix4PointTrainer({**model_config, "pretrained": False, "frozen": frozen},
                              dataset_config, train_config, device="cpu", output_dir=str(out))
        init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        runs[frozen] = tr.train()
        with open(out / "training_metrics.csv", newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["epoch", "train_loss", "train_accuracy", "test_loss", "test_accuracy"]
        assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1])
        assert tr.label_smoothing == 0.0 and tr.step == 2 and tr.optimizer.grad_clip == 10
        assert tr.train_dataset.data.shape[1:] == (64, 3)
        assert (out / "best_model.pt").exists() and runs[frozen] > 0.0
        moved = {n for n, p in tr.model.named_parameters() if not torch.equal(p, init[n])}
        trunk = {n for n in init if n.startswith(("model.blocks.", "model.norm."))}
        if frozen:
            assert moved.isdisjoint(trunk) and {"model.cls_token", "cls_head.out.weight"} <= moved
        else:
            assert {"model.blocks.0.attn.qkv.weight", "model.norm.weight"} <= moved
