"""Port parity for APF training on the CPU: one training step of the small
APF against the JAX package on bridged weights, the trainable mask, the
schedules, dropout and drop-path, and the Trainer end to end.

The step is compared in f32 with dropout and drop-path at 0 and FPS
starting at point 0 (a JAX PRNG stream cannot be reproduced in torch), the
JAX side under ``jax.default_matmul_precision("highest")``. Tolerances and
why:

- loss ≤ 1e-5 relative: the two differ in summation order only;
- each trainable gradient ≤ 1e-4 in relative L2 norm: summation order,
  amplified by the train-mode BatchNorms of a 16-cloud batch. A bias that
  feeds a train-mode BatchNorm (and the final norm's bias, which reaches the
  head's first BatchNorm as a per-channel constant) has an exactly zero
  gradient; both sides compute rounding noise there, so those are held to
  ≤ 1e-6 of the global gradient norm instead;
- BatchNorm running statistics after the step ≤ 1e-5 of the largest entry;
- parameters after the masked AdamW update ≤ 1e-5 of the largest entry,
  with the update applied to the same (JAX) gradients on both sides: on a
  first Adam step each element moves by ±lr·g/(|g|+eps), so an element whose
  gradient is at the rounding-noise level could flip sign between two
  correct implementations. optax computes the bias corrections in f32
  (1 − 0.999 rounds 1.3e-5 away from its f64 value), which leaves a 6.8e-6
  relative difference;
- frozen parameters bit-equal.
"""

import csv
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import pointvit_tpu.models.apf as japf_module
import pointvit_tpu.train.schedules as jsched
from pointvit_tpu.data.synthetic import make_shape_clouds, write_scanobjectnn_h5
from pointvit_tpu.models.apf import AdaptPointFormer as JAPF
from pointvit_tpu.models.apf import apf_trainable_mask as japf_mask
from pointvit_tpu.nn.heads import ClassificationHead as JHead
from pointvit_tpu.train.trainer import build_optimizer as jbuild_optimizer
from pointvit_tpu.train.trainer import cross_entropy_loss as jcross_entropy
from pointvit_tpu_torch import convert
from pointvit_tpu_torch.models import AdaptPointFormer, apf_trainable_mask
from pointvit_tpu_torch.nn.layers import Dropout, DropPath, batch_norm, linear
from pointvit_tpu_torch.train import schedules
from pointvit_tpu_torch.train.trainer import (
    Trainer,
    build_optimizer,
    clip_by_global_norm,
    cross_entropy_loss,
)

CFG = dict(num_classes=10, embedding_dim=64, npoint=16, nsample=8, in_channels=3, depth=2,
           num_heads=4, encoder_second_width=64, dropout_rate=0.0, dropout_path_rate=0.0)
N_POINTS, BATCH, LR, WD, SMOOTH = 128, 16, 1e-3, 0.05, 0.3
T = torch.from_numpy
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _names(tree, target_keys):
    """A flax tree's leaves, keyed by the port's state_dict names."""
    return convert.flax_to_state_dict(tree, target_keys)


@pytest.fixture(scope="module")
def step():
    """One training step of the small APF on both sides."""
    rng = np.random.default_rng(0)
    points = rng.standard_normal((BATCH, N_POINTS, 3)).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], BATCH)
    # The JAX head's dropout is fixed at 0.4; set it to 0 for this process so
    # both sides run the step without random masks.
    head = functools.partial(JHead, dropout_rate=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japf_module, "ClassificationHead", head)
        jmodel = JAPF(**CFG)
        variables = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)},
                                                  jnp.asarray(points[:1])))
        for i in range(CFG["depth"]):  # live adapters: up_proj is zero at init
            ad = variables["params"][f"blocks_{i}"]["adapter"]
            ad["up_proj"]["kernel"] = 0.1 * rng.standard_normal(ad["up_proj"]["kernel"].shape
                                                                ).astype(np.float32)
        mask = japf_mask(variables["params"])
        tx = jbuild_optimizer(optax.constant_schedule(LR), weight_decay=WD, trainable_mask=mask)

        def loss_fn(params):
            logits, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       jnp.asarray(points), train=True, mutable=["batch_stats"])
            loss = jnp.mean(jcross_entropy(logits.astype(jnp.float32), jnp.asarray(labels), SMOOTH))
            return loss, upd["batch_stats"]

        with jax.default_matmul_precision("highest"):
            (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
            updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
            jparams = optax.apply_updates(variables["params"], updates)

    model = convert.load_flax_variables(AdaptPointFormer(**CFG), variables)
    model.head.dropout.rate = 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    names = apf_trainable_mask(model)
    opt = build_optimizer(model, schedules.constant_schedule(LR), weight_decay=WD,
                          trainable_mask=names)
    logits = model(T(points), train=True)
    loss = cross_entropy_loss(logits, T(labels), SMOOTH).mean()
    loss.backward()
    keys = model.state_dict().keys()
    return dict(
        model=model, opt=opt, names=names, loss=loss.item(), before=before,
        grads={n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
        jloss=float(jloss), jgrads=_names({"params": _np_tree(jgrads)}, keys),
        jparams=_names({"params": _np_tree(jparams)}, keys),
        jstats=_names({"batch_stats": _np_tree(jstats)}, keys),
    )


def test_step_loss_matches_jax(step):
    assert abs(step["loss"] - step["jloss"]) <= 1e-5 * abs(step["jloss"])


def test_step_gradients_match_jax(step):
    want = step["jgrads"]
    assert set(step["grads"]) == step["names"]
    total = np.sqrt(sum(float((want[n] ** 2).sum()) for n in step["names"]))
    pre_bn_bias = ("first_0.bias", "first_1.bias", "first_2.bias", "second_0_global.bias",
                   "head.fc0.bias", "head.fc1.bias", "encoder_norm.bias")
    degenerate = {n for n in step["names"] if n.endswith(pre_bn_bias)}
    assert len(degenerate) == 7
    for n in sorted(step["names"]):
        got, w = step["grads"][n].numpy(), want[n].numpy()
        if n in degenerate:
            assert np.linalg.norm(got) <= 1e-6 * total and np.linalg.norm(w) <= 1e-6 * total, n
            continue
        err = np.linalg.norm(got - w) / np.linalg.norm(w)
        assert err <= 1e-4, f"{n}: relative L2 error {err:.3g}"


def test_step_batch_statistics_match_jax(step):
    sd = step["model"].state_dict()
    assert len(step["jstats"]) == 10  # 3 encoder + 2 head BatchNorms, mean and var
    for n, w in step["jstats"].items():
        got, w = sd[n].numpy(), w.numpy()
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), n
        assert not np.array_equal(got, step["before"][n].numpy()), f"{n} did not move"


def test_masked_adamw_update_matches_optax_and_leaves_frozen_bits(step):
    model, opt = step["model"], step["opt"]
    with torch.no_grad():
        model.load_state_dict(step["before"])
        for n, p in model.named_parameters():
            p.grad = step["jgrads"][n].clone() if n in step["names"] else None
    opt.step()
    sd = model.state_dict()
    for n, _ in model.named_parameters():
        got, want = sd[n].numpy(), step["jparams"][n].numpy()
        if n in step["names"]:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), n
            assert not np.array_equal(got, step["before"][n].numpy()), f"{n} did not move"
        else:
            np.testing.assert_array_equal(got, step["before"][n].numpy(), err_msg=n)
            np.testing.assert_array_equal(got, want, err_msg=n)


@pytest.mark.parametrize("quirks", [False, True])
def test_trainable_names_equal_the_jax_mask(quirks):
    model = AdaptPointFormer(**CFG)
    params = jax.eval_shape(lambda: JAPF(**CFG).init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, N_POINTS, 3))))["params"]
    jmask = japf_mask(params, reference_quirks=quirks)
    mapped = _names({"params": jax.tree.map(lambda m: np.float32(m), jmask)},
                    model.state_dict().keys())
    want = {n for n, m in mapped.items() if bool(m)}
    got = apf_trainable_mask(model, reference_quirks=quirks)
    assert got == want
    assert any("adapter" in n for n in got) != quirks
    assert not any(".attention." in n or ".mlp." in n for n in got)
    build_optimizer(model, schedules.constant_schedule(LR), weight_decay=WD, trainable_mask=got)
    assert {n for n, p in model.named_parameters() if p.requires_grad} == got


@pytest.mark.parametrize("name,args", [
    ("timm_cosine_schedule", (5e-4, 30, 7, 10, 1e-3)),
    ("warmup_then_cosine_schedule", (1e-3, 7, 5, 20)),
    ("cosine_annealing_schedule", (1e-3, 30, 7)),
    ("constant_schedule", (3e-4,)),
])
def test_schedules_match_jax(name, args):
    """JAX evaluates in f32, the port in f64: they agree to f32 rounding of
    the base lr (the cosine's tail, 1 + cos(≈π), cancels in f32)."""
    got, want = getattr(schedules, name)(*args), getattr(jsched, name)(*args)
    for s in (0, 6, 7, 35, 69, 70, 71, 140, 203, 209, 500):  # start, warm-up, end, past end
        assert got(s) == pytest.approx(float(want(s)), rel=1e-6, abs=1e-6 * args[0]), (name, s)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 6)
    for s in (0.0, 0.3):
        want = np.asarray(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), s))
        got = cross_entropy_loss(T(logits), T(labels), s).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        params = [nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = T(g.copy())
        clip_by_global_norm(params, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("cls", [Dropout, DropPath])
def test_dropout_and_drop_path(cls):
    x = torch.ones(4000, 8)
    layer = cls(0.25)
    assert layer(x) is x and layer(x, train=False) is x
    assert cls(0.0)(x, train=True) is x
    y = layer(x, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1.0 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    if cls is DropPath:  # whole samples drop
        assert torch.all(kept.all(dim=1) | (~kept).all(dim=1))
    again = layer(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    other = layer(x, train=True, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(y, other)


def test_batch_norm_uses_flax_conventions():
    rng = np.random.default_rng(5)
    x = (3 + 2 * rng.standard_normal((7, 5, 4))).astype(np.float32)
    bn = nn.BatchNorm1d(4, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(T(rng.standard_normal(4).astype(np.float32)))
        bn.bias.copy_(T(rng.standard_normal(4).astype(np.float32)))
    y = batch_norm(T(x), bn, train=True)
    mean, var = x.reshape(-1, 4).mean(0), x.reshape(-1, 4).var(0)  # biased
    want = (x - mean) / np.sqrt(var + 1e-5) * bn.weight.detach().numpy() + bn.bias.detach().numpy()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var, rtol=1e-5)


def test_train_forward_draws_from_the_generator():
    model = AdaptPointFormer(**{**CFG, "dropout_rate": 0.1, "dropout_path_rate": 0.1})
    pts = T(np.random.default_rng(6).standard_normal((4, N_POINTS, 3)).astype(np.float32))
    run = lambda seed: model(pts, train=True, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)
    assert [blk.drop_path.rate for blk in model.blocks] == pytest.approx([0.0, 0.1])


# --------------------------------------------------------------- the Trainer


class _Probe(nn.Module):
    """A tiny classifier with one train-mode BatchNorm that records the
    marker column of every training batch it sees."""

    def __init__(self, classes: int = 3) -> None:
        super().__init__()
        self.fc = nn.Linear(3, 8)
        self.bn = nn.BatchNorm1d(8)
        self.out = nn.Linear(8, classes)
        self.seen = []

    def forward(self, points, *, train=False, generator=None):
        if train:
            self.seen.append(points[:, 0, 0].clone())
        h = batch_norm(linear(points.mean(dim=1), self.fc), self.bn, train=train)
        return linear(torch.relu(h), self.out)


def _dataset(n, seed, n_points=64):
    clouds, labels = make_shape_clouds(n, n_points, num_classes=3, seed=seed)
    return list(zip(clouds, labels))


def _trainer(model, tmp_path, **kw):
    torch.manual_seed(0)
    opt = build_optimizer(model, schedules.constant_schedule(1e-2), weight_decay=WD,
                          grad_clip=kw.pop("grad_clip", None), trainable_mask=kw.pop("mask", None))
    args = dict(train_dataset=_dataset(12, 0), test_dataset=_dataset(6, 1), optimizer=opt,
                schedule=schedules.constant_schedule(1e-2), batch_size=4, epochs=2,
                output_dir=str(tmp_path), log_lr=True, device="cpu")
    args.update(kw)
    return Trainer(model, **args)


def test_trainer_trains_apf_and_writes_the_jax_csv(tmp_path):
    cfg = dict(num_classes=3, embedding_dim=32, npoint=8, nsample=4, in_channels=3, depth=1,
               num_heads=2, encoder_second_width=32)
    model = AdaptPointFormer(**cfg)
    tr = _trainer(model, tmp_path, mask=apf_trainable_mask(model), save_interval=1)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    best = tr.train()
    with open(tmp_path / "training_metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "train_loss", "train_accuracy", "test_loss", "test_accuracy",
                       "learning_rate"]
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    assert tr.step == 6 and 0.0 <= best <= 1.0
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    for name in ("model_epoch_1.pt", "model_epoch_2.pt", "model_epoch_1.pt.json"):
        assert (tmp_path / name).exists()
    assert tr.predict(np.asarray(_dataset(5, 2)[0][0])[None].repeat(5, 0)).shape == (5,)


def test_checkpoint_reloads_and_resumes(tmp_path):
    tr = _trainer(_Probe(), tmp_path, save_interval=1, ema_decay=0.5)
    tr.train()
    ck = tmp_path / "model_epoch_1.pt"
    probe = _Probe()
    tr2 = _trainer(probe, tmp_path, ema_decay=0.5, epochs=3)
    tr2.load_checkpoint(str(ck))
    saved = torch.load(ck, weights_only=True)
    assert tr2.start_epoch == 1 and tr2.step == saved["step"] == 3
    for n, v in saved["model"].items():
        assert torch.equal(probe.state_dict()[n], v), n
    for n, v in saved["ema"].items():
        assert torch.equal(tr2.ema[n], v), n
    tr2.train()
    with open(tmp_path / "training_metrics.csv", newline="") as f:
        assert [r[0] for r in list(csv.reader(f))[1:]] == ["1", "2", "3"]
    assert tr2.step == 9


def test_grad_accum_takes_the_jax_row_order(tmp_path):
    probe = _Probe()
    tr = _trainer(probe, tmp_path, grad_accum=2, batch_size=8)
    pts = torch.zeros(8, 5, 3)
    pts[:, 0, 0] = torch.arange(8.0)
    loss, correct, skipped = tr.train_step(pts, torch.zeros(8, dtype=torch.int64))
    assert not skipped and torch.isfinite(loss)
    assert [s.tolist() for s in probe.seen] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    with pytest.raises(ValueError, match="grad_accum"):
        _trainer(_Probe(), tmp_path, grad_accum=3, batch_size=8)


def test_nan_guard_skip_keeps_the_old_state(tmp_path):
    probe = _Probe()
    tr = _trainer(probe, tmp_path, nan_guard="skip", ema_decay=0.9)
    pts = torch.randn(4, 5, 3, generator=torch.Generator().manual_seed(0))
    lbl = torch.tensor([0, 1, 2, 0])
    tr.train_step(pts, lbl)
    state = {k: v.clone() for k, v in probe.state_dict().items()}
    opt_state = tr.optimizer.optimizer.state_dict()["state"]
    moments = {k: {n: t.clone() for n, t in s.items()} for k, s in opt_state.items()}
    ema = {k: v.clone() for k, v in tr.ema.items()}
    poisoned = pts.clone()
    poisoned[1, 2, 0] = float("nan")
    loss, correct, skipped = tr.train_step(poisoned, lbl)
    assert skipped and loss.item() == 0.0 and correct.item() == 0 and tr.step == 1
    for k, v in probe.state_dict().items():
        assert torch.equal(v, state[k]), k
    for k, s in tr.optimizer.optimizer.state_dict()["state"].items():
        for n, t in s.items():
            assert torch.equal(t, moments[k][n]), (k, n)
    for k, v in tr.ema.items():
        assert torch.equal(v, ema[k]), k
    assert not tr.train_step(pts, lbl)[2] and tr.step == 2


def test_ema_decay_zero_tracks_the_params(tmp_path):
    probe = _Probe()
    tr = _trainer(probe, tmp_path, ema_decay=0.0)
    pts = torch.randn(4, 5, 3, generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        tr.train_step(pts, torch.tensor([0, 1, 2, 1]))
    current = dict(probe.named_parameters()) | dict(probe.named_buffers())
    assert set(tr.ema) == {"fc.weight", "fc.bias", "bn.weight", "bn.bias", "out.weight", "out.bias",
                           "bn.running_mean", "bn.running_var"}
    for n, e in tr.ema.items():
        assert torch.equal(e, current[n].float()), n


def test_trainer_refuses_what_is_not_ported(tmp_path):
    class Mesh:  # a mesh's interface, as far as the trainer's checks read it
        def __init__(self, device_type, names):
            self.device_type, self.mesh_dim_names = device_type, names

    with pytest.raises(ValueError, match="'data' dimension"):
        _trainer(_Probe(), tmp_path, mesh=Mesh("cpu", ("model",)))
    with pytest.raises(ValueError, match="cuda mesh cannot train on cpu"):
        _trainer(_Probe(), tmp_path, mesh=Mesh("cuda", ("data",)))


def test_apf_trainer_from_config_dicts(tmp_path, monkeypatch):
    from pointvit_tpu_torch.train import APFTrainer

    write_scanobjectnn_h5(str(tmp_path / "data"), background=False, num_train=8, num_test=4,
                          num_points=96)
    model_config = dict(num_classes=15, in_channels=3, embedding_dim=32, npoint=8, nsample=4,
                        depth=1, num_heads=2, encoder_second_width=32, bf16=False)
    dataset_config = dict(root_dir=str(tmp_path / "data"), variant="main_split",
                          augmentation="base", train_num_points=64, test_num_points=64)
    train_config = dict(epochs=1, batch_size=4, learning_rate=5e-4, weight_decay=0.05,
                        native_pipeline=False)
    monkeypatch.setenv("POINTVIT_WEIGHTS", str(tmp_path / "no_weights"))
    with pytest.warns(UserWarning, match="No cached weights for 'vit_base_patch16_224'"):
        APFTrainer(model_config, dataset_config, train_config, device="cpu",  # pretrained=True
                   output_dir=str(tmp_path / "out"))
    tr = APFTrainer({**model_config, "pretrained": False}, dataset_config, train_config,
                    device="cpu", output_dir=str(tmp_path / "out"))
    assert tr.label_smoothing == 0.3 and tr.train_dataset.data.shape[1:] == (64, 3)
    assert not any(p.requires_grad for n, p in tr.model.named_parameters() if ".attention." in n)
    tr.train()
    with open(tmp_path / "out" / "training_metrics.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0][-1] == "learning_rate" and len(rows) == 2


def test_train_package_imports_and_trains_without_jax(tmp_path):
    script = f"""
import sys
sys.modules["jax"] = None
import numpy as np, torch
from pointvit_tpu_torch.models import AdaptPointFormer, apf_trainable_mask
from pointvit_tpu_torch.train import Trainer, build_optimizer, timm_cosine_schedule
import pointvit_tpu_torch.data
assert not [m for m in sys.modules if m.split(".")[0] == "pointvit_tpu"]  # data comes later
from pointvit_tpu.data.synthetic import make_shape_clouds
model = AdaptPointFormer(num_classes=3, embedding_dim=32, npoint=8, nsample=4, depth=1,
                         num_heads=2, encoder_second_width=32)
sched = timm_cosine_schedule(5e-4, 2, 2, warmup_epochs=1)
opt = build_optimizer(model, sched, weight_decay=0.05, trainable_mask=apf_trainable_mask(model))
data = list(zip(*make_shape_clouds(8, 64, num_classes=3, seed=0)))
tr = Trainer(model, train_dataset=data, test_dataset=data, optimizer=opt, schedule=sched,
             batch_size=4, epochs=1, output_dir={str(tmp_path)!r}, device="cpu")
loss, _, _ = tr.train_step(torch.randn(4, 64, 3), torch.tensor([0, 1, 2, 0]))
assert torch.isfinite(loss)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
