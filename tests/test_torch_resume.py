"""Resuming a JAX training run in the port's ``Trainer``, on the CPU.

A JAX ``TrainState`` with each JAX trainer's optimizer
(``pointvit_tpu.train.trainer.build_optimizer`` with the family's masks:
APF's trainable mask; Pix4Point's clip and no-decay mask, without and with
the frozen trunk's mask; the renderer's mask, without and with a clip)
takes two updates and is written by ``pointvit_tpu.train.checkpoint.save_checkpoint``.
The port's ``Trainer`` (the optimizer its trainer builds) resumes from the
msgpack: weights and EMA bit-equal to the state's, ``step``, ``start_epoch``,
``best_acc`` (the best checkpoint's sidecar) and the lr at the resumed count
equal to JAX's. Both then take the same two updates: the parameters agree
within 1e-5 of each tensor's largest entry, the tolerance of the one-step
update tests (``test_torch_train.py``): optax computes the bias corrections
in f32, torch in f64, which moves an update by up to ~7e-6 relative; frozen
parameters stay bit-equal. The optimizer state the port then holds,
written by ``adamw_to_optax``, restores in flax into the JAX optimizer's own
``init`` structure and agrees with JAX's state (counts equal, moments
within the same tolerance); a port checkpoint in the JAX format resumes bit
for bit. The updates are fed the same seeded gradients on both sides, so
they test the optimizer state alone (the forward's own parity is held in
the step tests).
"""

import json

import flax.serialization as flax_ser
import jax
import numpy as np
import pytest
import torch

import pointvit_tpu.train.schedules as jsched
from pointvit_tpu.models import factory as jfactory
from pointvit_tpu.models import renderer as jrenderer
from pointvit_tpu.models.apf import apf_trainable_mask as japf_mask
from pointvit_tpu.models.pix4point import pix4point_trainable_mask as jp4p_mask
from pointvit_tpu.models.renderer import renderer_trainable_mask as jrenderer_mask
from pointvit_tpu.train import TrainState
from pointvit_tpu.train import checkpoint as jcheckpoint
from pointvit_tpu.train.pix4point_trainer import weight_decay_mask as jp4p_decay_mask
from pointvit_tpu.train.trainer import build_optimizer as jbuild_optimizer
from pointvit_tpu_torch.convert import (
    adamw_to_optax,
    flax_to_state_dict,
    load_flax_variables,
    load_optax_state,
    state_dict_to_flax,
)
from pointvit_tpu_torch.models import apf_trainable_mask, build_model, renderer
from pointvit_tpu_torch.train import Trainer, build_optimizer, schedules
from pointvit_tpu_torch.train.checkpoint import save_checkpoint
from pointvit_tpu_torch.train.pix4point_trainer import pix4point_optimizer
from pointvit_tpu_torch.train.renderer_trainer import renderer_optimizer

REL_TOL = 1e-5
LR, WD, CLIP, STEPS_PER_EPOCH = 1e-3, 0.05, 1.0, 7
TINY_VIT = dict(patch_size=8, embed_dim=64, depth=1, num_heads=1)
CONFIGS = {
    "apf": {"num_classes": 5, "in_channels": 3, "embedding_dim": 32, "npoint": 8, "nsample": 4, "depth": 1,
            "num_heads": 1, "encoder_second_width": 32, "bf16": False},
    "pix4point": {"num_classes": 5, "pretrained_model": "vit_small_patch16_384", "embed_dim": 64, "depth": 1,
                  "num_heads": 1, "k_neighbors": 4, "bf16": False},
    "pix4point_moe": {"num_classes": 5, "pretrained_model": "vit_small_patch16_384", "embed_dim": 64,
                      "depth": 2, "num_heads": 1, "k_neighbors": 4, "bf16": False, "moe_experts": 4,
                      "moe_every": 2},
    "renderer": {"num_classes": 5, "vit_name": "vit_tiny_test", "adapter_dim": 8, "num_views": 2, "img_size": 16,
                 "view_transform_hidden": 16, "diff_renderer": True, "dropout_rate": 0.0, "bf16": False},
}
P4P_TRAIN = {"learning_rate": LR, "weight_decay": WD, "t_max": 20, "warmup_epochs": 1, "min_lr": 1e-6,
             "grad_norm_clip": CLIP}


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_preset():
    with pytest.MonkeyPatch.context() as mp:
        for table in (jrenderer.TORCHVISION_VIT_PRESETS, renderer.TORCHVISION_VIT_PRESETS):
            mp.setitem(table, "vit_tiny_test", TINY_VIT)
        yield


def _optimizers(case, model, params):
    """(JAX schedule, JAX optimizer, port optimizer) as each family's trainer
    builds them; the port's on ``model``."""
    if case == "apf":
        args = (LR, 30, STEPS_PER_EPOCH, 10, 1e-3)
        jsch = jsched.timm_cosine_schedule(*args)
        return jsch, jbuild_optimizer(jsch, weight_decay=WD, trainable_mask=japf_mask(params)), build_optimizer(
            model, schedules.timm_cosine_schedule(*args), weight_decay=WD, trainable_mask=apf_trainable_mask(model))
    if case.startswith("pix4point"):
        frozen = case.endswith("frozen")
        jsch = jsched.warmup_then_cosine_schedule(LR, STEPS_PER_EPOCH, warmup_epochs=1, t_max=20, min_lr=1e-6)
        tx = jbuild_optimizer(jsch, weight_decay=WD, grad_clip=CLIP, weight_decay_mask=jp4p_decay_mask,
                              trainable_mask=jp4p_mask(params, frozen=True) if frozen else None)
        return jsch, tx, pix4point_optimizer(model, P4P_TRAIN, STEPS_PER_EPOCH, frozen=frozen)[1]
    clip = CLIP if case.endswith("clip") else 0.0
    jsch = jsched.constant_schedule(LR)
    tx = jbuild_optimizer(jsch, weight_decay=WD, grad_clip=clip or None, trainable_mask=jrenderer_mask(params))
    return jsch, tx, renderer_optimizer(model, {"learning_rate": LR, "weight_decay": WD, "clip_grad_norm": clip},
                                        STEPS_PER_EPOCH)[1]


def _randomize(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.is_floating_point():
                t.copy_(0.3 * torch.randn(t.shape, generator=gen))
    return model


def _grads(params, rng):
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max(), name


@pytest.mark.parametrize("case", ["apf", "pix4point", "pix4point_frozen", "pix4point_moe", "renderer",
                                  "renderer_clip"])
def test_a_jax_run_resumes_in_the_port(case, tmp_path):
    family = case.split("_")[0]
    cfg = CONFIGS.get(case, CONFIGS[family])
    variables = state_dict_to_flax(_randomize(build_model(cfg, family), 0))
    params = variables["params"]
    model = load_flax_variables(build_model(cfg, family), variables)
    jsch, tx, opt = _optimizers(case, model, params)
    rng = np.random.default_rng(1)
    grads = [_grads(params, rng) for _ in range(4)]

    # the JAX run: two updates, a checkpoint, two more
    state = TrainState.create(
        apply_fn=jfactory.build_model(cfg, family=family).apply, params=params, tx=tx,
        batch_stats=variables["batch_stats"], ema_params=jax.tree.map(lambda a: a * 0.5, params),
        ema_batch_stats=jax.tree.map(lambda a: a + 1.0, variables["batch_stats"]))
    for g in grads[:2]:
        state = state.apply_gradients(grads=g)
    path = jcheckpoint.save_checkpoint(str(tmp_path), "model_epoch_2.msgpack", epoch=1, state=state, accuracy=0.25,
                                       model_config=cfg, dataset_config={}, async_write=False)
    with open(tmp_path / "model_best.msgpack.json", "w") as f:
        json.dump({"epoch": 0, "accuracy": 0.75}, f)
    resumed = jax.device_get(state)
    for g in grads[2:]:
        state = state.apply_gradients(grads=g)
    final = jax.device_get(state)

    tr = Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=opt.schedule, batch_size=4,
                 epochs=5, output_dir=str(tmp_path), device="cpu", ema_decay=0.9, train_loader=[], test_loader=[],
                 save_config_snapshot=False)
    tr.load_checkpoint(path)
    keys = model.state_dict().keys()
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert tr.start_epoch == 2 and tr.best_acc == 0.75 and tr.step == 2 == int(resumed.step)
    assert tr._current_lr() == pytest.approx(float(jsch(resumed.step)), rel=1e-6)
    sd = model.state_dict()
    for n, v in flax_to_state_dict({"params": resumed.params, "batch_stats": resumed.batch_stats}, keys).items():
        assert torch.equal(sd[n], v), n
    ema = flax_to_state_dict({"params": resumed.ema_params, "batch_stats": resumed.ema_batch_stats}, keys)
    assert set(tr.ema) == trainable | {n for n in keys if n.endswith(("running_mean", "running_var"))}
    for n, v in tr.ema.items():
        assert torch.equal(v, ema[n]), n

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for g in grads[2:]:
        named = flax_to_state_dict({"params": g}, keys)
        for n, p in model.named_parameters():
            p.grad = named[n].clone() if p.requires_grad else None
        opt.step()
    want = flax_to_state_dict({"params": final.params}, keys)
    for n, p in model.named_parameters():
        if n in trainable:
            _close(p.detach(), want[n], n)
        else:
            assert torch.equal(p.detach(), before[n]) and torch.equal(p.detach(), want[n]), n

    written = adamw_to_optax(model, opt)
    restored = flax_ser.from_state_dict(tx.init(params), written)
    assert jax.tree.structure(restored) == jax.tree.structure(final.opt_state)
    for (kp, got), want_leaf in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                                    jax.tree.leaves(final.opt_state)):
        name = jax.tree_util.keystr(kp)
        if name.endswith("count"):
            assert np.asarray(got).dtype == np.int32 and int(got) == int(want_leaf) == 4, name
        else:
            _close(got, want_leaf, name)

    # the port's own JAX-format checkpoint resumes bit for bit
    tree = state_dict_to_flax(model)
    out = save_checkpoint(str(tmp_path), "port.msgpack", epoch=3, accuracy=0.5,
                          state={**tree, "opt_state": written, "step": opt.count}, model_config=cfg,
                          dataset_config={})
    again = load_flax_variables(build_model(cfg, family), variables)
    _, _, opt2 = _optimizers(case, again, params)
    tr2 = Trainer(again, train_dataset=None, test_dataset=None, optimizer=opt2, batch_size=4, epochs=5,
                  output_dir=str(tmp_path), device="cpu", train_loader=[], test_loader=[], save_config_snapshot=False)
    tr2.load_checkpoint(out)
    assert tr2.step == 4 and tr2.start_epoch == 4
    for (n, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), n
    s1, s2 = opt.optimizer.state_dict()["state"], opt2.optimizer.state_dict()["state"]
    assert sorted(s1) == sorted(s2) and s1
    for k in s1:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[k][field], s2[k][field]), (k, field)


def test_a_frozen_parameter_with_moments_or_a_trainable_one_without_raises(tmp_path):
    cfg = CONFIGS["apf"]
    variables = state_dict_to_flax(_randomize(build_model(cfg, "apf"), 0))
    model = load_flax_variables(build_model(cfg, "apf"), variables)
    _, _, opt = _optimizers("apf", model, variables["params"])
    good = adamw_to_optax(model, opt)
    adam = good["inner_states"]["True"]["inner_state"]["0"]["0"]
    frozen = jax.tree.map(np.zeros_like, variables["params"]["blocks_0"]["attention"])
    for key, bad in (("frozen", {"blocks_0": {**adam["mu"]["blocks_0"], "attention": frozen}}),
                     ("trainable", {"head": {**adam["mu"]["head"], "fc0": {}}})):
        tree = jax.tree.map(lambda a: a, good)  # a copy of the layout
        tree["inner_states"]["True"]["inner_state"]["0"]["0"]["mu"] = {**adam["mu"], **bad}
        with pytest.raises(KeyError, match="frozen or unknown" if key == "frozen" else "MaskedNode"):
            load_optax_state(model, opt, tree)
    with pytest.raises(ValueError, match="one AdamW state"):
        load_optax_state(model, opt, {"0": {}})
