"""The port's ``Trainer`` on the meshes the JAX trainer takes, on the CPU over
gloo ranks: one spawn of 4 ranks (``tests/torch_dist_cases.py::suite_layouts``)
runs three steps in each layout and in one process.

- (i) ``fsdp=True`` on a (data 2 × model 2) mesh: FSDP2 over the data
  sub-mesh on top of the tensor-parallel plan (the plain path, tiny APF).
  Held to the one-process ``Trainer`` within 1e-6 relative, and to JAX's
  ``Trainer(fsdp=True)`` on a hybrid mesh of 4 virtual devices within 1e-5.
- (ii) The MoE Pix4Point with ``moe_mesh`` over (data 2 × expert 2): rows
  over every rank, each rank holding its experts. Held to a JAX step over a
  mesh of the same shape (``tests/test_moe_block.py:150-195``'s pattern,
  ``jax.value_and_grad`` + optax) within 1e-5, and, at a capacity factor at
  which no token drops and with no load-balance term (its expert-parallel
  form is the mean of the shards' own, as in JAX), to the one-process
  ``Trainer``. Its checkpoint, in
  the one-process layout with every expert, serves on one rank as the JAX
  model does on the same weights.
- (iii) ``make_multihost_mesh``'s (replica 2 × data 2 × model 1) mesh: held
  to the one-process ``Trainer``.

No random draw on either side (dropout 0, FPS from point 0), f32, the JAX
side under ``jax.default_matmul_precision("highest")``. Losses are held per
step, each tensor of the state after the three steps to its largest entry.
Two things would turn rounding into larger differences, and the cases rule
them out. AdamW at its default eps (1e-8) moves each entry by about
lr·sign(g) on a first step, so a gradient entry that is rounding noise (a
bias before a BatchNorm) becomes a whole step: the runs take eps 1e-3, at
which the update of the small entries is near linear in g. And a near tie
at a maximum or at a router's pick sends a gradient elsewhere on a side that
rounds differently (a seed with a group-max gap of 5e-6 put the DP
gradients 3e-3 from the one-process ones): the seeds are chosen, and
asserted, to have no gap under 1e-5 at any maximum or router pick of the
port's runs.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import flax.serialization as flax_ser
import optax
import pytest
import torch
from jax.sharding import Mesh

import pointvit_tpu.models.apf as japf_module
import pointvit_tpu.models.pix4point as jp4p_module
from pointvit_tpu.models import AdaptPointFormer as JAPF
from pointvit_tpu.models import apf_trainable_mask as japf_trainable_mask
from pointvit_tpu.models.pix4point import Pix4Point as JPix4Point
from pointvit_tpu.nn.heads import ClassificationHead as JClassificationHead
from pointvit_tpu.nn.heads import ClsHead as JClsHead
from pointvit_tpu.nn.moe import collect_moe_aux_loss as jcollect_aux
from pointvit_tpu.parallel import make_hybrid_mesh as jmake_hybrid_mesh
from pointvit_tpu.train import Trainer as JTrainer
from pointvit_tpu.train.pix4point_trainer import weight_decay_mask as jweight_decay_mask
from pointvit_tpu.train.trainer import build_optimizer as jbuild_optimizer
from pointvit_tpu.train.trainer import cross_entropy_loss as jcross_entropy
from pointvit_tpu_torch import convert
from pointvit_tpu_torch.models import AdaptPointFormer, Pix4Point
from pointvit_tpu_torch.serve import InferenceSession
import torch_dist_cases
from torch_dist_cases import APF_CFG, LAYOUT_EPS, LAYOUT_STEPS, P4P_LAYOUT

HIGHEST = functools.partial(jax.default_matmul_precision, "highest")
LR = 1e-3
TIE = 1e-5
# Each step is taken from the same state on both sides, so the two differ by
# rounding: losses within 1e-6; a state tensor within 1e-4 of the larger of
# its largest entry and one learning-rate step (a BatchNorm bias, whose
# AdamW step near |g| ~ eps is most sensitive to its gradient's rounding,
# differed by up to 2.1e-5 of that).
LOSS_TOL, PARAM_TOL = 1e-6, 1e-4
# Seeds whose three steps have no near tie at a maximum (the encoder's and
# the P3 stage's group maxima, the poolings) or at a router's pick: the
# assertions below check it on the one-process runs.
# The MoE runs take a seed for each capacity factor (cf 2: against JAX; cf 4:
# against the one-process trainer).
APF_SEED, MOE_SEEDS = 39, {2.0: 19, 4.0: 12}


def _inputs(seed):
    """Seeded weights and clouds of both models: the tiny APF (live
    adapters: up_proj starts at zero), the MoE Pix4Point, 16 clouds of 64
    points with 4 channels, 8 of 3."""
    torch.manual_seed(seed)
    model = AdaptPointFormer(**APF_CFG)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "up_proj" in n:
                p.copy_(0.1 * torch.randn_like(p))
    rng = np.random.default_rng(seed)
    return dict(apf_state=model.state_dict(), p4p_state=Pix4Point(**P4P_LAYOUT).state_dict(),
                points=rng.standard_normal((16, 64, 4)).astype(np.float32),
                labels=(np.arange(16) % 15).astype(np.int64),
                clouds=rng.standard_normal((8, 64, 3)).astype(np.float32),
                clouds_labels=(np.arange(8) % 15).astype(np.int64))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("layout_ranks"))
    apf = _inputs(APF_SEED)
    moe = {cf: _inputs(seed) for cf, seed in MOE_SEEDS.items()}
    torch.save({**{k: apf[k] for k in ("apf_state", "points", "labels")},
                "moe": {cf: dict(state=m["p4p_state"], clouds=m["clouds"], labels=m["clouds_labels"])
                        for cf, m in moe.items()}},
               os.path.join(wd, "inputs.pt"))
    torch_dist_cases.spawn("layouts", wd, 4, timeout=300)

    def load(name, r=0):
        return torch.load(os.path.join(wd, f"{name}_{r}.pt"), weights_only=False)

    load.inputs = torch.load(os.path.join(wd, "inputs.pt"), weights_only=False)
    return load


def _flat(tree, prefix=""):
    """The tensors of a nested state as {path: tensor}."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {}


def _assert_step_states(got, want, tol=PARAM_TOL):
    """Each tensor of the state ``got`` (model, optimizer moments, EMA)
    within ``tol`` of the larger of ``want``'s largest entry and one
    learning-rate step (a bias whose gradient is rounding noise stays near
    zero on both sides)."""
    skip = ("num_batches_tracked", "/step")
    flat_got, flat_want = _flat(got), _flat(want)
    assert {n for n in flat_got if not n.endswith(skip)} == {n for n in flat_want if not n.endswith(skip)}
    for n, w in flat_want.items():
        if n.endswith(skip):
            continue
        g, w = np.asarray(flat_got[n], np.float64), np.asarray(w, np.float64)
        bound = tol * max(np.abs(w).max(), LR) if w.size else 0.0
        assert np.abs(g - w).max(initial=0.0) <= bound, \
            f"{n}: {np.abs(g - w).max():.3g} > {bound:.3g}"


def _assert_steps_replay(ranks, tag):
    """Every step of a layout's run against the one-process trainer's step
    from the same state (losses relative, states by _assert_step_states)."""
    got, one = ranks(tag), ranks(f"{tag}_replay")
    assert len(got["states"]) == LAYOUT_STEPS + 1 and len(one["states"]) == LAYOUT_STEPS
    np.testing.assert_allclose(got["loss"].numpy(), one["loss"].numpy(), rtol=LOSS_TOL, atol=0)
    for k in range(LAYOUT_STEPS):
        _assert_step_states(got["states"][k + 1], one["states"][k])
    assert min(one["gaps"]) > TIE


@pytest.mark.parametrize("tag", ["fsdp_tp", "moe_ep_cf2.0", "moe_ep_cf4.0", "replica"])
def test_the_runs_have_no_near_tie_at_a_maximum_or_a_pick(ranks, tag):
    for r in range(4):
        assert min(ranks(tag, r)["gaps"]) > TIE


def _port_model(cls, cfg, state):
    model = cls(**cfg)
    model.load_state_dict(state["model"])
    return model


def _jax_opt_state(template, model, optimizer, state):
    """The port optimizer's state ``state["optimizer"]`` as the optax state
    of ``template``'s structure (convert.adamw_to_optax)."""
    optimizer.load_state_dict(state["optimizer"])
    return flax_ser.from_state_dict(template, convert.adamw_to_optax(model, optimizer))


def _ema_trees(model, state):
    """A state's EMA as the JAX trees (frozen parameters are their own
    average)."""
    averaged = copy.deepcopy(model)
    averaged.load_state_dict({**state["model"], **state["ema"]})
    tree = convert.state_dict_to_flax(averaged)
    return tree["params"], tree["batch_stats"]


# ------------------------------------------------- (i) FSDP over the TP plan


def test_fsdp_on_a_data_by_model_mesh_shards_over_both(ranks):
    got = ranks("fsdp_tp")
    qkv = got["layout"]["blocks.0.attention.qkv.weight"]
    assert qkv[0] == ("data", "model") and None not in qkv[1], qkv
    assert got["relaid"]  # a resume lays whole tensors out as the shards are
    _assert_step_states(got["resumed"], got["states"][-1], 0.0)  # and takes them back exactly


@pytest.mark.parametrize("tag", ["fsdp_tp", "replica"])
def test_each_step_equals_the_one_process_trainers_step(ranks, tag):
    _assert_steps_replay(ranks, tag)


def test_fsdp_over_tp_steps_match_jax_fsdp_on_a_hybrid_mesh(ranks, tmp_path):
    """JAX's Trainer(fsdp=True) on a (data 2 x model 2) hybrid mesh of CPU
    devices takes each step from the port's state (params, statistics, the
    optax form of its AdamW state, EMA, step); no random draw."""
    inputs, got = ranks.inputs, ranks("fsdp_tp")
    try:
        _jax_fsdp_steps(inputs, got, tmp_path)
    finally:  # traces made with randint patched must not serve a later test
        jax.clear_caches()


def _jax_fsdp_steps(inputs, got, tmp_path):
    from pointvit_tpu_torch.models import apf_trainable_mask
    from pointvit_tpu_torch.train import build_optimizer, constant_schedule

    with pytest.MonkeyPatch.context() as mp, HIGHEST():
        mp.setattr(japf_module, "ClassificationHead",
                   functools.partial(JClassificationHead, dropout_rate=0.0))
        mp.setattr(jax.random, "randint", lambda key, shape, lo, hi, dtype=jnp.int32:
                   jnp.zeros(shape, dtype))  # FPS from point 0
        jmodel = JAPF(**APF_CFG, dropout_rate=0.0, dropout_path_rate=0.0)
        model = _port_model(AdaptPointFormer, APF_CFG, got["states"][0])
        mask = japf_trainable_mask(convert.state_dict_to_flax(model)["params"])
        tx = jbuild_optimizer(optax.constant_schedule(LR), weight_decay=1e-2, grad_clip=1.0,
                              trainable_mask=mask, eps=LAYOUT_EPS)
        data = [(np.zeros((64, 4), np.float32), 0)] * 16
        tr = JTrainer(jmodel, train_dataset=data, test_dataset=data, optimizer=tx, batch_size=16,
                      epochs=1, label_smoothing=0.3, seed=3, save_config_snapshot=False,
                      output_dir=str(tmp_path), prefetch=0, trainable_mask=mask, ema_decay=0.5,
                      fsdp=True, mesh=jmake_hybrid_mesh(jax.devices()[:4], model_parallel=2))
        for k in range(LAYOUT_STEPS):
            st = got["states"][k]
            model = _port_model(AdaptPointFormer, APF_CFG, st)
            opt = build_optimizer(model, constant_schedule(LR), weight_decay=1e-2, grad_clip=1.0,
                                  trainable_mask=apf_trainable_mask(model), eps=LAYOUT_EPS)
            tree = convert.state_dict_to_flax(model)
            ema_p, ema_s = _ema_trees(model, st)
            state = tr.state.replace(
                params=tree["params"], batch_stats=tree["batch_stats"],
                opt_state=_jax_opt_state(tr.state.opt_state, model, opt, st),
                ema_params=ema_p, ema_batch_stats=ema_s, step=jnp.asarray(st["optimizer"]["count"]))
            pts, lbl = tr._shard(inputs["points"], inputs["labels"])
            new, loss, _, _ = tr._train_step(tr._place_state(state), pts, lbl, jax.random.PRNGKey(k))
            keys = model.state_dict().keys()
            want = convert.flax_to_state_dict(
                {"params": jax.tree.map(np.asarray, new.params),
                 "batch_stats": jax.tree.map(np.asarray, new.batch_stats)}, keys)
            np.testing.assert_allclose(float(got["loss"][k]), float(loss), rtol=LOSS_TOL, atol=0)
            _assert_step_states(got["states"][k + 1]["model"], want)
            ema = convert.flax_to_state_dict(
                {"params": jax.tree.map(np.asarray, new.ema_params),
                 "batch_stats": jax.tree.map(np.asarray, new.ema_batch_stats)}, keys)
            _assert_step_states(got["states"][k + 1]["ema"], {n: ema[n] for n in got["states"][k + 1]["ema"]})


# ------------------------------------------------------- (ii) the MoE mesh


def test_the_expert_trainer_shards_the_experts_alone(ranks):
    got = [ranks("moe_ep_cf2.0", r) for r in range(4)]
    layout = got[0]["layout"]
    assert set(layout) == {f"model.blocks.1.mlp.{n}" for n in ("w1", "b1", "w2", "b2")}
    assert all(v == (("expert",), [0]) for v in layout.values()), layout
    for g in got:  # every rank holds the same whole state: all E experts
        final = g["states"][-1]["model"]
        assert final["model.blocks.1.mlp.w1"].shape[0] == P4P_LAYOUT["moe_experts"]
        for n, t in got[0]["states"][-1]["model"].items():
            assert torch.equal(final[n], t), n


def test_the_expert_trainer_without_drops_equals_the_one_process_trainer(ranks):
    _assert_steps_replay(ranks, "moe_ep_cf4.0")


def test_the_expert_trainer_matches_a_jax_step_over_the_same_mesh(ranks):
    """Each step of the (data 2 x expert 2) run against JAX's step over a
    mesh of that shape from the same state: jax.value_and_grad of the
    model with ``moe_mesh`` (its load-balance term 0.5) + the optax update
    of the port's AdamW state (clip 1, the no-decay mask)."""
    from pointvit_tpu_torch.train import build_optimizer, constant_schedule
    from pointvit_tpu_torch.train.pix4point_trainer import no_decay_names

    got, case = ranks("moe_ep_cf2.0"), ranks.inputs["moe"][2.0]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "expert"))
    points, labels = jnp.asarray(case["clouds"]), jnp.asarray(case["labels"])
    with pytest.MonkeyPatch.context() as mp, HIGHEST():
        mp.setattr(jp4p_module, "ClsHead", functools.partial(JClsHead, dropout_rate=0.0))
        jmodel = JPix4Point(**P4P_LAYOUT, moe_mesh=mesh, moe_data_axis="data")

        def loss_fn(params, stats):
            logits, upd = jmodel.apply({"params": params, "batch_stats": stats}, points, train=True,
                                       mutable=["batch_stats", "intermediates"])
            ce = jnp.mean(jcross_entropy(logits.astype(jnp.float32), labels, 0.0))
            return ce + 0.5 * jcollect_aux(upd["intermediates"]), upd["batch_stats"]

        tx = jbuild_optimizer(optax.constant_schedule(LR), weight_decay=5e-2, grad_clip=1.0,
                              weight_decay_mask=jweight_decay_mask, eps=LAYOUT_EPS)
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        for k in range(LAYOUT_STEPS):
            st = got["states"][k]
            model = _port_model(Pix4Point, P4P_LAYOUT, st)
            opt = build_optimizer(model, constant_schedule(LR), weight_decay=5e-2, grad_clip=1.0,
                                  no_decay=no_decay_names(model), eps=LAYOUT_EPS)
            tree = jax.tree.map(jnp.asarray, convert.state_dict_to_flax(model))
            opt_state = _jax_opt_state(tx.init(tree["params"]), model, opt, st)
            (loss, stats), grads = step(tree["params"], tree["batch_stats"])
            updates, _ = tx.update(grads, opt_state, tree["params"])
            params = optax.apply_updates(tree["params"], updates)
            want = convert.flax_to_state_dict(
                {"params": jax.tree.map(np.asarray, params),
                 "batch_stats": jax.tree.map(np.asarray, stats)}, model.state_dict().keys())
            np.testing.assert_allclose(float(got["loss"][k]), float(loss), rtol=LOSS_TOL, atol=0)
            _assert_step_states(got["states"][k + 1]["model"], want)


def test_the_expert_checkpoint_serves_on_one_rank_as_jax(ranks):
    """The rank-0 file holds every expert in the one-process layout: a
    one-rank session serves it, as the JAX model (no mesh) serves the same
    weights, within 1e-4 of the largest logit."""
    got = ranks("moe_ep_cf2.0")
    sess = InferenceSession.from_checkpoint(got["path"], buckets=(4,), use_ema=False, device="cpu")
    np.testing.assert_array_equal(sess.model.state_dict()["model.blocks.1.mlp.w1"].numpy(),
                                  got["states"][-1]["model"]["model.blocks.1.mlp.w1"].numpy())
    clouds = np.random.default_rng(9).standard_normal((4, 64, 3)).astype(np.float32)
    served = sess.predict_logits(clouds)
    tree = convert.state_dict_to_flax(sess.model)
    with HIGHEST():
        want = np.asarray(jax.jit(JPix4Point(**P4P_LAYOUT).apply)(
            {k: jax.tree.map(jnp.asarray, v) for k, v in tree.items()}, jnp.asarray(clouds)))
    assert np.abs(served - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------------------ (iii) the 3-D mesh


def test_a_replica_data_model_mesh_is_the_multihost_layout(ranks):
    got = [ranks("replica", r) for r in range(4)]
    assert all(g["shape"] == [2, 2, 1] for g in got)
    final = [_flat(g["states"][-1]) for g in got]
    for other in final[1:]:  # replicas and data ranks end in the same state
        for n, t in final[0].items():
            torch.testing.assert_close(other[n], t, rtol=0, atol=0)
