"""Port parity for the mixture-of-experts layers and the MoE Pix4Point trunk
on the CPU: ``moe_ffn`` against the JAX function, dense and
expert-parallel (gloo ranks against a JAX mesh of the same shape over the
first W virtual devices), ``upcycle_dense_mlp``, ``MoEViTBlock``, the MoE
Pix4Point's forward and one training step against ``jax.value_and_grad`` +
optax with the collected aux loss, the trainer's aux weight, a JAX
checkpoint of the MoE model served by ``from_checkpoint``, the routing's
memory at a serving shape, and the MoE trunk under data parallelism against
the one-process step.

f32 on both sides, the JAX side under ``jax.default_matmul_precision("highest")``.
Tolerances: ``moe_ffn`` outputs and aux within 1e-5, its gradients within
1e-4 (the expert inputs are bit-equal, the FFN products and the K-term
combine round in another order); a block within 1e-5 of its largest entry,
a model's logits within 1e-4; the training step as
``tests/test_torch_pix4point_train.py`` holds it (loss 1e-5, each gradient
1e-4 relative L2, the biases whose exact gradient is zero held to 1e-6 of
the global norm). Top-k routing is discontinuous, so every case asserts
that its router probabilities have no near tie (within 1e-5) where a pick
is taken: the two sides round differently and would pick differently there.
"""

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

import pointvit_tpu.models.pix4point as jp4p_module
from pointvit_tpu.data.synthetic import write_scanobjectnn_h5
from pointvit_tpu.models.pix4point import Pix4Point as JPix4Point
from pointvit_tpu.nn.heads import ClsHead as JClsHead
from pointvit_tpu.nn.moe import MoEViTBlock as JMoEViTBlock
from pointvit_tpu.nn.moe import collect_moe_aux_loss as jcollect_aux
from pointvit_tpu.parallel import moe_ffn as jmoe_ffn
from pointvit_tpu.serve import InferenceSession as JSession
from pointvit_tpu.train import TrainState
from pointvit_tpu.train import checkpoint as jcheckpoint
from pointvit_tpu.train.pix4point_trainer import weight_decay_mask as jweight_decay_mask
from pointvit_tpu.train.trainer import build_optimizer as jbuild_optimizer
from pointvit_tpu.train.trainer import cross_entropy_loss as jcross_entropy
from pointvit_tpu_torch import convert
from pointvit_tpu_torch.models import Pix4Point, build_model
from pointvit_tpu_torch.nn import MoEMlp, MoEViTBlock, collect_moe_aux_loss
from pointvit_tpu_torch.parallel import init_moe_params, moe_ffn
from pointvit_tpu_torch.parallel.expert import upcycle_dense_mlp
from pointvit_tpu_torch.serve import InferenceSession
from pointvit_tpu_torch.train import Pix4PointTrainer, schedules
from pointvit_tpu_torch.train.pix4point_trainer import no_decay_names
from pointvit_tpu_torch.train.trainer import build_optimizer, cross_entropy_loss
from test_torch_pix4point_train import _clouds, _group_max_gap
import torch_dist_cases

T = torch.from_numpy
HIGHEST = functools.partial(jax.default_matmul_precision, "highest")
B, S, M, F, E = 8, 6, 16, 32, 4
NODROP = float(E)
TIE = 1e-5
P4P = dict(num_classes=10, embed_dim=32, depth=2, num_heads=4, k_neighbors=8, moe_experts=4,
           moe_every=2)
N_POINTS = 64


def _no_near_tie(logits: np.ndarray, top_k: int) -> None:
    """Every pick of the top-k routing leads the next candidate by more
    than TIE relative: no pick can differ between the two sides."""
    p = np.sort(jax.nn.softmax(np.asarray(logits, np.float64), axis=-1), axis=-1)[:, ::-1]
    gaps = (p[:, :top_k] - p[:, 1:top_k + 1]) / p[:, :top_k]
    assert gaps.min() > TIE, gaps.min()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, M)).astype(np.float32)
    params = {k: v.numpy() for k, v in init_moe_params(torch.Generator().manual_seed(seed), M, F, E).items()}
    params["b1"] = 0.1 * rng.standard_normal(params["b1"].shape).astype(np.float32)
    params["b2"] = 0.1 * rng.standard_normal(params["b2"].shape).astype(np.float32)
    cot = rng.standard_normal((B, S, M)).astype(np.float32)
    _no_near_tie(x.reshape(-1, M) @ params["gate"], 2)
    return x, params, cot


def _jax_moe(x, params, cot, mesh=None, **kw):
    def f(x, p):
        out, aux = jmoe_ffn(x, p, mesh, **kw)
        return jnp.sum(out * cot), (out, aux)

    with HIGHEST():
        (_, (out, aux)), (gx, gp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(out), float(aux), np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=name)


# -------------------------------------------------------------- moe_ffn

ROUTES = [(1, NODROP, False), (2, NODROP, False), (1, 0.5, False), (2, 0.5, False),
          (2, 2.0, True), (2, 0.5, True)]


@pytest.mark.parametrize("top_k,cf,norm", ROUTES)
def test_moe_ffn_matches_jax(top_k, cf, norm):
    x, params, cot = _inputs()
    kw = dict(top_k=top_k, capacity_factor=cf, normalize_gates=norm)
    want, want_aux, wgx, wgp = _jax_moe(x, params, cot, **kw)
    p = {k: T(v).requires_grad_(True) for k, v in params.items()}
    xt = T(x).requires_grad_(True)
    out, aux = moe_ffn(xt, p, **kw)
    (out * T(cot)).sum().backward()
    _close(out.detach(), want, 1e-5)
    assert abs(aux.item() - want_aux) <= 1e-5 * want_aux
    _close(xt.grad, wgx, 1e-4, "x")
    for k in params:
        _close(p[k].grad, wgp[k], 1e-4, k)
    if cf < 1 and top_k == 1:  # 48 picks for 24 slots: whole tokens are dropped
        assert (np.abs(want).reshape(-1, M).max(-1) == 0).sum() >= B * S // 2
    assert float(p["gate"].grad.abs().max()) > 0


def test_moe_ffn_validates_shapes():
    x, params, _ = _inputs()

    class ThreeShards:  # a mesh's interface, as far as the checks read it
        mesh_dim_names = ("expert",)

        def get_group(self, _):
            return None

        def size(self, _):
            return 3

    with pytest.raises(ValueError, match="experts"):
        moe_ffn(T(x), {k: T(v) for k, v in params.items()}, ThreeShards())
    with pytest.raises(ValueError, match="top_k"):
        moe_ffn(T(x), {k: T(v) for k, v in params.items()}, top_k=E + 1)


@pytest.mark.parametrize("top_k", [1, 2])
def test_upcycled_moe_preserves_the_dense_mlp_and_matches_jax(top_k):
    x, _, cot = _inputs(6)
    rng = np.random.default_rng(7)
    fc1_k, fc1_b = (0.1 * rng.standard_normal(s).astype(np.float32) for s in ((M, F), (F,)))
    fc2_k, fc2_b = (0.1 * rng.standard_normal(s).astype(np.float32) for s in ((F, M), (M,)))
    params = upcycle_dense_mlp(torch.Generator().manual_seed(3), T(fc1_k), T(fc1_b), T(fc2_k),
                               T(fc2_b), E)
    kw = dict(top_k=top_k, capacity_factor=NODROP, normalize_gates=True)
    out, _ = moe_ffn(T(x), params, **kw)
    tokens = T(x).reshape(-1, M)
    dense = torch.nn.functional.gelu(tokens @ T(fc1_k) + T(fc1_b)) @ T(fc2_k) + T(fc2_b)
    _close(out.reshape(-1, M), dense, 1e-5)
    want, _, _, _ = _jax_moe(x, {k: v.numpy() for k, v in params.items()}, cot, **kw)
    _close(out, want, 1e-5)


def test_routing_holds_no_token_expert_slot_tensor():
    """At a training shape where C equals T (64 × 513 tokens, E 4, top-2,
    cf 2) one f32 (T, E, C) tensor would take 17.2 GB: run under an
    address-space cap of 8 GiB, which it could not fit."""
    code = (
        "import resource, torch\n"
        "from pointvit_tpu_torch.parallel import moe_ffn, init_moe_params\n"
        "resource.setrlimit(resource.RLIMIT_AS, (8 << 30, 8 << 30))\n"
        "torch.set_num_threads(1)\n"
        "x = torch.randn(64, 513, 8)\n"
        "out, aux = moe_ffn(x, init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4))\n"
        "assert out.shape == x.shape and torch.isfinite(out).all()\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


# -------------------------------------------------------------- the block and the model

@pytest.mark.parametrize("implementation", [None, "torch"])
def test_moe_vit_block_matches_jax(implementation):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pos = rng.standard_normal((2, 9, 32)).astype(np.float32)
    jblock = JMoEViTBlock(num_heads=4, num_experts=4, capacity_factor=NODROP, implementation="xla")
    with HIGHEST():
        variables = jax.jit(jblock.init)(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jax.jit(lambda v, a, b: jblock.apply(v, a, pos=b))(
            variables, jnp.asarray(x), jnp.asarray(pos)))
    block = MoEViTBlock(32, 4, 4, capacity_factor=NODROP, implementation=implementation)
    keys = block.state_dict().keys()
    block.load_state_dict(convert.flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, variables["params"])}, keys))
    got = block(T(x), pos=T(pos)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert isinstance(block.mlp, MoEMlp) and block.mlp.aux_loss is not None


def _jax_moe_model(points, seed=1):
    head = functools.partial(JClsHead, dropout_rate=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp4p_module, "ClsHead", head)
        jmodel = JPix4Point(**P4P)
        variables = jax.tree.map(lambda a: np.array(a, np.float32), jax.jit(jmodel.init)(
            {"params": jax.random.PRNGKey(seed)}, jnp.asarray(points[:1])))
    return jmodel, head, variables


def test_moe_pix4point_builds_the_jax_architecture_and_serves_as_jax():
    points = _clouds(11, 4, N_POINTS)
    jmodel, _, variables = _jax_moe_model(points)
    with HIGHEST():
        want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(
            variables, jnp.asarray(points)))
    model = convert.load_flax_variables(Pix4Point(**P4P), variables)
    kinds = [type(b).__name__ for b in model.model.blocks]
    assert kinds == ["ViTBlock", "MoEViTBlock"]
    back = convert.state_dict_to_flax(model)["params"]["model"]["blocks_1"]["mlp"]
    assert {k: v.shape for k, v in back.items()} == {
        k: v.shape for k, v in variables["params"]["model"]["blocks_1"]["mlp"].items()}
    got = model(T(points)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def step():
    """One training step of the small MoE Pix4Point on both sides, the loss
    with 0.5 × the collected aux loss."""
    rng = np.random.default_rng(0)
    points = _clouds(2, 8, N_POINTS)
    labels = rng.integers(0, P4P["num_classes"], 8)
    jmodel, head, variables = _jax_moe_model(points)
    aux_w = 0.5

    def loss_fn(params):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jp4p_module, "ClsHead", head)
            logits, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       jnp.asarray(points), train=True,
                                       mutable=["batch_stats", "intermediates"])
        ce = jnp.mean(jcross_entropy(logits.astype(jnp.float32), jnp.asarray(labels), 0.0))
        return ce + aux_w * jcollect_aux(upd["intermediates"]), upd["batch_stats"]

    with HIGHEST():
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        tx = jbuild_optimizer(optax.constant_schedule(1e-3), weight_decay=0.05,
                              weight_decay_mask=jweight_decay_mask)
        updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
        jparams = optax.apply_updates(variables["params"], updates)

    model = convert.load_flax_variables(Pix4Point(**P4P), variables)
    model.cls_head.dropout.rate = 0.0
    assert _group_max_gap(model.model.patch_embed, points) > 1e-5
    seen = []
    model.model.blocks[1].mlp.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach()))
    logits = model(T(points), train=True)
    loss = cross_entropy_loss(logits, T(labels)).mean() + aux_w * collect_moe_aux_loss(model)
    loss.backward()
    router_in = seen[0].reshape(-1, 32).numpy()
    _no_near_tie(router_in @ model.model.blocks[1].mlp.gate.detach().numpy(), 2)
    keys = model.state_dict().keys()
    return dict(model=model, loss=loss.item(), jloss=float(jloss),
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                jgrads=convert.flax_to_state_dict({"params": jax.tree.map(np.asarray, jgrads)}, keys),
                jparams=convert.flax_to_state_dict({"params": jax.tree.map(np.asarray, jparams)},
                                                   keys),
                variables=variables)


def test_moe_step_loss_matches_jax(step):
    assert abs(step["loss"] - step["jloss"]) <= 1e-5 * abs(step["jloss"])
    assert collect_moe_aux_loss(step["model"]).item() > 0


def test_moe_step_gradients_match_jax(step):
    want = step["jgrads"]
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    pre_bn = ("s0_conv1_1.bias", "cls_head.fc0.bias", "cls_head.fc1.bias", "model.norm.bias")
    assert set(step["grads"]) == set(want)
    for n, got in step["grads"].items():
        got, w = got.numpy(), want[n].numpy()
        if n.endswith(pre_bn):
            assert np.linalg.norm(got) <= 1e-6 * total and np.linalg.norm(w) <= 1e-6 * total, n
            continue
        err = np.linalg.norm(got - w) / np.linalg.norm(w)
        assert err <= 1e-4, f"{n}: relative L2 error {err:.3g}"
    for name in ("gate", "w1", "b1", "w2", "b2"):  # the router trains through the gates
        assert float(step["grads"][f"model.blocks.1.mlp.{name}"].abs().max()) > 0


def test_moe_step_update_matches_optax(step):
    model = step["model"]
    opt = build_optimizer(model, schedules.constant_schedule(1e-3), weight_decay=0.05,
                          no_decay=no_decay_names(model))
    convert.load_flax_variables(model, step["variables"])
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.grad = step["jgrads"][n].clone()
    opt.step()
    for n, p in model.named_parameters():
        want = step["jparams"][n].numpy()
        assert np.abs(p.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max(), n


def _p4p_configs(root):
    model_config = {"model_name": "Pix4Point", "num_classes": 15,
                    "pretrained_model": "vit_small_patch16_384", "pretrained": False,
                    "frozen": False, "k_neighbors": 4, "embed_dim": 32, "depth": 2, "num_heads": 4,
                    "bf16": False, "moe_experts": 2, "moe_every": 2}
    dataset_config = {"root_dir": root, "variant": "main_split", "augmentation": "base",
                      "num_points": 64, "normalize": True, "sampling_method": "all",
                      "use_custom_augmentation": True}
    train_config = {"batch_size": 8, "learning_rate": 5e-4, "weight_decay": 5e-2,
                    "save_interval": 10, "epochs": 1, "t_max": 1, "warmup_epochs": 1,
                    "min_lr": 1e-6, "grad_norm_clip": 10, "prefetch": 0}
    return model_config, dataset_config, train_config


def test_pix4point_trainer_applies_moe_aux(tmp_path):
    """JAX ``test_moe_block.py:102``: two trainers that differ only in
    ``moe_aux_weight`` see different losses on one batch and state."""
    root = str(tmp_path / "sonn")
    write_scanobjectnn_h5(root, num_train=16, num_test=8, num_points=64, num_classes=15)
    model_config, dataset_config, train_config = _p4p_configs(root)
    pts = torch.from_numpy(np.random.default_rng(7).standard_normal((8, 64, 3)).astype(np.float32))
    labels = torch.arange(8) % 15

    def step_loss(weight, out):
        torch.manual_seed(0)
        tr = Pix4PointTrainer(model_config, dataset_config,
                              {**train_config, "moe_aux_weight": weight},
                              device="cpu", output_dir=str(tmp_path / out))
        assert tr.model.moe_experts == 2  # the factory passes the key on
        loss, _, _ = tr.train_step(pts, labels)
        return float(loss), collect_moe_aux_loss(tr.model).item()

    l0, aux = step_loss(0.0, "a")
    l1, _ = step_loss(1.0, "b")
    assert aux > 0 and l1 == pytest.approx(l0 + aux, rel=1e-5)


def test_a_jax_checkpoint_of_the_moe_model_serves_as_jax(tmp_path):
    cfg = {"num_classes": 10, "pretrained_model": "vit_small_patch16_384", "embed_dim": 32,
           "depth": 2, "num_heads": 4, "k_neighbors": 8, "bf16": False, "moe_experts": 4,
           "moe_every": 2}
    from pointvit_tpu.models import factory as jfactory

    jmodel = jfactory.build_model(cfg, family="pix4point")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, N_POINTS, 3)))
    variables = {k: jax.tree.map(lambda a: np.array(a, np.float32), variables[k])
                 for k in ("params", "batch_stats")}
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              tx=optax.adamw(1e-3), batch_stats=variables["batch_stats"])
    path = jcheckpoint.save_checkpoint(str(tmp_path), "moe.msgpack", epoch=1, state=state,
                                       accuracy=0.5, model_config=cfg, dataset_config={},
                                       async_write=False)
    clouds = _clouds(13, 3, N_POINTS)
    with HIGHEST():
        want = np.asarray(JSession.from_checkpoint(path, buckets=(4,)).predict_logits(clouds))
    sess = InferenceSession.from_checkpoint(path, buckets=(4,), device="cpu")
    assert [type(b).__name__ for b in sess.model.model.blocks] == ["ViTBlock", "MoEViTBlock"]
    got = sess.predict_logits(clouds)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert build_model(cfg).model.blocks[1].mlp.num_experts == 4


# -------------------------------------------------------------- on gloo ranks

EP_CASES = {  # tag → (ranks, JAX mesh shape and names, moe_ffn options)
    "ep2_k1_cf4.0": (2, (2,), ("expert",), dict(top_k=1, capacity_factor=4.0)),
    "ep2_k2_cf4.0": (2, (2,), ("expert",), dict(top_k=2, capacity_factor=4.0)),
    "ep2_k1_cf0.5": (2, (2,), ("expert",), dict(top_k=1, capacity_factor=0.5)),
    "ep2_k2_cf0.5": (2, (2,), ("expert",), dict(top_k=2, capacity_factor=0.5)),
    "ep4_k1_cf4.0": (4, (4,), ("expert",), dict(top_k=1, capacity_factor=4.0)),
    "ep4_k2_cf4.0": (4, (4,), ("expert",), dict(top_k=2, capacity_factor=4.0)),
    "ep4_k1_cf0.5": (4, (4,), ("expert",), dict(top_k=1, capacity_factor=0.5)),
    "ep4_k2_cf0.5": (4, (4,), ("expert",), dict(top_k=2, capacity_factor=0.5)),
    "ep2_norm": (2, (2,), ("expert",), dict(normalize_gates=True)),
    "ep4_norm": (4, (4,), ("expert",), dict(normalize_gates=True)),
    "dpep": (4, (2, 2), ("data", "expert"), dict(capacity_factor=4.0, data_axis="data")),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank case of this file, in one spawn of 4 gloo ranks."""
    wd = str(tmp_path_factory.mktemp("moe_ranks"))
    x, params, cot = _inputs()
    torch.manual_seed(0)
    model = Pix4Point(**torch_dist_cases.P4P_MOE)
    rng = np.random.default_rng(4)
    torch.save(dict(x=x, cot=cot, params=params, p4p_state=model.state_dict(),
                    clouds=rng.standard_normal((8, 64, 3)).astype(np.float32),
                    clouds_labels=(np.arange(8) % 15).astype(np.int64)),
               os.path.join(wd, "inputs.pt"))
    torch_dist_cases.spawn("moe", wd, 4, timeout=300)
    return lambda name, r=0: torch.load(os.path.join(wd, f"{name}_{r}.pt"), weights_only=False)


@pytest.mark.parametrize("tag", sorted(EP_CASES))
def test_expert_parallel_moe_ffn_matches_jax_on_a_mesh(tag, ranks):
    n, shape, names, kw = EP_CASES[tag]
    x, params, cot = _inputs()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
    want, want_aux, wgx, wgp = _jax_moe(x, params, cot, mesh, **kw)
    got = [ranks(tag, r) for r in range(n)]
    _close(torch.cat([g["out"] for g in got]), want, 1e-5)
    _close(torch.cat([g["gx"] for g in got]), wgx, 1e-4, "x")
    for g in got:  # the aux loss is averaged over the mesh
        assert abs(float(g["aux"]) - want_aux) <= 1e-5 * want_aux
    for k in params:  # a rank's share: the router's over its tokens, its experts'
        _close(sum(g[f"g_{k}"] for g in got), wgp[k], 1e-4, k)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_pix4point_data_parallel_step_equals_the_one_process_step(cf, ranks):
    """Two ranks with global BatchNorm statistics, the load-balance terms
    averaged before their product and, at cf 0.5 (tokens dropped), the
    global batch's slots."""
    one, two = ranks(f"moe_dp_cf{cf}_single"), ranks(f"moe_dp_cf{cf}")
    assert torch.allclose(two["loss"], one["loss"], rtol=1e-5, atol=0)
    k = "cls_head.out.weight"
    np.testing.assert_allclose(two["state"][k], one["state"][k], rtol=1e-4, atol=1e-6)
    total = np.sqrt(sum(float((g ** 2).sum()) for g in one["grads"].values()))
    for n, g in one["grads"].items():
        if float(g.norm()) <= 1e-6 * total:  # an exactly-zero gradient's rounding noise
            assert float(two["grads"][n].norm()) <= 1e-5 * total, n
            continue
        assert _rel_l2(two["grads"][n], g) <= 1e-4, n
    for n, t in one["state"].items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(two["state"][n], t, rtol=1e-5, atol=1e-6, err_msg=n)
