"""Port parity for the whole APF serving path on the CPU: the weight bridge,
``AdaptPointFormer`` logits against the JAX model on the same weights, and
``InferenceSession``'s bucket padding and chunking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.models.apf import AdaptPointFormer as JAPF
from pointvit_tpu.ops import fps as jfps
from pointvit_tpu.ops import knn as jknn
from pointvit_tpu.ops import morton as jmorton
from pointvit_tpu_torch.convert import load_flax_variables
from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config
from pointvit_tpu_torch.ops import knn_kernel
from pointvit_tpu_torch.serve import InferenceSession

CFG = dict(num_classes=10, embedding_dim=64, npoint=16, nsample=8, in_channels=3, depth=2,
           num_heads=4, encoder_second_width=64)
N_POINTS = 128
# f32 on both sides; the two differ in summation order only, through two
# blocks, the encoder and the head.
LOGIT_REL_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    points = rng.standard_normal((3, N_POINTS, 3)).astype(np.float32)
    jmodel = JAPF(**CFG)
    variables = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(points[:1])))
    # Live adapters and non-trivial BN statistics (the init has a zero
    # up-projection, unit scale, zero means and unit variances).
    for i in range(CFG["depth"]):
        ad = variables["params"][f"blocks_{i}"]["adapter"]
        ad["up_proj"]["kernel"] = 0.1 * rng.standard_normal(ad["up_proj"]["kernel"].shape).astype(np.float32)
        ad["scale"] = np.array([0.7 + i], np.float32)
    for tree in (variables["batch_stats"]["point_encoder"], variables["batch_stats"]["head"]):
        for stats in tree.values():
            stats["mean"] = 0.2 * rng.standard_normal(stats["mean"].shape).astype(np.float32)
            stats["var"] = (0.5 + rng.random(stats["var"].shape)).astype(np.float32)
    model = load_flax_variables(AdaptPointFormer(**CFG), variables).eval()
    return points, jmodel, variables, model


def test_bridge_round_trips_a_jax_init(case):
    _, _, variables, model = case
    sd = model.state_dict()
    p = variables["params"]
    np.testing.assert_array_equal(sd["blocks.1.attention.qkv.weight"].numpy(),
                                  p["blocks_1"]["attention"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.0.adapter.scale"].numpy(), p["blocks_0"]["adapter"]["scale"])
    np.testing.assert_array_equal(sd["encoder_norm.weight"].numpy(), p["encoder_norm"]["scale"])
    np.testing.assert_array_equal(sd["head.bn1.running_var"].numpy(),
                                  variables["batch_stats"]["head"]["bn1"]["var"])
    np.testing.assert_array_equal(sd["point_encoder.first_bn0.weight"].numpy(),
                                  p["point_encoder"]["first_bn0"]["scale"])
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert n_leaves == len([k for k in sd if not k.endswith("num_batches_tracked")])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_raises_on_a_tree_that_does_not_fit(case, fault):
    _, _, variables, _ = case
    bad = jax.tree.map(lambda a: a, variables)
    if fault == "missing":
        del bad["params"]["head"]["out"]["bias"]
    elif fault == "extra":
        bad["params"]["head"]["out"]["extra"] = np.zeros(3, np.float32)
    else:
        bad["params"]["head"]["out"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises((KeyError, ValueError)):
        load_flax_variables(AdaptPointFormer(**CFG), bad)


def test_neighbour_sets_agree_with_exact_topk(case):
    """The port's packed key and JAX's exact top-k pick the same neighbours
    for this seed; if not, the logits test below would fail for that reason."""
    points, _, _, _ = case
    xyz = jnp.asarray(points)
    with jax.default_matmul_precision("highest"):
        center = jfps.fps_gather(xyz, jfps.farthest_point_sample(xyz, CFG["npoint"]))
        order = jmorton.morton_argsort(center)
        center = jnp.take_along_axis(center, order[:, :, None], axis=1)
        exact = np.asarray(jknn.knn_indices(center, xyz, CFG["nsample"]))
    packed, _ = knn_kernel.knn_group(torch.from_numpy(points), torch.from_numpy(np.array(center)),
                                     torch.from_numpy(points), CFG["nsample"])
    np.testing.assert_array_equal(np.sort(packed.numpy(), -1), np.sort(exact, -1))


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_logits_match_the_jax_model(case, implementation):
    points, jmodel, variables, model = case
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(variables, jnp.asarray(points)))
    if implementation:
        plain = AdaptPointFormer(**CFG, implementation=implementation)
        plain.load_state_dict(model.state_dict())
        model = plain.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(points)).numpy()
    assert got.shape == (3, CFG["num_classes"]) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_REL_TOL, err


@pytest.mark.parametrize("n_points", [1000, 4096])
def test_logits_match_the_jax_model_off_the_packed_knn(case, n_points):
    """Clouds the packed-key kNN does not take (N % 128 ≠ 0, N > 2048) go
    to the exact top-k, as in the JAX package; 4096 points raised before."""
    _, jmodel, variables, model = case
    points = np.random.default_rng(n_points).standard_normal((2, n_points, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(variables, jnp.asarray(points)))
    with torch.inference_mode():
        got = model(torch.from_numpy(points)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_REL_TOL, err


def test_session_padding_and_chunking_match_one_forward(case):
    points, _, _, model = case
    rng = np.random.default_rng(1)
    clouds = rng.standard_normal((9, N_POINTS, 3)).astype(np.float32)
    with torch.inference_mode():
        want = model(torch.from_numpy(clouds)).numpy()
    sess = InferenceSession(model, buckets=(4, 2), device="cpu")
    assert sess.buckets == (2, 4)
    sess.warmup(clouds[0])
    for n in (1, 3, 4, 9):  # pad to 2, pad to 4, exact, chunks 4+4+1
        got = sess.predict_logits(clouds[:n])
        assert got.shape == (n, CFG["num_classes"])
        np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sess.predict(clouds[:3]), want[:3].argmax(-1))


def test_bf16_model_tracks_f32(case):
    points, _, _, model = case
    bf = AdaptPointFormer(**CFG, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    with torch.inference_mode():
        got = bf.eval()(torch.from_numpy(points))
        want = model(torch.from_numpy(points))
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err <= 0.05, err


def test_train_raises_and_preset_is_slim2():
    """``train=True`` runs: finite logits, and every BatchNorm's running
    statistics move. A wrong channel count raises; the preset is slim2."""
    model = AdaptPointFormer(**CFG)
    before = {k: v.clone() for k, v in model.state_dict().items() if k.endswith("running_var")}
    pts = torch.from_numpy(np.random.default_rng(2).standard_normal((4, N_POINTS, 3)).astype(np.float32))
    logits = model(pts, train=True, generator=torch.Generator().manual_seed(0))
    assert logits.shape == (4, CFG["num_classes"]) and torch.isfinite(logits).all()
    assert len(before) == 5
    for k, v in before.items():
        assert not torch.equal(model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="channels"):
        model(torch.zeros(1, N_POINTS, 4))
    cfg = apf_preset_config("slim2")
    assert (cfg["embedding_dim"], cfg["depth"], cfg["num_heads"], cfg["npoint"], cfg["nsample"],
            cfg["encoder_second_width"], cfg["num_classes"], cfg["dtype"]) == (
        768, 12, 12, 196, 16, 384, 40, torch.bfloat16)


# A sequence above the fused blocks' gate (S ≤ 1024 at head dim 64): one
# head of 64, so the gate decides; npoint 1040 over one 2048-point cloud.
LONG_CFG = dict(num_classes=10, embedding_dim=64, npoint=1040, nsample=8, in_channels=3, depth=1,
                num_heads=1, encoder_second_width=64)


def test_apf_above_the_fused_gate_runs_unfused_and_matches_the_jax_model(monkeypatch):
    """Above S = 1024 the APF block leaves its fused chain for its unfused
    forward (the JAX package's dispatch, whose attention kernel takes any
    S); at S ≤ 1024 it keeps the chain. The logits at S = 1040 match the
    JAX model's."""
    from pointvit_tpu_torch.nn import vit

    rng = np.random.default_rng(3)
    points = rng.standard_normal((1, 2048, 3)).astype(np.float32)
    jmodel = JAPF(**LONG_CFG)
    variables = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(2)},
                                              jnp.asarray(points)))
    ad = variables["params"]["blocks_0"]["adapter"]
    ad["up_proj"]["kernel"] = 0.1 * rng.standard_normal(ad["up_proj"]["kernel"].shape).astype(np.float32)
    model = load_flax_variables(AdaptPointFormer(**LONG_CFG), variables).eval()

    taken = []
    unfused, fused = vit.APFBlock.forward_unfused, vit.fused_apf_block
    monkeypatch.setattr(vit.APFBlock, "forward_unfused",
                        lambda self, x, **kw: taken.append(("unfused", x.shape[1])) or unfused(self, x, **kw))
    monkeypatch.setattr(vit, "fused_apf_block",
                        lambda x, *a: taken.append(("fused", x.shape[1])) or fused(x, *a))
    with torch.inference_mode():
        got = model(torch.from_numpy(points)).numpy()
    assert taken == [("unfused", 1040)]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(variables, jnp.asarray(points)))
    assert got.shape == (1, LONG_CFG["num_classes"]) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_REL_TOL, err

    short = AdaptPointFormer(**{**LONG_CFG, "npoint": 1024})
    short.load_state_dict(model.state_dict())
    taken.clear()
    with torch.inference_mode():
        short.eval()(torch.from_numpy(points))
    assert taken == [("fused", 1024)]
