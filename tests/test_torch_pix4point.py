"""Port parity for Pix4Point serving on the CPU: the P3Embed grouping, the
folded P3 stage, the P3Embed and positional modules, the whole model's
logits against the JAX model on bridged weights, the factory and the
serving session.

Small sizes: depth 2, E=128, two heads of 64, 128 points → 32 tokens + cls,
k=8. Inputs are made with numpy from a seed. f32 parity is to 1e-5 relative
to the largest output for single stages and 1e-4 for the whole model (two
blocks, the tokenizer and the head, differing in summation order only). The
port's grouping takes the packed-key kNN at 128 points, as the JAX package
does on its accelerator; JAX's CPU dispatch takes an exact top-k, so the
whole-model test asserts that its seed has no near-tie at the k-th
neighbour within the packed key's resolution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.models import factory as jfactory
from pointvit_tpu.models.pix4point import Pix4Point as JPix4Point
from pointvit_tpu.nn.pointnet import P3Embed as JP3Embed
from pointvit_tpu.nn.pointnet import PosEmbedMLP as JPosEmbed
from pointvit_tpu.ops import fps as jfps
from pointvit_tpu.ops import group as jgroup
from pointvit_tpu.ops import pallas_encoder
from pointvit_tpu.ops.pallas_knn import knn_group_pallas
from pointvit_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from pointvit_tpu_torch.models import Pix4Point, build_model
from pointvit_tpu_torch.nn.pointnet import P3Embed, PosEmbedMLP
from pointvit_tpu_torch.ops import knn_kernel, p3_kernel
from pointvit_tpu_torch.ops.group import p3_group
from pointvit_tpu_torch.serve import InferenceSession

T = torch.from_numpy
CFG = dict(num_classes=10, embed_dim=128, depth=2, num_heads=2, k_neighbors=8)
N_POINTS, TOKENS, K = 128, 32, 8
REL_TOL = 1e-5
LOGIT_REL_TOL = 1e-4
BF16_REL_TOL = 2.0**-6
PACKED_KEY_RESOLUTION = 2.0**-12  # the key's stolen mantissa bits perturb by ≤ 2^-13 at N=128


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


def _live_stats(tree, rng):
    """Non-trivial BatchNorm statistics in a flax batch_stats subtree."""
    for v in tree.values():
        if "mean" in v:
            v["mean"] = 0.2 * rng.standard_normal(v["mean"].shape).astype(np.float32)
            v["var"] = (0.5 + rng.random(v["var"].shape)).astype(np.float32)
        else:
            _live_stats(v, rng)


def _clouds(seed, B=3, N=N_POINTS):
    return np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)


def _kth_gaps(points):
    """Relative gap between each centre's k-th and (k+1)-th nearest point
    (f64 distances), at the JAX package's FPS centres."""
    centers = np.asarray(jfps.fps_gather(jnp.asarray(points),
                                         jfps.farthest_point_sample(jnp.asarray(points), TOKENS)))
    d = ((centers[:, :, None, :].astype(np.float64) - points[:, None, :, :]) ** 2).sum(-1)
    d = np.sort(d, axis=-1)
    return (d[..., K] - d[..., K - 1]) / d[..., K]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    points = _clouds(0)
    assert _kth_gaps(points).min() > PACKED_KEY_RESOLUTION  # no near-tie at the k-th neighbour
    jmodel = JPix4Point(**CFG)
    variables = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(points[:1])))
    _live_stats(variables["batch_stats"], rng)
    p = variables["params"]["model"]
    for i in range(CFG["depth"]):  # live LN affines (the init is 1 and 0)
        for ln in ("norm1", "norm2"):
            p[f"blocks_{i}"][ln]["scale"] = (1 + 0.2 * rng.standard_normal(128)).astype(np.float32)
            p[f"blocks_{i}"][ln]["bias"] = (0.1 * rng.standard_normal(128)).astype(np.float32)
    model = load_flax_variables(Pix4Point(**CFG), variables).eval()
    return points, jmodel, variables, model


# --------------------------------------------------------------- grouping


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_p3_group_takes_the_packed_key_path_of_the_jax_kernel(implementation):
    points = _clouds(1)
    jc = jfps.fps_gather(jnp.asarray(points), jfps.farthest_point_sample(jnp.asarray(points), TOKENS))
    combined = jnp.concatenate([jnp.asarray(points), jnp.asarray(points)], axis=-1)
    want_idx, want = knn_group_pallas(jnp.asarray(points), jc, combined, K, interpret=True)
    centers, gp, gf = p3_group(T(points), T(points), TOKENS, K, implementation=implementation)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    idx, _ = knn_kernel.knn_group(T(points), centers, T(points), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # JAX gathers a split-bf16 payload (~2^-16 relative); the port is exact f32.
    want = np.asarray(want)
    np.testing.assert_allclose(gp.numpy(), want[..., :3], rtol=2.0**-15, atol=0)
    np.testing.assert_allclose(gf.numpy(), want[..., 3:], rtol=2.0**-15, atol=0)
    np.testing.assert_array_equal(gp.numpy(), points[np.arange(3)[:, None, None], idx.numpy()])
    _, rel, _ = p3_group(T(points), T(points), TOKENS, K, relative_pos=True,
                         implementation=implementation)
    np.testing.assert_array_equal(rel.numpy(), (gp - centers[:, :, None, :]).numpy())


def test_p3_group_exact_topk_off_the_lane_grid():
    """N % 128 != 0: an exact top-k on both sides, as in JAX's XLA path."""
    points = _clouds(2, N=100)
    feats = np.random.default_rng(3).standard_normal((3, 100, 5)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jc, jgp, jgf = jgroup.p3_group(jnp.asarray(points), jnp.asarray(feats), 25, K)
    centers, gp, gf = p3_group(T(points), T(feats), 25, K)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=0, atol=0)
    np.testing.assert_allclose(gf.numpy(), np.asarray(jgf), rtol=0, atol=0)


# --------------------------------------------------------------- P3 stage

M, C = 3 * TOKENS, 6


def _p3_case(seed, layers=4):
    rng = np.random.default_rng(seed)
    points = _clouds(seed)
    jmod = JP3Embed(k=K, layers=layers, implementation="xla")
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(points),
                                            jnp.asarray(points)))
    _live_stats(variables["batch_stats"], rng)
    mod = load_flax_variables(P3Embed(k=K, layers=layers), variables).eval()
    x = rng.standard_normal((M, K, C)).astype(np.float32)
    return points, x, jmod, variables, mod


def test_fold_matches_jax():
    _, _, _, variables, mod = _p3_case(4)
    want = pallas_encoder.fold_p3_stage_params(variables["params"], variables["batch_stats"])
    got = p3_kernel.fold_p3_stage_params(mod)
    assert [tuple(g.shape) for g in got] == [(6, 256), (256,), (256, 512), (256, 512), (512,),
                                            (512, 256), (256,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["plain", "chain", "plan"])
def test_p3_stage_matches_the_jax_kernel(path):
    _, x, _, variables, mod = _p3_case(5)
    with jax.default_matmul_precision("highest"):
        jw = pallas_encoder.fold_p3_stage_params(variables["params"], variables["batch_stats"])
        want_kernel = pallas_encoder.fused_p3_embed(jnp.asarray(x), jw, True)
        want_ref = pallas_encoder.reference_folded_p3(jnp.asarray(x), jw)
    w = p3_kernel.fold_p3_stage_params(mod)
    fn = {"plain": p3_kernel.fused_p3_embed, "chain": p3_kernel.launch_chain, "plan": p3_kernel.launch_plan}[path]
    got = fn(T(x), w)
    _assert_rel(got, want_kernel)
    _assert_rel(got, want_ref)


def test_p3_stage_bf16_rounds_like_the_pallas_kernel():
    _, x, _, variables, mod = _p3_case(6)
    jw = pallas_encoder.fold_p3_stage_params(variables["params"], variables["batch_stats"])
    want = pallas_encoder.fused_p3_embed(jnp.asarray(x, jnp.bfloat16), jw, True)
    w = p3_kernel.fold_p3_stage_params(mod)
    xb = T(x).to(torch.bfloat16)
    got = p3_kernel.reference_folded_p3(xb, w)
    assert got.dtype == torch.bfloat16
    _assert_rel(got.float(), np.asarray(want.astype(jnp.float32)), BF16_REL_TOL)
    _assert_rel(p3_kernel.launch_chain(xb, w).float(), got.float(), BF16_REL_TOL)
    # the three launches (h recomputed in the head) round where the chain does: the same bits
    plan = p3_kernel.launch_plan(xb, w)
    torch.testing.assert_close(plan, p3_kernel.launch_chain(xb, w), rtol=0, atol=0)
    torch.testing.assert_close(plan, got, rtol=0, atol=0)


@pytest.mark.parametrize("layers", [4, 6])
def test_p3embed_matches_the_jax_module(layers):
    """layers=4 takes the folded stage (held against the unfused body too);
    layers=6 fails the fused gate and runs the unfused body."""
    points, _, jmod, variables, mod = _p3_case(7, layers)
    assert _kth_gaps(points).min() > PACKED_KEY_RESOLUTION
    with jax.default_matmul_precision("highest"):
        jc, jtok = jax.jit(lambda v, p: jmod.apply(v, p, p))(variables, jnp.asarray(points))
    with torch.no_grad():
        centers, tokens = mod(T(points), T(points))
        np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
        assert tokens.shape == (3, TOKENS, 256)
        _assert_rel(tokens, jtok)
        if layers == 4:
            _, gp, gf = p3_group(T(points), T(points), TOKENS, K)
            _assert_rel(mod.stage_unfused(torch.cat([gp, gf], -1)), tokens)


def test_p3embed_off_the_kernel_shapes_runs_stage_unfused(monkeypatch):
    """B·S % 16 != 0 (3 clouds of 100 points: S = 25): with
    ``implementation=None`` the module takes ``stage_unfused``, as the JAX
    module takes its unfused stack there (the CUDA branch is pinned in
    tests/test_torch_cuda.py), and matches the JAX module."""
    rng = np.random.default_rng(9)
    points = _clouds(9, B=3, N=100)
    jmod = JP3Embed(k=K)
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(9), jnp.asarray(points),
                                            jnp.asarray(points)))
    _live_stats(variables["batch_stats"], rng)
    mod = load_flax_variables(P3Embed(k=K), variables).eval()
    assert mod.implementation is None and mod.layers == 4
    calls, real = [], mod.stage_unfused
    monkeypatch.setattr(mod, "stage_unfused", lambda x: calls.append(x.shape) or real(x))
    with jax.default_matmul_precision("highest"):
        jc, jtok = jax.jit(lambda v, p: jmod.apply(v, p, p))(variables, jnp.asarray(points))
    with torch.no_grad():
        centers, tokens = mod(T(points), T(points))
    assert calls == [(3, 25, K, 6)]
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    _assert_rel(tokens, jtok)


def test_pos_embed_mlp_matches_jax():
    xyz = _clouds(8, N=TOKENS)
    jmod = JPosEmbed(128)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(8), jnp.asarray(xyz)))
    with jax.default_matmul_precision("highest"):
        want = jmod.apply(variables, jnp.asarray(xyz))
    got = load_flax_variables(PosEmbedMLP(128), variables)(T(xyz))
    _assert_rel(got.detach(), want)


# --------------------------------------------------------------- the model


def test_bridge_maps_the_pix4point_names(case):
    _, _, variables, model = case
    sd = model.state_dict()
    p = variables["params"]["model"]
    np.testing.assert_array_equal(sd["model.cls_token"].numpy(), p["cls_token"])
    np.testing.assert_array_equal(sd["model.blocks.1.attn.qkv.weight"].numpy(),
                                  p["blocks_1"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["model.patch_embed.s0_conv2_bn1.running_var"].numpy(),
                                  variables["batch_stats"]["model"]["patch_embed"]["s0_conv2_bn1"]["var"])
    keys = flax_to_state_dict({"params": {"model": {"cls_token": np.zeros((1, 1, 4)),
                                                    "blocks_3": {"attn": {"qkv": {"kernel": np.zeros((4, 12))}}}}}},
                              set())
    assert sorted(keys) == ["model.blocks.3.attn.qkv.weight", "model.cls_token"]


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_logits_match_the_jax_model(case, implementation):
    points, jmodel, variables, model = case
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p))(variables, jnp.asarray(points)))
    if implementation:
        plain = Pix4Point(**CFG, implementation=implementation)
        plain.load_state_dict(model.state_dict())
        model = plain.eval()
    with torch.inference_mode():
        got = model(T(points)).numpy()
    assert got.shape == (3, CFG["num_classes"]) and np.isfinite(got).all()
    _assert_rel(got, want, LOGIT_REL_TOL)


def test_bf16_model_tracks_f32(case):
    points, _, _, model = case
    bf = Pix4Point(**CFG, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    with torch.inference_mode():
        got = bf.eval()(T(points))
        want = model(T(points))
    assert got.dtype == torch.bfloat16
    _assert_rel(got.float(), want, 0.05)


def test_session_padding_and_chunking_match_one_forward(case):
    _, _, _, model = case
    clouds = _clouds(9, B=5)
    with torch.inference_mode():
        want = model(T(clouds)).numpy()
    sess = InferenceSession(model, buckets=(2, 4), device="cpu")
    for n in (1, 3, 5):  # pad to 2, pad to 4, chunks 4 + 1
        np.testing.assert_allclose(sess.predict_logits(clouds[:n]), want[:n], rtol=1e-5, atol=1e-5)


APF_CFG = dict(num_classes=10, in_channels=3, embedding_dim=64, npoint=16, nsample=8, depth=2,
               num_heads=4, encoder_second_width=64)
P4P_CFG = dict(model_name="Pix4Point", pretrained_model="vit_small_patch16_384", pretrained=True,
               frozen=False, num_classes=15, k_neighbors=8, embed_dim=128, depth=2, num_heads=2)


@pytest.mark.parametrize("cfg", [APF_CFG, P4P_CFG], ids=["apf", "pix4point"])
def test_build_model_builds_the_jax_architecture(cfg):
    jm = jfactory.build_model({**cfg, "bf16": False})
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, N_POINTS, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), variables)
    model = build_model(cfg)
    assert jfactory.detect_family(cfg) == type(model).__name__.lower().replace("adaptpointformer", "apf")
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    bridged = {k: tuple(v.shape) for k, v in flax_to_state_dict(variables, own.keys()).items()}
    assert own == bridged
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_what_is_not_ported_raises():
    moe = Pix4Point(**CFG, moe_experts=4, moe_every=2)  # the MoE trunk is ported (A11)
    assert [type(b).__name__ for b in moe.model.blocks][:2] == ["ViTBlock", "MoEViTBlock"]
    with pytest.raises(NotImplementedError, match="A12"):  # quantized=True serves (B10 ported)
        build_model({**APF_CFG, "remat_encoder": True})
    with pytest.raises(ValueError, match="preset"):
        build_model({**P4P_CFG, "pretrained_model": "vit_huge"})
