"""Port parity for the options of the public ``nn`` classes on the CPU:
a two-stage ``P3Embed`` (``sample_ratio=1/16``), ``AdapterLayer(add_residual=False)``,
``Mlp(out_features=...)`` and ``ClsHead(mlps=, dropout_rate=)``, each
against the JAX module on weights carried by the weight bridge, which is
also held to give the JAX tree back.

f32 on both sides, the JAX side under ``jax.default_matmul_precision("highest")``;
outputs within 1e-5 of the largest. The two-stage tokenizer takes 128 points
to 32 and 8 tokens with k = 8: the port groups the first stage with the
packed-key kNN (N = 128), JAX's CPU dispatch with an exact top-k, so the
seed asserts no near tie at either stage's k-th neighbour within the key's
resolution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.nn.heads import ClsHead as JClsHead
from pointvit_tpu.nn.layers import AdapterLayer as JAdapterLayer
from pointvit_tpu.nn.layers import Mlp as JMlp
from pointvit_tpu.nn.pointnet import P3Embed as JP3Embed
from pointvit_tpu.ops import fps as jfps
from pointvit_tpu_torch.convert import load_flax_variables, state_dict_to_flax
from pointvit_tpu_torch.nn import AdapterLayer, ClsHead, Mlp, P3Embed
from pointvit_tpu_torch.ops import p3_kernel
from pointvit_tpu_torch.ops.group import p3_group

T = torch.from_numpy
HIGHEST = lambda: jax.default_matmul_precision("highest")  # noqa: E731
REL_TOL = 1e-5
N_POINTS, K, EMBED = 128, 8, 64
KEY_RESOLUTION = 2.0**-12  # the packed key's stolen mantissa bits perturb by ≤ 2^-13 at N = 128


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


def _live_stats(tree, rng):
    for v in tree.values():
        if "mean" in v:
            v["mean"] = 0.2 * rng.standard_normal(v["mean"].shape).astype(np.float32)
            v["var"] = (0.5 + rng.random(v["var"].shape)).astype(np.float32)
        else:
            _live_stats(v, rng)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{path}/{k}")


def _kth_gap(points, n_centers):
    """Least relative gap between a centre's k-th and (k+1)-th nearest point
    (f64 distances) at the JAX FPS centres (start 0), and the centres."""
    jp = jnp.asarray(points)
    centers = np.asarray(jfps.fps_gather(jp, jfps.farthest_point_sample(jp, n_centers)))
    d = np.sort(((centers[:, :, None].astype(np.float64) - points[:, None]) ** 2).sum(-1), axis=-1)
    return ((d[..., K] - d[..., K - 1]) / d[..., K]).min(), centers


# ------------------------------------------------------------- P3Embed


@pytest.fixture(scope="module")
def two_stage():
    """A two-stage tokenizer on both sides, its JAX variables with live
    BatchNorm statistics, and clouds with no near tie at either stage."""
    points = np.random.default_rng(0).standard_normal((2, N_POINTS, 3)).astype(np.float32)
    gap0, centers = _kth_gap(points, N_POINTS // 4)
    gap1, _ = _kth_gap(centers, N_POINTS // 16)
    assert min(gap0, gap1) > KEY_RESOLUTION, (gap0, gap1)
    kw = dict(sample_ratio=1 / 16, scale=4, k=K, embed_dim=EMBED)
    jmods = {impl: JP3Embed(**kw, implementation=impl) for impl in ("xla", "fused")}
    variables = _np_tree(jax.jit(jmods["xla"].init)(jax.random.PRNGKey(5), jnp.asarray(points),
                                                    jnp.asarray(points)))
    _live_stats(variables["batch_stats"], np.random.default_rng(6))
    mod = load_flax_variables(P3Embed(**kw), variables).eval()
    return points, jmods, variables, mod


def test_p3embed_builds_every_stage_jax_builds(two_stage):
    _, _, variables, mod = two_stage
    assert mod.stages == 2 and mod.embed_dim == EMBED
    stage_names = {k.split("_")[0] for k in variables["params"]}
    assert stage_names == {"s0", "s1"}
    assert mod.s0_conv2_1.out_features == EMBED // 2 and mod.s1_conv2_1.out_features == EMBED
    assert mod.s1_conv1_0.in_features == 3 + EMBED // 2
    _assert_trees_equal(state_dict_to_flax(mod), variables)  # the bridge carries s1_* back


@pytest.mark.parametrize("jax_impl", ["xla", "fused"])
@pytest.mark.parametrize("implementation", [None, "torch"])
def test_two_stage_p3embed_matches_jax(two_stage, jax_impl, implementation):
    """The port folds each stage (its plain version on the CPU); JAX runs
    its unfused stacks ('xla') or its stage kernel in interpret mode
    ('fused') at each stage."""
    points, jmods, variables, mod = two_stage
    mod.implementation = implementation
    with HIGHEST():
        jc, jtok = jax.jit(lambda v, p: jmods[jax_impl].apply(v, p, p))(variables, jnp.asarray(points))
    with torch.no_grad():
        centers, tokens = mod(T(points), T(points))
    assert tokens.shape == (2, N_POINTS // 16, EMBED)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    _assert_rel(tokens, jtok)


def test_two_stage_p3embed_trains_as_jax(two_stage):
    """Train mode: every stage unfused on batch statistics, and both stages'
    running statistics updated as flax updates them."""
    points, jmods, variables, mod = two_stage
    fresh = load_flax_variables(P3Embed(sample_ratio=1 / 16, k=K, embed_dim=EMBED), variables)
    with HIGHEST():
        (jc, jtok), upd = jax.jit(lambda v, p: jmods["xla"].apply(
            v, p, p, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(points))
    centers, tokens = fresh(T(points), T(points), train=True)
    np.testing.assert_array_equal(centers.detach().numpy(), np.asarray(jc))
    _assert_rel(tokens.detach(), jtok)
    back = state_dict_to_flax(fresh)["batch_stats"]
    for name, stats in _np_tree(upd["batch_stats"]).items():
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(back[name][leaf], stats[leaf], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}/{leaf}")


def test_second_stage_takes_the_chain_of_the_off_gate_shapes(two_stage):
    """Stage 1's groups carry 3 + the stage-0 width channels, above the
    group-MLP kernels' 16: on the card it takes the GEMM chain. The chain's
    calls (each GEMM's plain version on the CPU) give the folded stage's
    plain version."""
    points, _, _, mod = two_stage
    with torch.no_grad():
        c0, dp, fj = p3_group(T(points), T(points), N_POINTS // 4, K)
        t0 = mod.stage_unfused(torch.cat([dp, fj], -1))
        _, dp1, fj1 = p3_group(c0, t0, N_POINTS // 16, K)
        x1 = torch.cat([dp1, fj1], -1).reshape(-1, K, 3 + EMBED // 2)
        fold = p3_kernel.fold_p3_stage_params(mod, 1)
        assert not p3_kernel.takes_group_mlp(x1.bfloat16(), fold)
        _assert_rel(p3_kernel.launch_chain(x1, fold), p3_kernel.reference_folded_p3(x1, fold))


def test_p3embed_rejects_ratios_with_no_stage():
    with pytest.raises(ValueError, match="no stage"):
        P3Embed(sample_ratio=1.0)


# ------------------------------------------------- Mlp, AdapterLayer, ClsHead


def _jax_case(jmod, x, seed, **apply_kw):
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    with HIGHEST():
        want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, **apply_kw))(variables, jnp.asarray(x)))
    return variables, want


@pytest.mark.parametrize("out_features", [None, 24])
def test_mlp_out_features_matches_jax(out_features):
    x = np.random.default_rng(1).standard_normal((2, 5, 16)).astype(np.float32)
    variables, want = _jax_case(JMlp(hidden_features=40, out_features=out_features), x, 1)
    mod = load_flax_variables(Mlp(16, 40, out_features=out_features), variables)
    with torch.no_grad():
        got = mod(T(x))
    assert got.shape[-1] == (out_features or 16)
    _assert_rel(got, want)
    _assert_trees_equal(state_dict_to_flax(mod)["params"], variables["params"])


@pytest.mark.parametrize("add_residual", [True, False])
def test_adapter_add_residual_matches_jax(add_residual):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jmod = JAdapterLayer(bottleneck=8, add_residual=add_residual)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    up = variables["params"]["up_proj"]  # live: the init is zero
    up["kernel"] = 0.3 * rng.standard_normal(up["kernel"].shape).astype(np.float32)
    up["bias"] = 0.1 * rng.standard_normal(up["bias"].shape).astype(np.float32)
    variables["params"]["scale"] = np.array([1.5], np.float32)
    with HIGHEST():
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    mod = load_flax_variables(AdapterLayer(16, 8, add_residual=add_residual), variables)
    with torch.no_grad():
        got = mod(T(x))
    _assert_rel(got, want)
    if not add_residual:  # no x inside: the branch alone
        with torch.no_grad():
            with_res = AdapterLayer(16, 8)
            with_res.load_state_dict(mod.state_dict())
            _assert_rel(with_res(T(x)) - T(x), want)


def test_cls_head_mlps_and_dropout_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 20)).astype(np.float32)
    jmod = JClsHead(num_classes=5, mlps=(32, 16, 8), dropout_rate=0.25)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    _live_stats(variables["batch_stats"], rng)
    with HIGHEST():
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    mod = load_flax_variables(ClsHead(20, 5, mlps=(32, 16, 8), dropout_rate=0.25), variables).eval()
    assert mod.dropout.rate == 0.25
    with torch.no_grad():
        _assert_rel(mod(T(x)), want)
    _assert_trees_equal(state_dict_to_flax(mod), variables)
