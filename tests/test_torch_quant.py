"""Port parity for quantized (dynamic w8a8) APF serving on the CPU.

The int8 dense product is held bit for bit: the port's plain version
against JAX's ``dynamic_quant_matmul`` and flax's ``QuantDense``, and the
weight quantizer against JAX's ``quantize_weight``. The Pallas kernel in
interpret mode is held at the JAX package's own tolerance
(``tests/test_quant.py``): it computes the row scale ``amax / 127`` as
``amax · (1/127)``, which moves some scales by one ulp and the rounded
int8 values with them.

The whole quantized model cannot be held as tightly as the float one: a
one-ulp difference before a quantizer (the float parts differ from JAX in
summation order) moves an int8 value by one step, and the logits of this
tiny model move by up to 0.73 % of max |logit| under a 1e-6 relative
jitter of the input (5 seeds: 0.31, 0.0001, 0.35, 0.73, 0.12 %), while the
float model moves by 8e-7. So the modules' wiring is held by structure and
dispatch, and the whole model at 2e-2 of max |logit| with every argmax
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.models.apf import AdaptPointFormer as JAPF
from pointvit_tpu.nn.quant import QuantDense
from pointvit_tpu.nn.quant import dynamic_quant_matmul as jax_dynamic_quant_matmul
from pointvit_tpu.ops import pallas_quant
from pointvit_tpu_torch.convert import load_flax_variables
from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config, build_model
from pointvit_tpu_torch.nn import pointnet, vit
from pointvit_tpu_torch.nn.quant import QuantLinear, dense, dynamic_quant_matmul
from pointvit_tpu_torch.nn.vit import APFBlock
from pointvit_tpu_torch.ops import quant_kernel

T = torch.from_numpy
CFG = dict(num_classes=10, embedding_dim=64, npoint=16, nsample=8, in_channels=3, depth=2,
           num_heads=4, encoder_second_width=64)
N_POINTS = 128
# Whole quantized model against JAX's, as a share of max |logit| (see above).
QUANT_LOGIT_REL_TOL = 2e-2
# The JAX package's own bound for its Pallas kernel against the XLA formulation.
PALLAS_REL_TOL = 2e-2
QUANTIZED_LAYERS = {"point_encoder.first_1", "point_encoder.first_2",
                    "point_encoder.second_0_local", "point_encoder.second_1"} | {
    f"blocks.{i}.{name}" for i in range(CFG["depth"])
    for name in ("attention.qkv", "attention.proj", "mlp.fc1", "mlp.fc2")}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _operands(seed, lead, K, N):
    """x (*lead, K) with rows of zeros, 1e-12 and 1e6 first; a kernel (K, N)
    in the JAX layout; a bias (N,)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    rows = x.reshape(-1, K)
    rows[0], rows[1], rows[2] = 0.0, 1e-12, 1e6
    kernel = (rng.standard_normal((K, N)) * K**-0.5).astype(np.float32)
    return x, kernel, rng.standard_normal(N).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,K,N", [((256,), 768, 2304), ((300,), 96, 64), ((4, 50), 96, 64)])
def test_dense_product_is_bit_equal_to_jax(dtype, lead, K, N):
    tdt, jdt = DTYPES[dtype]
    x, kernel, bias = _operands(K + N, lead, K, N)
    jx = jnp.asarray(x).astype(jdt)
    want = (jax_dynamic_quant_matmul(jx, jnp.asarray(kernel)) + bias).astype(jdt)
    tx = T(x).to(tdt)
    got = (dynamic_quant_matmul(tx, T(kernel.T.copy())) + T(bias)).to(tdt)
    np.testing.assert_array_equal(_bits(got.float()), _bits(want.astype(jnp.float32)))

    lin = QuantLinear(K, N)
    with torch.no_grad():
        lin.weight.copy_(T(kernel.T.copy()))
        lin.bias.copy_(T(bias))
        got = lin(tx)
    want = QuantDense(N, dtype=jdt).apply({"params": {"kernel": kernel, "bias": bias}}, jx)
    assert got.dtype == tdt and got.shape == (*lead, N)
    np.testing.assert_array_equal(_bits(got.float()), _bits(want.astype(jnp.float32)))


@pytest.mark.parametrize("M,K,N", [(256, 384, 256), (512, 3072, 768)])
def test_dense_product_tracks_the_pallas_kernel(M, K, N):
    x, kernel, bias = _operands(M + K, (M,), K, N)
    want = np.asarray(pallas_quant.quant_dense(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                                               interpret=True).astype(jnp.float32))
    wq, sw = quant_kernel.quantize_weight(T(kernel.T.copy()))
    got = quant_kernel.quant_dense(T(x), wq, sw, T(bias), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= PALLAS_REL_TOL, err


@pytest.mark.parametrize("K,N", [(768, 2304), (96, 64)])
def test_quantize_weight_equals_jax(K, N):
    _, kernel, _ = _operands(K * N, (3,), K, N)
    kernel[:, 0] = 0.0  # a zero column: scale 1e-8, all zeros
    jwq, jsw = pallas_quant.quantize_weight(jnp.asarray(kernel))
    wq, sw = quant_kernel.quantize_weight(T(kernel.T.copy()))
    assert wq.dtype == torch.int8 and sw.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(_bits(sw), _bits(np.asarray(jsw).reshape(-1)))


def test_plain_product_handles_ragged_chunks_and_no_bias(monkeypatch):
    monkeypatch.setattr(quant_kernel, "_PLAIN_ROWS", 7)
    x, kernel, _ = _operands(5, (30,), 32, 48)
    wq, sw = quant_kernel.quantize_weight(T(kernel.T.copy()))
    chunked = quant_kernel.reference_quant_dense(T(x), wq, sw)
    want = jax_dynamic_quant_matmul(jnp.asarray(x), jnp.asarray(kernel))
    np.testing.assert_array_equal(_bits(chunked), _bits(want))
    with pytest.raises(ValueError, match="wq"):
        quant_kernel.quant_dense(T(x), wq[:, :16], sw)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def case():
    """The tiny APF of ``tests/test_torch_apf.py`` on live bridged weights,
    quantized on both sides."""
    rng = np.random.default_rng(0)
    points = rng.standard_normal((6, N_POINTS, 3)).astype(np.float32)
    jmodel = JAPF(**CFG, quantized=True)
    variables = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)},
                                              jnp.asarray(points[:1])))
    for i in range(CFG["depth"]):
        ad = variables["params"][f"blocks_{i}"]["adapter"]
        ad["up_proj"]["kernel"] = 0.1 * rng.standard_normal(ad["up_proj"]["kernel"].shape).astype(np.float32)
        ad["scale"] = np.array([0.7 + i], np.float32)
    for tree in (variables["batch_stats"]["point_encoder"], variables["batch_stats"]["head"]):
        for stats in tree.values():
            stats["mean"] = 0.2 * rng.standard_normal(stats["mean"].shape).astype(np.float32)
            stats["var"] = (0.5 + rng.random(stats["var"].shape)).astype(np.float32)
    model = load_flax_variables(AdaptPointFormer(**CFG, quantized=True), variables).eval()
    return points, variables, model


def _jax_logits(variables, points, dtype=jnp.float32):
    jmodel = JAPF(**CFG, quantized=True, dtype=dtype)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(variables, jnp.asarray(points))
    return np.asarray(out.astype(jnp.float32))


def test_exactly_the_jax_layers_are_quantized_and_the_state_dict_is_unchanged(case):
    _, _, model = case
    assert {n for n, m in model.named_modules() if isinstance(m, QuantLinear)} == QUANTIZED_LAYERS
    plain = AdaptPointFormer(**CFG)
    assert not any(isinstance(m, QuantLinear) for m in plain.modules())
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    assert type(dense(False, 4, 8)) is torch.nn.Linear
    assert type(dense(True, 4, 8, bias=False)) is QuantLinear


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_quantized_inference_never_takes_the_fused_encoder_or_block(case, monkeypatch, implementation):
    points, _, model = case

    def refuse(*args, **kwargs):
        raise AssertionError("a quantized model took a fused path")

    for mod, names in ((pointnet, ("fused_group_encoder", "reference_folded_encoder")),
                       (vit, ("fused_apf_block", "reference_apf_block"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    m = AdaptPointFormer(**CFG, quantized=True, implementation=implementation)
    m.load_state_dict(model.state_dict())
    with torch.inference_mode():
        logits = m.eval()(T(points[:2]))
        assert torch.isfinite(logits).all()
        blk = APFBlock(64, 4, quantized=True, implementation=implementation).eval()
        assert blk(torch.randn(2, 16, 64)).shape == (2, 16, 64)


def test_weight_cache_follows_load_state_dict(case, monkeypatch):
    points, _, model = case
    x = T(points[:2])
    other = AdaptPointFormer(**CFG, quantized=True)
    with torch.no_grad():
        for p in other.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    m = AdaptPointFormer(**CFG, quantized=True)
    m.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want_other = other.eval()(x)
        first = m.eval()(x)
        calls = []
        real = quant_kernel.quantize_weight
        monkeypatch.setattr("pointvit_tpu_torch.nn.quant.quantize_weight",
                            lambda w: calls.append(1) or real(w))
        assert torch.equal(m(x), first) and not calls  # cached: no re-quantization
    m.load_state_dict(other.state_dict())
    with torch.inference_mode():
        assert torch.equal(m(x), want_other)
    assert len(calls) == len(QUANTIZED_LAYERS)


def test_quantized_logits_match_the_jax_model(case):
    points, variables, model = case
    want = _jax_logits(variables, points)
    with torch.inference_mode():
        got = model(T(points)).numpy()
    assert got.shape == (6, CFG["num_classes"]) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= QUANT_LOGIT_REL_TOL, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_quantized_model_tracks_jax_f32_as_jax_bf16_does(case):
    points, variables, model = case
    want = _jax_logits(variables, points)
    jax_bf16 = _jax_logits(variables, points, jnp.bfloat16)
    bf = AdaptPointFormer(**CFG, quantized=True, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    with torch.inference_mode():
        got = bf.eval()(T(points))
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    err = np.abs(got.float().numpy() - want).max() / scale
    jax_err = np.abs(jax_bf16 - want).max() / scale
    assert err <= 1.5 * jax_err, (err, jax_err)


def test_quantized_training_raises_and_the_factory_builds_it():
    model = AdaptPointFormer(**CFG, quantized=True)
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.zeros(2, N_POINTS, 3), train=True, generator=torch.Generator().manual_seed(0))
    built = build_model({**CFG, "quantized": True})
    assert built.quantized and isinstance(built.blocks[1].mlp.fc2, QuantLinear)
    cfg = apf_preset_config("slim2", quantized=True)
    assert cfg["quantized"] and cfg["encoder_second_width"] == 384 and cfg["dtype"] == torch.bfloat16
