"""Port parity: the renderer's serial-adapter ViT block of
``pointvit_tpu_torch`` against the JAX package, on the CPU.

In f32 the port's plain version (which the wrappers take for CPU tensors),
its kernel launch chain (each call on its plain version here) and the block
module must match the JAX Pallas kernel in interpret mode to 1e-5 relative
to the largest output, and the module the unfused JAX module (``xla``) too.
In bf16 the port rounds where the Pallas kernel rounds (y and m stay f32 in
the residual), so the two agree to a few bf16 steps (2^-6 of the largest
output). Small sizes: E=128, two heads of 64, adapter bottleneck 16, S=33
and 197 (the renderer's 196 patches + cls), with random adapter up
projections (their init is zero, which would hide the adapters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.nn.layers import SimpleAdapter as JAdapter
from pointvit_tpu.nn.vit import SerialAdapterBlock as JBlock
from pointvit_tpu.ops import pallas_block
from pointvit_tpu_torch.convert import load_flax_variables
from pointvit_tpu_torch.nn.layers import SimpleAdapter
from pointvit_tpu_torch.nn.vit import SerialAdapterBlock
from pointvit_tpu_torch.ops import serial_block_kernel
from pointvit_tpu_torch.ops.gemm_kernel import gemm, reference_gemm

REL_TOL = 1e-5
BF16_REL_TOL = 2.0**-6
B, E, HEADS, BOTTLENECK = 2, 128, 2, 16


def _assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


def _case(seed, seq):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, seq, E)).astype(np.float32)
    variables = jax.tree.map(lambda a: np.array(a, np.float32), jax.jit(
        JBlock(HEADS, adapter_bottleneck=BOTTLENECK).init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    p = variables["params"]
    for ln in (p["ln_1"], p["ln_2"]):  # live LN affines (the init is 1 and 0)
        ln["scale"] = (1 + 0.2 * rng.standard_normal(E)).astype(np.float32)
        ln["bias"] = (0.1 * rng.standard_normal(E)).astype(np.float32)
    for ad in (p["adapter1"], p["adapter2"]):  # live adapters (down ~1e-3, up 0 at init)
        for name, fan_in in (("down_proj", E), ("up_proj", BOTTLENECK)):
            k = ad[name]["kernel"]
            ad[name]["kernel"] = (rng.standard_normal(k.shape) * fan_in**-0.5).astype(np.float32)
            ad[name]["bias"] = (0.1 * rng.standard_normal(k.shape[1])).astype(np.float32)
    blk = load_flax_variables(SerialAdapterBlock(E, HEADS, BOTTLENECK), variables).eval()
    return x, variables, blk


def test_weights_match_jax():
    _, variables, blk = _case(0, 33)
    want = pallas_block.serial_block_weights(variables["params"])
    got = serial_block_kernel.serial_block_weights(blk, torch.float32)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):  # the port keeps nn.Linear's (out, in) layout
        np.testing.assert_array_equal((g.t() if g.dim() == 2 else g).numpy(), np.asarray(w))
    assert all(t.dtype == torch.bfloat16 for t in serial_block_kernel.serial_block_weights(
        blk, torch.bfloat16))


@pytest.mark.parametrize("seq", [33, 197])
@pytest.mark.parametrize("path", ["plain", "chain", "module"])
def test_block_matches_the_pallas_kernel(path, seq):
    x, variables, blk = _case(1, seq)
    with jax.default_matmul_precision("highest"):
        jw = pallas_block.serial_block_weights(variables["params"])
        want = pallas_block.fused_serial_block(jnp.asarray(x), jw, HEADS, True)
    w = serial_block_kernel.serial_block_weights(blk, torch.float32)
    xt = torch.from_numpy(x)
    got = {
        "plain": lambda: serial_block_kernel.fused_serial_block(xt, w, HEADS),
        "chain": lambda: serial_block_kernel.launch_chain(xt, w, HEADS),
        "module": lambda: blk(xt),
    }[path]()
    _assert_rel(got.detach(), want)


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_block_module_matches_the_jax_module(implementation):
    x, variables, blk = _case(2, 33)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, t: JBlock(HEADS, adapter_bottleneck=BOTTLENECK,
                                           implementation="xla").apply(v, t))(variables, jnp.asarray(x))
    mod = SerialAdapterBlock(E, HEADS, BOTTLENECK, implementation=implementation)
    mod.load_state_dict(blk.state_dict())
    with torch.inference_mode():
        _assert_rel(mod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("seq", [33, 197])
def test_block_bf16_rounds_like_the_pallas_kernel(seq):
    x, variables, blk = _case(3, seq)
    jw = pallas_block.serial_block_weights(variables["params"])
    want = pallas_block.fused_serial_block(jnp.asarray(x, jnp.bfloat16), jw, HEADS, True)
    w = serial_block_kernel.serial_block_weights(blk, torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = serial_block_kernel.reference_serial_block(xb, w, HEADS)
    assert got.dtype == torch.bfloat16
    _assert_rel(got.float(), np.asarray(want.astype(jnp.float32)), BF16_REL_TOL)
    chain = serial_block_kernel.launch_chain(xb, w, HEADS)
    assert chain.dtype == torch.bfloat16
    _assert_rel(chain.float(), got.float(), BF16_REL_TOL)


def test_simple_adapter_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, E)).astype(np.float32)
    jmod = JAdapter(BOTTLENECK)
    variables = jax.tree.map(lambda a: np.array(a, np.float32), jmod.init(jax.random.PRNGKey(4), x))
    mod = load_flax_variables(SimpleAdapter(E, BOTTLENECK), variables)
    assert not mod.up_proj.weight.any() and not mod.up_proj.bias.any()  # starts as the identity
    up = variables["params"]["up_proj"]
    up["kernel"] = rng.standard_normal(up["kernel"].shape).astype(np.float32)
    up["bias"] = rng.standard_normal(E).astype(np.float32)
    load_flax_variables(mod, variables)
    with jax.default_matmul_precision("highest"):
        want = jmod.apply(variables, jnp.asarray(x))
    _assert_rel(mod(torch.from_numpy(x)).detach(), want)


def test_gate_and_what_the_block_refuses(monkeypatch):
    # The chain's gate is the attention kernel's limit (576 at head dim 64 on
    # the card), which lies inside the JAX gate: the port fuses no shape JAX
    # would not. Every torchvision preset of the renderer passes.
    monkeypatch.setattr(serial_block_kernel, "attention_max_seq", lambda d: 576 if d == 64 else 0)
    for shape, ok in [((197, 768, 12), True), ((50, 768, 12), True), ((197, 1024, 16), True),
                      ((50, 1024, 16), True), ((576, 768, 12), True), ((577, 768, 12), False),
                      ((197, 768, 6), False), ((197, 768, 7), False), ((0, 768, 12), False)]:
        assert serial_block_kernel.serial_block_shapes_ok(*shape) == ok, shape
        assert not ok or pallas_block.fused_block_shapes_ok(*shape), shape
    blk = SerialAdapterBlock(E, HEADS, BOTTLENECK)
    x = torch.randn(1, 33, E, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # training takes the unfused forward; no draws at dropout 0
        assert torch.equal(blk(x, train=True), blk.forward_unfused(x))
    with pytest.raises(ValueError, match="4·dim"):
        SerialAdapterBlock(E, HEADS, mlp_ratio=2.0)
    with pytest.raises(ValueError, match="implementation"):
        SerialAdapterBlock(E, HEADS, implementation="xla")
    with pytest.raises(ValueError, match="multiple"):
        serial_block_kernel.fused_serial_block(torch.zeros(1, 33, E), (), 3)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_writes_the_branch_before_its_residual(out_dtype):
    """``pre_out`` holds a @ w.T + bias rounded once to its dtype; ``out``
    adds the residual to the same f32 value (one rounding, as the kernel)."""
    rng = np.random.default_rng(5)
    a, w, bias, res = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                       for s in ((40, 24), (16, 24), (16,), (40, 16)))
    res = res.float()
    pre = torch.empty(40, 16, dtype=torch.bfloat16)
    out, gmax = gemm(a, w, bias, res=res, out_dtype=out_dtype, pre_out=pre)
    branch = a.float() @ w.float().t() + bias.float()
    assert gmax is None and out.dtype == out_dtype
    assert torch.equal(pre, branch.to(torch.bfloat16))
    _assert_rel(out.float(), (branch.double() + res.double()).to(out_dtype).float(), 2.0**-8)
    want, _ = reference_gemm(a, w, bias, res=res, out_dtype=out_dtype)
    assert torch.equal(out, want)  # asking for pre_out changes nothing else
    with pytest.raises(ValueError, match="pre_out"):
        gemm(a, w, bias, out_dtype=None, group=8, pre_out=pre)


def test_block_above_the_gate_runs_unfused_and_matches_the_jax_block(monkeypatch):
    """S = 1040, past the blocks' gate (S ≤ 1024 at head dim 64): the block
    takes its unfused forward, as the JAX block leaves its fused kernels
    there, and matches the JAX block's non-fused forward."""
    from pointvit_tpu_torch.nn import vit

    x, variables, blk = _case(6, 1040)
    x = x[:1]
    taken = []
    unfused = vit.SerialAdapterBlock.forward_unfused
    monkeypatch.setattr(vit.SerialAdapterBlock, "forward_unfused",
                        lambda self, x, **kw: taken.append(x.shape[1]) or unfused(self, x, **kw))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(JBlock(HEADS, adapter_bottleneck=BOTTLENECK).apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = blk(torch.from_numpy(x))
    assert taken == [1040]
    _assert_rel(got, want, 1e-4)
