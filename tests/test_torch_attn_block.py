"""Port parity: the fused attention sublayer (``fused_attention_block``), the
split-layout ``fused_mha`` and the plain attention at S = 1024, against the
JAX package's ``pointvit_tpu/ops/pallas_attention.py`` on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``_attn_block_pallas``,
``_mha_pallas``, ``_mha_qkv_pallas``, ``_mha_qkv_bwd_pallas``) and its
backwards as ``jax.vjp`` of the reference formulations; the port's wrappers
take their plain versions for CPU tensors. Tolerances, relative to the
largest reference value: 1e-5 in f32 (summation order only); 2^-6 in bf16
where both sides round at the same points; in a bf16 backward, where XLA
rounds every intermediate to bf16 and the port keeps the kernels' f32
statistics, the port must lie no further from JAX's f32 gradients than
JAX's own bf16 gradients do, times 1.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.ops.pallas_attention import (
    _attn_block_pallas,
    _mha_pallas,
    _mha_qkv_bwd_pallas,
    _mha_qkv_pallas,
    _reference_attn_block,
    reference_mha,
)
from pointvit_tpu_torch import _build
from pointvit_tpu_torch.nn.layers import Attention
from pointvit_tpu_torch.ops import attention_kernel

REL_TOL = 1e-5
BF16_REL_TOL = 2.0**-6
BF16_VS_F32_RATIO = 1.5
H = 2
T = torch.from_numpy


def _block_case(seed, B, S, D):
    """x (B, S, E) and the four weights in the JAX layouts, f32 numpy."""
    rng = np.random.default_rng(seed)
    E = H * D
    x = rng.standard_normal((B, S, E))
    wqkv = rng.standard_normal((E, 3 * E)) * E**-0.5
    bqkv = 0.2 * rng.standard_normal(3 * E)
    wproj = rng.standard_normal((E, E)) * E**-0.5
    bproj = 0.2 * rng.standard_normal(E)
    g = rng.standard_normal((B, S, E))
    return [t.astype(np.float32) for t in (x, wqkv, bqkv, wproj, bproj)], g.astype(np.float32)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    return t.detach().float().numpy()


def _port_grads(args, g, dtype, implementation=None):
    """The port's output and five gradients; x and g in ``dtype``, the
    weights in f32 (as ``nn.Linear`` keeps them)."""
    ts = [T(args[0]).to(dtype).requires_grad_()] + [T(a).requires_grad_() for a in args[1:]]
    out = attention_kernel.fused_attention_block(*ts, H, implementation=implementation)
    grads = torch.autograd.grad(out, ts, T(g).to(dtype))
    return out, grads


@jax.jit
def _vjp(g, *args):
    return jax.vjp(lambda *a: _reference_attn_block(*a, num_heads=H), *args)[1](g)


def _jax_vjp(args, g, dtype):
    """jax.vjp of ``_reference_attn_block`` with x and g in ``dtype``."""
    jargs = [jnp.asarray(args[0], dtype)] + [jnp.asarray(a) for a in args[1:]]
    return _vjp(jnp.asarray(g, dtype), *jargs)


@pytest.mark.parametrize("S", [16, 37])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_forward_matches_the_pallas_kernel(S, dtype):
    args, _ = _block_case(S, 2, S, 16)
    if dtype == "f32":
        with jax.default_matmul_precision("highest"):
            want = _attn_block_pallas(*map(jnp.asarray, args), H, interpret=True)
        got = attention_kernel.fused_attention_block(*map(T, args), H)
        assert got.dtype == torch.float32
        assert _rel_max(_np(got), want) <= REL_TOL
    else:
        want = _attn_block_pallas(jnp.asarray(args[0], jnp.bfloat16), *map(jnp.asarray, args[1:]),
                                  H, interpret=True)
        got = attention_kernel.fused_attention_block(T(args[0]).bfloat16(), *map(T, args[1:]), H)
        assert got.dtype == torch.bfloat16
        assert _rel_max(_np(got), want.astype(jnp.float32)) <= BF16_REL_TOL


@pytest.mark.parametrize("S", [16, 37])
def test_block_backward_matches_jax_vjp_in_f32(S):
    args, g = _block_case(100 + S, 2, S, 8)
    with jax.default_matmul_precision("highest"):
        want = _jax_vjp(args, g, jnp.float32)
    _, got = _port_grads(args, g, torch.float32)
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel_max(_np(a), b) <= REL_TOL, name


@pytest.mark.parametrize("S", [16, 37])
def test_block_backward_in_bf16_tracks_f32_as_jax_does(S):
    args, g = _block_case(200 + S, 2, S, 16)
    # The f32 reference sees the bf16 x and g that both bf16 runs see.
    x16 = np.asarray(jnp.asarray(args[0], jnp.bfloat16).astype(jnp.float32))
    g16 = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    with jax.default_matmul_precision("highest"):
        ref = _jax_vjp([x16] + args[1:], g16, jnp.float32)
    jax_bf16 = _jax_vjp(args, g, jnp.bfloat16)
    _, got = _port_grads(args, g, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, a, b, r in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, jax_bf16, ref):
        port_err, jax_err = _rel_l2(_np(a), r), _rel_l2(np.asarray(b, np.float32), r)
        assert port_err <= BF16_VS_F32_RATIO * jax_err, (name, port_err, jax_err)


def test_block_function_backward_is_the_exact_gradient_in_f64():
    """In f64 the Function's backward (the products, the plain attention
    backward with its rounding points, which are no-ops in f64) equals torch
    autograd through the plain forward."""
    args, g = _block_case(8, 2, 12, 8)
    ts = [T(a).double().requires_grad_() for a in args]
    got = torch.autograd.grad(attention_kernel.fused_attention_block(*ts, H), ts, T(g).double())
    us = [t.detach().clone().requires_grad_() for t in ts]
    want = torch.autograd.grad(attention_kernel.reference_attn_block(*us, H), us, T(g).double())
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_block_function_saves_x_weights_and_o_and_counts_no_cpu_launch(implementation):
    args, g = _block_case(9, 2, 16, 8)
    ts = [T(a).requires_grad_() for a in args]
    _build.reset_launch_counts()
    out = attention_kernel.fused_attention_block(*ts, H, implementation=implementation)
    saved = out.grad_fn.saved_tensors
    want, o = attention_kernel.attn_block(*map(T, args), H)
    assert [t.data_ptr() for t in saved[:5]] == [t.data_ptr() for t in ts]
    torch.testing.assert_close(saved[5], o, rtol=0, atol=0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    out.backward(T(g))
    counts = _build.launch_counts()
    assert counts["attn_block"] == 0 and counts["mha_qkv_bwd"] == 0 and counts["gemm"] == 0


def test_block_weights_of_an_attention_module():
    """``attention_block_weights`` gives a port ``Attention`` module's
    parameters in the JAX layouts: the sublayer equals the module's forward,
    and gradients reach its parameters."""
    torch.manual_seed(0)
    attn = Attention(32, H)
    x = torch.randn(2, 16, 32)
    out = attention_kernel.fused_attention_block(x, *attention_kernel.attention_block_weights(attn), H)
    torch.testing.assert_close(out, attn(x), rtol=1e-5, atol=1e-5)
    out.sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in attn.parameters())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_mha_forward_matches_the_pallas_kernel(dtype):
    rng = np.random.default_rng(30)
    q, k, v = (2.0 * rng.standard_normal((3, 2, 20, H, 16))).astype(np.float32)
    if dtype == "f32":
        with jax.default_matmul_precision("highest"):
            want = _mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
        got = attention_kernel.fused_mha(T(q), T(k), T(v))
        assert got.dtype == torch.float32 and _rel_max(_np(got), want) <= REL_TOL
    else:
        want = _mha_pallas(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), interpret=True)
        got = attention_kernel.fused_mha(*(T(t).bfloat16() for t in (q, k, v)))
        assert got.dtype == torch.bfloat16
        assert _rel_max(_np(got), want.astype(jnp.float32)) <= BF16_REL_TOL


def test_fused_mha_vjp_matches_jax():
    rng = np.random.default_rng(31)
    q, k, v, g = rng.standard_normal((4, 2, 20, H, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(reference_mha, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
    ts = [T(t).requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attention_kernel.fused_mha(*ts), ts, T(g))
    for a, b in zip(got, want):
        assert _rel_max(_np(a), b) <= REL_TOL


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plain_attention_at_s_1024_matches_the_pallas_kernels(direction):
    """The plain versions that the key-tiled kernels are held to on the card,
    at the JAX gate's longest sequence (one head of 8)."""
    rng = np.random.default_rng(1024)
    qkv = (2.0 * rng.standard_normal((1, 1024, 24))).astype(np.float32)
    g = rng.standard_normal((1, 1024, 8)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        if direction == "forward":
            want = _mha_qkv_pallas(jnp.asarray(qkv), 1, interpret=True)
            got = attention_kernel.reference_mha_qkv(T(qkv), 1)
        else:
            want = _mha_qkv_bwd_pallas(jnp.asarray(qkv), jnp.asarray(g), 1, interpret=True)
            got = attention_kernel.reference_mha_qkv_bwd(T(qkv), T(g), 1)
    assert _rel_max(_np(got), want) <= REL_TOL


def _refusals():
    x, w = torch.zeros(1, 4, 32), [torch.zeros(32, 96), torch.zeros(96), torch.zeros(32, 32),
                                   torch.zeros(32)]
    q = torch.zeros(1, 4, 2, 8)
    return {
        "heads": (lambda: attention_kernel.fused_attention_block(x, *w, 3), "multiple of num_heads"),
        "wqkv": (lambda: attention_kernel.fused_attention_block(x, w[0].t(), *w[1:], 2), "wqkv"),
        "bproj": (lambda: attention_kernel.fused_attention_block(x, *w[:3], torch.zeros(31), 2),
                  "bproj"),
        "implementation": (lambda: attention_kernel.fused_attention_block(x, *w, 2, "xla"),
                           "implementation"),
        "mha_shapes": (lambda: attention_kernel.fused_mha(q, q, torch.zeros(1, 5, 2, 8)), "alike"),
        "mha_implementation": (lambda: attention_kernel.fused_mha(q, q, q, "xla"), "implementation"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrappers_refuse_bad_shapes_and_implementations(case):
    fn, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        fn()
