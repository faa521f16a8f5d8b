"""Port parity: packed-qkv attention forward and backward of
``pointvit_tpu_torch`` against the JAX package's Pallas kernels, on the CPU.

The JAX side runs ``_mha_qkv_pallas`` and ``_mha_qkv_bwd_pallas`` in
interpret mode; the port's wrappers take their plain versions for CPU
tensors. In f32 the two differ only in summation order (≤ 1e-5 of the
largest output); in bf16 both round at the same points, so they agree to a
few bf16 steps (≤ 2^-6 of the largest output). Above the JAX package's
Pallas gate its backward is ``jax.vjp`` of ``_reference_mha_qkv``, which the
port's plain backward is held to there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.ops.pallas_attention import (
    _bwd_pallas_ok,
    _mha_qkv_bwd_pallas,
    _mha_qkv_pallas,
    _reference_mha_qkv,
)
from pointvit_tpu_torch import _build
from pointvit_tpu_torch.ops import attention_kernel

REL_TOL = 1e-5
BF16_REL_TOL = 2.0**-6
H, D = 2, 16
T = torch.from_numpy


def _case(seed, B, S):
    rng = np.random.default_rng(seed)
    qkv = (2.0 * rng.standard_normal((B, S, 3 * H * D))).astype(np.float32)
    g = rng.standard_normal((B, S, H * D)).astype(np.float32)
    return qkv, g


def _assert_rel(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("S", [16, 20])
def test_forward_matches_pallas_interpret(S):
    qkv, _ = _case(S, 3, S)
    with jax.default_matmul_precision("highest"):
        want = _mha_qkv_pallas(jnp.asarray(qkv), H, interpret=True)
    got = attention_kernel.fused_mha_qkv(T(qkv), H)
    assert got.dtype == torch.float32
    _assert_rel(got, want, REL_TOL)
    torch.testing.assert_close(attention_kernel.mha_qkv(T(qkv), H), got, rtol=0, atol=0)


def test_backward_above_the_pallas_gate_matches_the_recompute_vjp():
    """S = 1040 at 12 heads of 64 is past ``_bwd_pallas_ok``, where JAX runs
    the recompute VJP of ``_reference_mha_qkv`` (one head here: the plain
    backward works head by head). f32, so the two differ in summation order
    only: 1e-5 of the largest output."""
    B, S, heads, Dh = 1, 1040, 1, 64
    assert not _bwd_pallas_ok(S, 12, Dh)
    rng = np.random.default_rng(1040)
    qkv = (2.0 * rng.standard_normal((B, S, 3 * heads * Dh))).astype(np.float32)
    g = rng.standard_normal((B, S, heads * Dh)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda t: _reference_mha_qkv(t, heads), jnp.asarray(qkv))
        (want,) = vjp(jnp.asarray(g))
    got = attention_kernel.mha_qkv_bwd(T(qkv), T(g), heads)
    assert got.dtype == torch.float32
    E = heads * Dh
    for i in range(3):  # dq, dk, dv each against its own scale
        _assert_rel(got[..., i * E:(i + 1) * E], np.asarray(want)[..., i * E:(i + 1) * E], REL_TOL)


@pytest.mark.parametrize("S", [16, 20])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_backward_matches_pallas_interpret(S, dtype):
    qkv, g = _case(100 + S, 2, S)
    if dtype == "f32":
        with jax.default_matmul_precision("highest"):
            want = _mha_qkv_bwd_pallas(jnp.asarray(qkv), jnp.asarray(g), H, interpret=True)
        got = attention_kernel.reference_mha_qkv_bwd(T(qkv), T(g), H)
        assert got.dtype == torch.float32
        _assert_rel(got, want, REL_TOL)
    else:
        want = _mha_qkv_bwd_pallas(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), H,
                                   interpret=True)
        got = attention_kernel.reference_mha_qkv_bwd(T(qkv).bfloat16(), T(g).bfloat16(), H)
        assert got.dtype == torch.bfloat16
        _assert_rel(got.float(), np.asarray(want.astype(jnp.float32)), BF16_REL_TOL)
    torch.testing.assert_close(attention_kernel.mha_qkv_bwd(T(qkv), T(g), H),
                               attention_kernel.reference_mha_qkv_bwd(T(qkv), T(g), H),
                               rtol=0, atol=0)


@pytest.mark.parametrize("D", [8, 16, 32, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_other_head_dims_match_pallas_interpret_forward_and_backward(D, dtype):
    """The head dims that csrc/attention_any.cu serves on the card (the
    benchmarks' small configs run D = 8 and 16): the port's plain forward
    and backward, which that kernel pair is held to, against
    ``_mha_qkv_pallas`` and ``_mha_qkv_bwd_pallas`` in interpret mode. f32
    at the highest precision: within 1e-5 of max|ref|. bf16: both round P,
    dS and every output at the same points, so within one bf16 step (2^-7
    of max|ref|)."""
    heads, B, S = 2, 2, 37
    rng = np.random.default_rng(1000 + D)
    qkv = (2.0 * rng.standard_normal((B, S, 3 * heads * D))).astype(np.float32)
    g = rng.standard_normal((B, S, heads * D)).astype(np.float32)
    if dtype == "f32":
        with jax.default_matmul_precision("highest"):
            want = _mha_qkv_pallas(jnp.asarray(qkv), heads, interpret=True)
            want_b = _mha_qkv_bwd_pallas(jnp.asarray(qkv), jnp.asarray(g), heads, interpret=True)
        x, gt, tol = T(qkv), T(g), REL_TOL
    else:
        jq, jg = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
        want = _mha_qkv_pallas(jq, heads, interpret=True).astype(jnp.float32)
        want_b = _mha_qkv_bwd_pallas(jq, jg, heads, interpret=True).astype(jnp.float32)
        x, gt, tol = T(qkv).bfloat16(), T(g).bfloat16(), 2.0**-7
    got = attention_kernel.mha_qkv(x, heads)
    got_b = attention_kernel.mha_qkv_bwd(x, gt, heads)
    assert got.dtype == got_b.dtype == x.dtype
    _assert_rel(got.float(), np.asarray(want), tol)
    E = heads * D
    for i in range(3):  # dq, dk, dv each against its own scale
        _assert_rel(got_b[..., i * E:(i + 1) * E].float(), np.asarray(want_b)[..., i * E:(i + 1) * E], tol)


def test_backward_casts_g_to_the_compute_dtype():
    """g arrives in f32 from an f32 loss; like pallas_attention.py:427 the
    backward rounds it to qkv's dtype first."""
    qkv, g = _case(7, 2, 16)
    qb = T(qkv).bfloat16()
    got = attention_kernel.reference_mha_qkv_bwd(qb, T(g), H)
    want = attention_kernel.reference_mha_qkv_bwd(qb, T(g).bfloat16(), H)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_autograd_function_backward_is_the_exact_gradient_in_f64():
    """In f64 the Function's CPU backward (the plain backward with its
    rounding points, which are no-ops in f64) equals torch autograd through
    the plain forward."""
    qkv, g = _case(8, 2, 12)
    x = T(qkv).double().requires_grad_()
    out = attention_kernel.fused_mha_qkv(x, H)
    (got,) = torch.autograd.grad(out, x, T(g).double())
    y = x.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(attention_kernel.reference_mha_qkv(y, H), y, T(g).double())
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("implementation", [None, "torch"])
def test_function_saves_qkv_only_and_counts_no_cpu_launch(implementation):
    qkv, g = _case(9, 2, 16)
    x = T(qkv).requires_grad_()
    _build.reset_launch_counts()
    out = attention_kernel.fused_mha_qkv(x, H, implementation)
    assert [t.data_ptr() for t in out.grad_fn.saved_tensors] == [x.data_ptr()]
    out.backward(T(g))
    _assert_rel(x.grad, attention_kernel.reference_mha_qkv_bwd(T(qkv), T(g), H), 0.0)
    counts = _build.launch_counts()
    assert counts["mha_qkv"] == 0 and counts["mha_qkv_bwd"] == 0


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="heads"):
        attention_kernel.fused_mha_qkv(torch.zeros(1, 4, 30), 4)
    with pytest.raises(ValueError, match="g must be"):
        attention_kernel.mha_qkv_bwd(torch.zeros(1, 4, 96), torch.zeros(1, 5, 32), 2)
    with pytest.raises(ValueError, match="implementation"):
        attention_kernel.fused_mha_qkv(torch.zeros(1, 4, 96), 2, "xla")
