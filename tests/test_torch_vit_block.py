"""Port parity: the Pix4Point ViT block of ``pointvit_tpu_torch`` against
the JAX package, on the CPU.

In f32 the port's plain version (which the wrappers take for CPU tensors)
and its kernel launch chain (each call on its plain version here) must match
the JAX Pallas kernel in interpret mode and the unfused JAX module to 1e-5
relative to the largest output, with the positional embedding per cloud,
shared, or absent. In bf16 both sides round at the same points, so they
agree to a few bf16 steps (2^-6 of the largest output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.nn.vit import ViTBlock as JBlock
from pointvit_tpu.ops import pallas_block
from pointvit_tpu_torch.convert import load_flax_variables
from pointvit_tpu_torch.nn.vit import ViTBlock
from pointvit_tpu_torch.ops import block_kernel, vit_block_kernel

REL_TOL = 1e-5
BF16_REL_TOL = 2.0**-6
B, S, E, HEADS = 2, 33, 128, 2  # 32 tokens + cls, two heads of 64


def _assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


def _case(seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, E)).astype(np.float32)
    pos = {
        "per_cloud": 0.5 * rng.standard_normal((batch, seq, E)).astype(np.float32),
        "shared": 0.5 * rng.standard_normal((1, seq, E)).astype(np.float32),
        "none": None,
    }
    variables = jax.tree.map(lambda a: np.array(a, np.float32),
                             jax.jit(JBlock(HEADS).init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    p = variables["params"]
    for ln in (p["norm1"], p["norm2"]):  # live LN affines (the init is 1 and 0)
        ln["scale"] = (1 + 0.2 * rng.standard_normal(E)).astype(np.float32)
        ln["bias"] = (0.1 * rng.standard_normal(E)).astype(np.float32)
    blk = load_flax_variables(ViTBlock(E, HEADS), variables).eval()
    return x, pos, variables, blk


def test_weights_and_gate_match_jax(monkeypatch):
    _, _, variables, blk = _case(0)
    want = pallas_block.vit_block_weights(variables["params"])
    got = vit_block_kernel.vit_block_weights(blk, torch.float32)
    for g, w in zip(got, want):  # the port keeps nn.Linear's (out, in) layout
        np.testing.assert_array_equal((g.t() if g.dim() == 2 else g).numpy(), np.asarray(w))
    # The chain's gate is the attention kernels' limit (1024 at head dim 64
    # on the card), which lies inside the JAX gate: the port fuses no shape
    # JAX would not.
    monkeypatch.setattr(vit_block_kernel, "attention_max_seq", lambda d: 1024 if d == 64 else 0)
    for shape, ok in [((513, 384, 6), True), ((197, 768, 12), True), ((577, 384, 6), True),
                      ((1024, 384, 6), True), ((1025, 384, 6), False), ((10, 32, 3), False),
                      ((10, 36, 9), False), ((1040, 768, 12), False), ((33, 128, 4), False)]:
        assert vit_block_kernel.vit_block_shapes_ok(*shape) == ok, shape
        assert not ok or pallas_block.fused_block_shapes_ok(*shape), shape


@pytest.mark.parametrize("pos_kind", ["per_cloud", "shared", "none"])
@pytest.mark.parametrize("path", ["plain", "chain", "module"])
def test_block_matches_jax_kernel_and_xla_module(path, pos_kind):
    x, poses, variables, blk = _case(1)
    pos = poses[pos_kind]
    jpos = None if pos is None else jnp.asarray(pos)
    with jax.default_matmul_precision("highest"):
        jw = pallas_block.vit_block_weights(variables["params"])
        want_kernel = pallas_block.fused_vit_block(jnp.asarray(x), jw, HEADS, jpos, True)
        want_xla = jax.jit(lambda v, t, q: JBlock(HEADS, implementation="xla").apply(v, t, pos=q))(
            variables, jnp.asarray(x), jpos)
    w = vit_block_kernel.vit_block_weights(blk, torch.float32)
    xt, pt = torch.from_numpy(x), None if pos is None else torch.from_numpy(pos)
    got = {
        "plain": lambda: vit_block_kernel.fused_vit_block(xt, w, HEADS, pt),
        "chain": lambda: vit_block_kernel.launch_chain(xt, w, HEADS, pt),
        "module": lambda: blk(xt, pos=pt),
    }[path]()
    _assert_rel(got.detach(), want_kernel)
    _assert_rel(got.detach(), want_xla)


def test_block_at_the_pix4point_sequence_length():
    """S = 513 (512 tokens + cls), one cloud: the JAX kernel's head-chunked
    geometry (pallas_block.py:104-115 of the tests)."""
    x, poses, variables, blk = _case(2, batch=1, seq=513)
    with jax.default_matmul_precision("highest"):
        jw = pallas_block.vit_block_weights(variables["params"])
        want = pallas_block.fused_vit_block(jnp.asarray(x), jw, HEADS, jnp.asarray(poses["per_cloud"]),
                                            True)
    w = vit_block_kernel.vit_block_weights(blk, torch.float32)
    got = vit_block_kernel.launch_chain(torch.from_numpy(x), w, HEADS,
                                        torch.from_numpy(poses["per_cloud"]))
    _assert_rel(got, want)


@pytest.mark.parametrize("pos_kind", ["per_cloud", "shared"])
def test_block_bf16_rounds_like_the_pallas_kernel(pos_kind):
    x, poses, variables, blk = _case(3)
    pos = poses[pos_kind]
    jw = pallas_block.vit_block_weights(variables["params"])
    want = pallas_block.fused_vit_block(jnp.asarray(x, jnp.bfloat16), jw, HEADS,
                                        jnp.asarray(pos, jnp.bfloat16), True)
    w = vit_block_kernel.vit_block_weights(blk, torch.bfloat16)
    xb, pb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos).to(torch.bfloat16)
    got = vit_block_kernel.reference_vit_block(xb, w, HEADS, pb)
    assert got.dtype == torch.bfloat16
    _assert_rel(got.float(), np.asarray(want.astype(jnp.float32)), BF16_REL_TOL)
    _assert_rel(vit_block_kernel.launch_chain(xb, w, HEADS, pb).float(), got.float(), BF16_REL_TOL)


def test_pos_layer_norm_plain_version():
    """xp = x + pos in the compute dtype (one rounding of the exact sum, as
    the Pallas kernel's bf16 add), LN of xp with f32 statistics."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, E)) * 3 + 1).astype(np.float32)
    pos = rng.standard_normal((3, E)).astype(np.float32)  # shared by two clouds of 3 rows
    g, b = rng.standard_normal(E).astype(np.float32), rng.standard_normal(E).astype(np.float32)
    xb, pb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos).to(torch.bfloat16)
    xp, y = block_kernel.pos_layer_norm(xb, pb, torch.from_numpy(g), torch.from_numpy(b))
    want_xp = (jnp.asarray(x, jnp.bfloat16).reshape(2, 3, E) + jnp.asarray(pos, jnp.bfloat16)).reshape(6, E)
    np.testing.assert_array_equal(xp.float().numpy(), np.asarray(want_xp.astype(jnp.float32)))
    want_y = pallas_block._ln(want_xp.astype(jnp.float32), jnp.asarray(g), jnp.asarray(b))
    _assert_rel(y.float(), want_y, BF16_REL_TOL)
    with pytest.raises(ValueError, match="tile"):
        block_kernel.pos_layer_norm(xb, pb.repeat(2, 1)[:4], torch.from_numpy(g), torch.from_numpy(b))


def test_block_refuses_training_and_other_mlp_ratios(monkeypatch):
    """Training is ported (ROADMAP A8): ``train=True`` takes the unfused
    forward inside the blocks' gate too, as the JAX block leaves its fused
    kernels for a stochastic call (at dropout 0 the same function as the
    fused chain); an MLP ratio other than 4 is refused."""
    from pointvit_tpu_torch.nn import vit

    x, poses, _, blk = _case(6)
    taken = []
    unfused = vit.ViTBlock.forward_unfused
    monkeypatch.setattr(vit.ViTBlock, "forward_unfused",
                        lambda self, x, **kw: taken.append(kw["train"]) or unfused(self, x, **kw))
    pos = torch.from_numpy(poses["per_cloud"])
    with torch.no_grad():
        got = blk(torch.from_numpy(x), pos=pos, train=True)
        want = blk(torch.from_numpy(x), pos=pos)
    assert taken == [True]
    _assert_rel(got, want)
    with pytest.raises(ValueError, match="4·dim"):
        ViTBlock(E, HEADS, mlp_ratio=2.0)


def test_block_above_the_gate_runs_unfused_and_matches_the_jax_block(monkeypatch):
    """S = 1040, past the blocks' gate (S ≤ 1024 at head dim 64): the block
    takes its unfused forward, as the JAX block leaves its fused kernels
    there, and matches the JAX block's non-fused forward."""
    from pointvit_tpu_torch.nn import vit

    x, poses, variables, blk = _case(5, batch=1, seq=1040)
    pos = poses["shared"]
    taken = []
    unfused = vit.ViTBlock.forward_unfused
    monkeypatch.setattr(vit.ViTBlock, "forward_unfused",
                        lambda self, x, **kw: taken.append(x.shape[1]) or unfused(self, x, **kw))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, t, q: JBlock(HEADS).apply(v, t, pos=q))(variables, jnp.asarray(x),
                                                                          jnp.asarray(pos))
    with torch.inference_mode():
        got = blk(torch.from_numpy(x), pos=torch.from_numpy(pos))
    assert taken == [1040]
    _assert_rel(got, want, 1e-4)
