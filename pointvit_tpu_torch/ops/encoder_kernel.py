"""Folded APF group encoder: BN folding, the fused kernel chain and its plain
version.

Counterpart of the APF part of ``pointvit_tpu/ops/pallas_encoder.py``. At
inference each BatchNorm is an affine map and folds into the product before
it (f32, eps 1e-5)::

    relu(BN(x @ W + b)) = relu(x @ (W·s) + (b·s + t)),  s = γ/√(σ²+ε), t = β − μ·s

and the encoder becomes five products (``_enc_kernel``)::

    h   = relu(x @ W0' + c0);  h = relu(h @ W1' + c1)
    loc = h @ W2 + b2;         g = max_K loc
    h2  = relu(loc @ Wl' + (g @ Wg' + c2))
    out = max_K(h2 @ W3 + b3)

On the card this is a chain of six launches of the fused-epilogue GEMM
(``csrc/gemm.cu``); the final (M·K, E) product is reduced over K in its
epilogue and never reaches device memory. As in ``_encoder_pallas``
(``pallas_encoder.py:100-101``), every folded weight *and bias* is rounded
to the compute dtype, products accumulate in f32, and h, loc and h2 are
rounded to the compute dtype; g·Wg'+c2 stays f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import LaunchCounter
from pointvit_tpu_torch.ops.gemm_kernel import gemm

__all__ = [
    "bn_affine",
    "fold_encoder_params",
    "fused_group_encoder",
    "launch_chain",
    "reference_folded_encoder",
    "launches",
]

launches = LaunchCounter("group_encoder")

BN_EPS = 1e-5


def bn_affine(bn: torch.nn.BatchNorm1d):
    """An inference BatchNorm as the f32 affine map x·s + t."""
    s = bn.weight.detach().float() / torch.sqrt(bn.running_var.float() + BN_EPS)
    return s, bn.bias.detach().float() - bn.running_mean.float() * s


def fold_encoder_params(enc) -> tuple[torch.Tensor, ...]:
    """Fold the three BatchNorms of a ``GroupFeatureEncoder`` into its
    products. Returns the 11 f32 arrays of ``pallas_encoder.py:172-195`` in
    the JAX layout: matrices are (in, out)."""
    s0, t0 = bn_affine(enc.first_bn0)
    s1, t1 = bn_affine(enc.first_bn1)
    s2, t2 = bn_affine(enc.second_bn0)
    k = lambda lin: lin.weight.detach().float().t()
    b = lambda lin: lin.bias.detach().float()
    w0 = k(enc.first_0) * s0
    c0 = b(enc.first_0) * s0 + t0
    w1 = k(enc.first_1) * s1
    c1 = b(enc.first_1) * s1 + t1
    w2 = k(enc.first_2)
    b2 = b(enc.first_2)
    wg = k(enc.second_0_global) * s2
    wl = k(enc.second_0_local) * s2
    c2 = b(enc.second_0_global) * s2 + t2
    w3 = k(enc.second_1)
    b3 = b(enc.second_1)
    return (w0, c0, w1, c1, w2, b2, wg, wl, c2, w3, b3)


def reference_folded_encoder(x: torch.Tensor, weights) -> torch.Tensor:
    """Plain torch version of the folded encoder. x (M, K, C) → (M, E) in
    x.dtype, with the kernel's rounding points."""
    M, K, C = x.shape
    dt = x.dtype
    w0, c0, w1, c1, w2, b2, wg, wl, c2, w3, b3 = [w.to(dt).float() for w in weights]
    E, H = w2.shape[-1], wl.shape[-1]
    h = torch.relu(x.reshape(M * K, C).float() @ w0 + c0).to(dt).float()
    h = torch.relu(h @ w1 + c1).to(dt).float()
    loc = (h @ w2 + b2).to(dt).float()
    g = loc.reshape(M, K, E).amax(dim=1)
    xg = g @ wg + c2
    h2 = torch.relu((loc @ wl).reshape(M, K, H) + xg[:, None, :]).to(dt).float()
    out = (h2.reshape(M * K, H) @ w3 + b3).reshape(M, K, E).amax(dim=1)
    return out.to(dt)


def fused_group_encoder(x: torch.Tensor, weights) -> torch.Tensor:
    """Folded encoder, x (M, K, C) → (M, E). ``weights`` is the 11-tuple of
    :func:`fold_encoder_params`. The kernel chain for a CUDA tensor (bf16
    or f32), the plain version for a CPU tensor."""
    if x.dim() != 3:
        raise ValueError(f"x must be (M, K, C), got {tuple(x.shape)}")
    if not x.is_cuda:
        return reference_folded_encoder(x, weights)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the encoder kernels compute in bf16 or f32, got {x.dtype}")
    out = launch_chain(x, weights)
    launches.add()
    return out


def launch_chain(x: torch.Tensor, weights) -> torch.Tensor:
    """The encoder as its chain of six GEMM calls (on a CPU tensor each call
    takes its plain version, which the tests use)."""
    M, K, C = x.shape
    dt = x.dtype
    mat = lambda w: w.to(device=x.device, dtype=dt).t().contiguous()  # (out, in)
    vec = lambda v: v.to(device=x.device, dtype=dt).contiguous()
    w0, c0, w1, c1, w2, b2, wg, wl, c2, w3, b3 = weights
    # The first product's depth C (6) is padded with zeros to a multiple of 8,
    # the width of one 16-byte load; the tensor-core step zero-fills to 16.
    cp = -(-C // 8) * 8
    xr = F.pad(x.reshape(M * K, C), (0, cp - C))
    w0k = F.pad(mat(w0), (0, cp - C))
    h, _ = gemm(xr, w0k, vec(c0), act="relu", out_dtype=dt)
    h, _ = gemm(h, mat(w1), vec(c1), act="relu", out_dtype=dt)
    loc, g = gemm(h, mat(w2), vec(b2), out_dtype=dt, group=K)
    xg, _ = gemm(g, mat(wg), vec(c2), out_dtype=torch.float32)
    h2, _ = gemm(loc, mat(wl), res=xg, res_div=K, act="relu", out_dtype=dt)
    _, out = gemm(h2, mat(w3), vec(b3), out_dtype=None, group=K)
    return out
