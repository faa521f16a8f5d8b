"""Folded P3Embed stage (Pix4Point's tokenizer): BN folding, the fused
kernel chain and its plain version.

Counterpart of the P3 part of ``pointvit_tpu/ops/pallas_encoder.py``
(``_p3_kernel``/``_p3_pallas``, ``fold_p3_stage_params``,
``pallas_encoder.py:198-326``). At inference each BatchNorm folds into the
product before it (f32, eps 1e-5), and the stage's two conv1 linears, which
have no nonlinearity between them, fold into one (C, D) product
``W01 = V0 @ (V1·s1)``. The concat([global, local]) product of conv2 splits
by rows into a per-group half ``g @ W2g`` and a per-point half
``h @ W2l``. The stage becomes (``_p3_kernel``, ``:218-231``)::

    h   = relu(x @ W01 + c01)                          (M·K, D)
    g   = max_K h                                      (M, D)
    h2  = relu(h @ W2l + (g @ W2g + c2))               (M·K, H)
    out = max_K relu(h2 @ W3 + c3)                     (M, D)

Note the ReLU before the final max, which the APF encoder lacks. On the
card this is a chain of four launches of the fused-epilogue GEMM
(``csrc/gemm.cu``): the first writes h and its group max g, the last
reduces over K in its epilogue, so the (M·K, D) output never reaches device
memory. As in ``_p3_pallas`` every folded weight *and bias* is rounded to
the compute dtype, products accumulate in f32, h and h2 are rounded to the
compute dtype, and g·W2g + c2 stays f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import LaunchCounter
from pointvit_tpu_torch.ops.encoder_kernel import bn_affine
from pointvit_tpu_torch.ops.gemm_kernel import gemm

__all__ = [
    "fold_p3_stage_params",
    "fused_p3_embed",
    "launch_chain",
    "reference_folded_p3",
    "launches",
]

launches = LaunchCounter("p3_embed")


def fold_p3_stage_params(p3embed, stage: int = 0) -> tuple[torch.Tensor, ...]:
    """Fold stage ``stage`` of a 4-layer ``P3Embed`` (conv1 = linear →
    linear → BN → ReLU, conv2 = two of linear → BN → ReLU). Returns the 7 f32
    arrays of ``pallas_encoder.py:303-326`` in the JAX layout (matrices are
    (in, out)): (W01, c01, W2g, W2l, c2, W3, c3)."""
    layer = lambda name: getattr(p3embed, f"s{stage}_{name}")
    k = lambda lin: lin.weight.detach().float().t()
    s1, t1 = bn_affine(layer("conv1_bn"))
    s2, t2 = bn_affine(layer("conv2_bn0"))
    s3, t3 = bn_affine(layer("conv2_bn1"))
    v0, v1 = k(layer("conv1_0")), k(layer("conv1_1"))  # (C, D) no bias, (D, D)
    w01 = v0 @ (v1 * s1)
    c01 = layer("conv1_1").bias.detach().float() * s1 + t1
    k2 = k(layer("conv2_0")) * s2  # (2D, H), no bias
    D = v0.shape[-1]
    w3 = k(layer("conv2_1")) * s3  # (H, D), no bias
    return (w01, c01, k2[:D], k2[D:], t2, w3, t3)


def reference_folded_p3(x: torch.Tensor, weights) -> torch.Tensor:
    """Plain torch version of the folded stage. x (M, K, C) → (M, D) in
    x.dtype, with the kernel's rounding points."""
    M, K, C = x.shape
    dt = x.dtype
    w01, c01, w2g, w2l, c2, w3, c3 = [w.to(device=x.device, dtype=dt).float() for w in weights]
    D, H = w01.shape[-1], w2l.shape[-1]
    h = torch.relu(x.reshape(M * K, C).float() @ w01 + c01).to(dt).float()
    g = h.reshape(M, K, D).amax(dim=1)
    xg = g @ w2g + c2
    h2 = torch.relu((h @ w2l).reshape(M, K, H) + xg[:, None, :]).to(dt).float()
    out = torch.relu(h2.reshape(M * K, H) @ w3 + c3).reshape(M, K, D).amax(dim=1)
    return out.to(dt)


def fused_p3_embed(x: torch.Tensor, weights) -> torch.Tensor:
    """Folded P3Embed stage, x (M, K, C) → (M, D). ``weights`` is the 7-tuple
    of :func:`fold_p3_stage_params`. The kernel chain for a CUDA tensor (bf16
    or f32), the plain version for a CPU tensor."""
    if x.dim() != 3:
        raise ValueError(f"x must be (M, K, C), got {tuple(x.shape)}")
    if not x.is_cuda:
        return reference_folded_p3(x, weights)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the P3 stage kernels compute in bf16 or f32, got {x.dtype}")
    out = launch_chain(x, weights)
    launches.add()
    return out


def launch_chain(x: torch.Tensor, weights) -> torch.Tensor:
    """The stage as its chain of four GEMM calls (on a CPU tensor each call
    takes its plain version, which the tests use)."""
    M, K, C = x.shape
    dt = x.dtype
    mat = lambda w: w.to(device=x.device, dtype=dt).t().contiguous()  # (out, in)
    vec = lambda v: v.to(device=x.device, dtype=dt).contiguous()
    w01, c01, w2g, w2l, c2, w3, c3 = weights
    # The first product's depth C (3 + 3) is padded with zeros to a multiple
    # of 8, the width of one 16-byte load.
    cp = -(-C // 8) * 8
    xr = F.pad(x.reshape(M * K, C), (0, cp - C))
    h, g = gemm(xr, F.pad(mat(w01), (0, cp - C)), vec(c01), act="relu", out_dtype=dt, group=K)
    xg, _ = gemm(g, mat(w2g), vec(c2), out_dtype=torch.float32)
    h2, _ = gemm(h, mat(w2l), res=xg, res_div=K, act="relu", out_dtype=dt)
    _, out = gemm(h2, mat(w3), vec(c3), act="relu", out_dtype=None, group=K)
    return out
