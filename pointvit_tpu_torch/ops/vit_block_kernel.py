"""The timm pre-norm ViT block at inference (Pix4Point's trunk): its launch
chain on the card and its plain version.

Counterpart of ``pointvit_tpu/ops/pallas_block.py::fused_vit_block``
(``_vit_block_pallas``, kernels ``_vit_attn_half_kernel`` and
``_vit_mlp_half_kernel``, ``pallas_block.py:295-462``)::

    xp  = x + pos                             (bf16 add; pos optional)
    x1  = xp + proj(MHA(qkv(LN1 xp)))
    out = x1 + fc2(gelu(fc1(LN2 x1)))

On the card the block is a chain of hand-written launches: the LayerNorm
that adds ``pos`` and writes both xp and LN1(xp) (``csrc/block.cu``), the
qkv GEMM, the packed-qkv attention kernel (``csrc/attention.cu``; the chain
takes head dim 64 and S ≤ 1024, Pix4Point's S = 513 included), proj with
the xp residual in its epilogue and LN2 (one launch at width 384, which
writes x1 and LN2(x1): :func:`proj_layer_norm`; two elsewhere), fc1 with
GELU, fc2 with the x1 residual (``csrc/gemm.cu``); f32 blocks run the same
chain on the f32 kernels. The rounding follows
``_vit_block_pallas``: LN affines and biases are rounded to bf16
(``pallas_block.py:343-344``); LN statistics are f32 with eps 1e-6; the
softmax is f32 and P is rounded to bf16 before P·V; qkv, the attention
output, x1 and the GELU output are rounded to bf16; GELU is the exact erf
form. ``pos`` is per cloud (B, S, E) or shared (1, S, E) / (S, E)
(``:350-366``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import FLOAT, INT, PTR, LaunchCounter, check, kernel, require, stream_ptr
from pointvit_tpu_torch.ops.block_kernel import (
    LN_EPS,
    attention,
    attention_max_seq,
    layer_norm,
    pos_layer_norm,
    reference_attention,
    reference_layer_norm,
)
from pointvit_tpu_torch.ops.gemm_kernel import gemm, reference_gemm

__all__ = [
    "fused_vit_block",
    "launch_chain",
    "proj_layer_norm",
    "reference_proj_layer_norm",
    "reference_vit_block",
    "vit_block_shapes_ok",
    "vit_block_weights",
    "launches",
]

launches = LaunchCounter("vit_block")
proj_ln_launches = LaunchCounter("proj_layernorm")

# The width whose proj and LN2 run as one launch (csrc/gemm.cu's proj +
# LayerNorm instance holds whole rows of it): vit_small's.
PROJ_LN_WIDTH = 384


def reference_proj_layer_norm(a, w, bias, res, gamma, beta):
    """Plain version of :func:`proj_layer_norm`: x1 = a·wᵀ + bias + res
    rounded to a's dtype, then LN(x1) with f32 statistics."""
    x1, _ = reference_gemm(a, w, bias, res=res, out_dtype=a.dtype)
    return x1, reference_layer_norm(x1, gamma, beta)


def proj_layer_norm(a, w, bias, res, gamma, beta):
    """The block's proj with its residual and the LayerNorm after it:
    returns (x1, LN(x1)), x1 = a·wᵀ + bias + res. On a CUDA tensor one
    launch of ``csrc/gemm.cu``'s proj + LayerNorm instance (bf16, N = 384),
    counted as ``proj_layernorm``; on a CPU tensor the plain version."""
    if not a.is_cuda:
        return reference_proj_layer_norm(a, w, bias, res, gamma, beta)
    bf, dev = torch.bfloat16, a.device
    require(a, "a", bf, 2)
    M, K = a.shape
    for name, t, shape in (("w", w, (PROJ_LN_WIDTH, K)), ("bias", bias, (PROJ_LN_WIDTH,)),
                           ("res", res, (M, PROJ_LN_WIDTH)), ("gamma", gamma, (PROJ_LN_WIDTH,)),
                           ("beta", beta, (PROJ_LN_WIDTH,))):
        require(t, name, bf, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if K % 8:
        raise ValueError(f"the proj + LayerNorm kernel needs K % 8 == 0, got K={K}")
    x1 = torch.empty((M, PROJ_LN_WIDTH), dtype=bf, device=dev)
    y = torch.empty_like(x1)
    fn = kernel("gemm", "pv_gemm_ln", [PTR] * 8 + [FLOAT, INT, INT, INT, PTR])
    err = fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), x1.data_ptr(), y.data_ptr(), LN_EPS, M, PROJ_LN_WIDTH, K, stream_ptr(dev))
    check(err, "gemm", "pv_gemm_ln")
    proj_ln_launches.add()
    return x1, y


def vit_block_shapes_ok(S: int, E: int, num_heads: int) -> bool:
    """Whether the kernel chain takes the shape: head dim and S within the
    blocks' gate (:func:`attention_max_seq`: head dim 64, S ≤ 1024), which
    lies inside the JAX package's gate ``fused_block_shapes_ok``
    (``pallas_block.py:97-110``)."""
    if E % num_heads:
        return False
    limit = attention_max_seq(E // num_heads)
    return 0 < S <= limit


def vit_block_weights(block, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """A ``ViTBlock``'s parameters as the chain takes them, in the order of
    ``pallas_block.py:452-462``: each cast once to ``dtype`` (the bf16
    rounding of the LN affines, biases and matrices, ``:343-344``), matrices
    in ``nn.Linear``'s (out, in) layout, which the GEMM takes as it is."""
    a, m = block.attn, block.mlp
    return tuple(t.detach().to(dtype) for t in (
        block.norm1.weight, block.norm1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
        block.norm2.weight, block.norm2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
    ))


def _pos_table(pos: torch.Tensor, B: int, S: int, E: int) -> torch.Tensor:
    """pos as (rows, E) for the row-tiled LayerNorm: (B·S, E) per cloud or
    (S, E) shared."""
    if pos.dim() == 2:
        pos = pos[None]
    if pos.dim() != 3 or pos.shape[0] not in (1, B) or tuple(pos.shape[1:]) != (S, E):
        raise ValueError(f"pos must be (B, S, E), (1, S, E) or (S, E); got {tuple(pos.shape)}")
    return pos.reshape(-1, E)


def reference_vit_block(x: torch.Tensor, weights, num_heads: int, pos=None) -> torch.Tensor:
    """Plain torch ViT block with the kernel chain's rounding points."""
    B, S, E = x.shape
    dt = x.dtype
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2 = [
        t.to(dt).float() for t in weights]
    rd = lambda t: t.to(dt).float()
    x2 = x.reshape(B * S, E)
    if pos is not None:  # the add in dt, as the model's x + pos
        table = _pos_table(pos, B, S, E).to(device=x.device, dtype=dt)
        x2 = (x2.reshape(-1, table.shape[0], E) + table).reshape(B * S, E)
    x2 = x2.float()
    h = rd(reference_layer_norm(x2, g1, b1))
    qkv = rd(h @ wqkv.t() + bqkv)
    att = reference_attention(qkv.to(dt).reshape(B, S, 3 * E), num_heads).reshape(B * S, E)
    x1 = rd(x2 + (att.float() @ wproj.t() + bproj))
    h = rd(reference_layer_norm(x1, g2, b2))
    h = rd(F.gelu(h @ wfc1.t() + bfc1, approximate="none"))
    return (x1 + (h @ wfc2.t() + bfc2)).to(dt).reshape(B, S, E)


def fused_vit_block(x: torch.Tensor, weights, num_heads: int, pos=None) -> torch.Tensor:
    """Whole ViT block at inference, x (B, S, E) → (B, S, E). ``weights`` is
    the 12-tuple of :func:`vit_block_weights` in x's dtype. The kernel chain
    for a CUDA tensor (bf16 or f32, shapes that pass :func:`vit_block_shapes_ok`;
    raises otherwise), the plain version for a CPU tensor."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, E), got {tuple(x.shape)}")
    B, S, E = x.shape
    if E % num_heads:
        raise ValueError(f"E={E} is not a multiple of num_heads={num_heads}")
    if not x.is_cuda:
        return reference_vit_block(x, weights, num_heads, pos)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the block kernels compute in bf16 or f32, got {x.dtype}")
    if not vit_block_shapes_ok(S, E, num_heads):
        D = E // num_heads
        raise ValueError(f"the ViT block kernels take head_dim 64 and S ≤ "
                         f"{attention_max_seq(D) or 'n/a'}; got head_dim {D}, S {S}")
    out = launch_chain(x, weights, num_heads, pos)
    launches.add()
    return out


def launch_chain(x: torch.Tensor, weights, num_heads: int, pos=None) -> torch.Tensor:
    """The block as its chain of LayerNorm, GEMM and attention calls (on a
    CPU tensor each call takes its plain version, which the tests use)."""
    B, S, E = x.shape
    dt = x.dtype
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2 = weights
    x2 = x.reshape(B * S, E).contiguous()
    if pos is not None:
        table = _pos_table(pos, B, S, E).to(device=x.device, dtype=dt).contiguous()
        xp, h = pos_layer_norm(x2, table, g1, b1)
    else:
        xp, h = x2, layer_norm(x2, g1, b1)
    qkv, _ = gemm(h, wqkv, bqkv, out_dtype=dt)
    att = attention(qkv.reshape(B, S, 3 * E), num_heads).reshape(B * S, E)
    if dt == torch.bfloat16 and E == PROJ_LN_WIDTH:
        x1, h = proj_layer_norm(att, wproj, bproj, xp, g2, b2)
    else:
        x1, _ = gemm(att, wproj, bproj, res=xp, out_dtype=dt)
        h = layer_norm(x1, g2, b2)
    h, _ = gemm(h, wfc1, bfc1, act="gelu", out_dtype=dt)
    out, _ = gemm(h, wfc2, bfc2, res=x1, out_dtype=dt)
    return out.reshape(B, S, E)
