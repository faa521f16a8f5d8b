"""The torchvision encoder block with serial adapters at inference (the
renderer classifier's per-view trunk): its launch chain on the card and its
plain version.

Counterpart of ``pointvit_tpu/ops/pallas_block.py::fused_serial_block``
(``_serial_block_pallas``, kernels ``_serial_attn_half_kernel`` and
``_serial_mlp_half_kernel``, ``pallas_block.py:478-558``)::

    y  = proj(MHA(qkv(LN1 x)));    x1  = x  + y + up1(gelu(dn1(bf16 y)))
    m  = fc2(gelu(fc1(LN2 x1)));   out = x1 + m + up2(gelu(dn2(bf16 m)))

On the card the block is a chain of eleven hand-written launches: LN1, the
qkv GEMM, the packed-qkv attention kernel (``csrc/block.cu``), proj, dn1 with
GELU, up1, LN2, fc1 with GELU, fc2, dn2 with GELU, up2 (``csrc/gemm.cu``).
proj and fc2 each write two outputs in one launch: the branch rounded to
bf16 (``pre_out``, the adapter's input) and the f32 sum of the residual and
the branch, which the up-projection's epilogue adds to its own output. f32
addition commutes, so that sum is the Pallas kernel's (x + y) + a exactly.

The rounding follows the Pallas kernel, not the JAX package's
``reference_serial_block`` (which rounds y before its residual): y and m
stay f32 in the residual and are rounded to bf16 only as the adapters'
input (``pallas_block.py:488-491, 501-504``); LN affines, biases and
matrices are rounded to bf16 (``:514-515``); LN statistics are f32 with eps
1e-6; the softmax is f32 and P is rounded to bf16 before P·V; qkv, the
attention output, x1 and the GELU outputs are rounded to bf16; GELU is the
exact erf form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import LaunchCounter
from pointvit_tpu_torch.ops.block_kernel import (
    attention,
    attention_max_seq,
    layer_norm,
    reference_attention,
    reference_layer_norm,
)
from pointvit_tpu_torch.ops.gemm_kernel import gemm

__all__ = [
    "fused_serial_block",
    "launch_chain",
    "reference_serial_block",
    "serial_block_shapes_ok",
    "serial_block_weights",
    "launches",
]

launches = LaunchCounter("serial_block")


def serial_block_shapes_ok(S: int, E: int, num_heads: int) -> bool:
    """Whether the kernel chain takes the shape: head dim 64 and S ≤
    :func:`attention_max_seq` (1024), the blocks' gate. Every torchvision preset of
    the renderer passes (S = 197 or 50, head dim 64)."""
    if E % num_heads:
        return False
    return 0 < S <= attention_max_seq(E // num_heads)


def serial_block_weights(block, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """A ``SerialAdapterBlock``'s parameters as the chain takes them, in the
    order of ``pallas_block.py:609-623``: each cast once to ``dtype``,
    matrices in ``nn.Linear``'s (out, in) layout, which the GEMM takes as it
    is."""
    a, m, a1, a2 = block.self_attention, block.mlp, block.adapter1, block.adapter2
    return tuple(t.detach().to(dtype) for t in (
        block.ln_1.weight, block.ln_1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
        a1.down_proj.weight, a1.down_proj.bias, a1.up_proj.weight, a1.up_proj.bias,
        block.ln_2.weight, block.ln_2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
        a2.down_proj.weight, a2.down_proj.bias, a2.up_proj.weight, a2.up_proj.bias,
    ))


def reference_serial_block(x: torch.Tensor, weights, num_heads: int) -> torch.Tensor:
    """Plain torch serial-adapter block with the kernel chain's rounding
    points."""
    B, S, E = x.shape
    dt = x.dtype
    (g1, b1, wqkv, bqkv, wproj, bproj, wd1, bd1, wu1, bu1,
     g2, b2, wfc1, bfc1, wfc2, bfc2, wd2, bd2, wu2, bu2) = [t.to(dt).float() for t in weights]
    rd = lambda t: t.to(dt).float()
    gelu = lambda t: F.gelu(t, approximate="none")
    x2 = x.reshape(B * S, E).float()
    h = rd(reference_layer_norm(x2, g1, b1))
    qkv = rd(h @ wqkv.t() + bqkv)
    att = reference_attention(qkv.to(dt).reshape(B, S, 3 * E), num_heads).reshape(B * S, E)
    y = att.float() @ wproj.t() + bproj
    a = rd(gelu(rd(y) @ wd1.t() + bd1)) @ wu1.t() + bu1
    x1 = rd((x2 + y) + a)
    h = rd(reference_layer_norm(x1, g2, b2))
    h = rd(gelu(h @ wfc1.t() + bfc1))
    m = h @ wfc2.t() + bfc2
    a = rd(gelu(rd(m) @ wd2.t() + bd2)) @ wu2.t() + bu2
    return ((x1 + m) + a).to(dt).reshape(B, S, E)


def fused_serial_block(x: torch.Tensor, weights, num_heads: int) -> torch.Tensor:
    """Whole serial-adapter block at inference, x (B, S, E) → (B, S, E).
    ``weights`` is the 20-tuple of :func:`serial_block_weights` in x's dtype.
    The kernel chain for a CUDA tensor (bf16 or f32, shapes that pass
    :func:`serial_block_shapes_ok`; raises otherwise), the plain version for
    a CPU tensor."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, E), got {tuple(x.shape)}")
    B, S, E = x.shape
    if E % num_heads:
        raise ValueError(f"E={E} is not a multiple of num_heads={num_heads}")
    if not x.is_cuda:
        return reference_serial_block(x, weights, num_heads)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the block kernels compute in bf16 or f32, got {x.dtype}")
    if not serial_block_shapes_ok(S, E, num_heads):
        D = E // num_heads
        raise ValueError(f"the serial block kernels take head_dim 64 and S ≤ "
                         f"{attention_max_seq(D) or 'n/a'}; got head_dim {D}, S {S}")
    out = launch_chain(x, weights, num_heads)
    launches.add()
    return out


def launch_chain(x: torch.Tensor, weights, num_heads: int) -> torch.Tensor:
    """The block as its chain of LayerNorm, GEMM and attention calls (on a
    CPU tensor each call takes its plain version, which the tests use)."""
    B, S, E = x.shape
    dt = x.dtype
    (g1, b1, wqkv, bqkv, wproj, bproj, wd1, bd1, wu1, bu1,
     g2, b2, wfc1, bfc1, wfc2, bfc2, wd2, bd2, wu2, bu2) = weights
    x2 = x.reshape(B * S, E).contiguous()
    h = layer_norm(x2, g1, b1)
    qkv, _ = gemm(h, wqkv, bqkv, out_dtype=dt)
    att = attention(qkv.reshape(B, S, 3 * E), num_heads).reshape(B * S, E)
    y = torch.empty_like(x2)
    xy, _ = gemm(att, wproj, bproj, res=x2, out_dtype=torch.float32, pre_out=y)
    a, _ = gemm(y, wd1, bd1, act="gelu", out_dtype=dt)
    x1, _ = gemm(a, wu1, bu1, res=xy, out_dtype=dt)
    h = layer_norm(x1, g2, b2)
    h, _ = gemm(h, wfc1, bfc1, act="gelu", out_dtype=dt)
    m = torch.empty_like(x1)
    x1m, _ = gemm(h, wfc2, bfc2, res=x1, out_dtype=torch.float32, pre_out=m)
    a, _ = gemm(m, wd2, bd2, act="gelu", out_dtype=dt)
    out, _ = gemm(a, wu2, bu2, res=x1m, out_dtype=dt)
    return out.reshape(B, S, E)
