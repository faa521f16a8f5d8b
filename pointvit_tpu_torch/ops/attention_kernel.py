"""Packed-qkv attention with a hand-written backward: the forward and
backward kernels, their plain versions and the ``autograd.Function``.

Counterpart of ``pointvit_tpu/ops/pallas_attention.py::fused_mha_qkv``, the
``custom_vjp`` that the JAX APF block runs when it trains
(``nn/layers.py:91-99``)::

    forward   (B, S, 3E) → (B, S, E)      _mha_qkv_pallas      → csrc/block.cu::attention_kernel
    backward  qkv, g → dqkv (B, S, 3E)     _mha_qkv_bwd_pallas  → csrc/attention_bwd.cu

As in ``_fused_mha_qkv_fwd`` (``pallas_attention.py:443-444``) the forward
saves qkv and nothing else; the backward recomputes P. The plain backward
:func:`reference_mha_qkv_bwd` repeats ``_mha_qkv_bwd_kernel``
(``pallas_attention.py:271-321``) op by op: logits, softmax, dP = g·Vᵀ and
dS = P∘(dP − Σ(dP∘P))·scale in f32; dS and P rounded to the compute dtype
before dQ = dS·K, dK = dSᵀ·Q and dV = Pᵀ·g, which accumulate in f32; g cast
to qkv.dtype first (``:427``). Kernel and plain version therefore differ
only in summation order.

A CPU tensor takes the plain versions in both directions; a CUDA tensor
launches the kernels (bf16, head dim 64, S up to the kernels' limit) and
raises on anything else. ``implementation='torch'`` takes the plain versions
on any device.
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch._build import FLOAT, INT, PTR, LaunchCounter, check, kernel, require, stream_ptr
from pointvit_tpu_torch.ops.block_kernel import launch_attention, reference_attention, split_heads

__all__ = [
    "fused_mha_qkv",
    "mha_qkv",
    "mha_qkv_bwd",
    "reference_mha_qkv",
    "reference_mha_qkv_bwd",
    "launches",
    "bwd_launches",
]

launches = LaunchCounter("mha_qkv")
bwd_launches = LaunchCounter("mha_qkv_bwd")

reference_mha_qkv = reference_attention


def reference_mha_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain attention backward: qkv (B, S, 3E), g (B, S, E) → dqkv (B, S, 3E)
    in qkv.dtype, with the rounding points of ``_mha_qkv_bwd_kernel``."""
    B, S, E, D = split_heads(qkv, num_heads)
    dt = qkv.dtype
    ct = torch.promote_types(dt, torch.float32)
    scale = D**-0.5
    r = qkv.reshape(B, S, 3, num_heads, D).permute(2, 0, 3, 1, 4).to(ct)
    q, k, v = r[0], r[1], r[2]  # (B, H, S, D)
    gh = g.to(dt).reshape(B, S, num_heads, D).transpose(1, 2).to(ct)
    logits = (q @ k.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    ds, p = ds.to(dt).to(ct), p.to(dt).to(ct)
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    dv = p.transpose(-1, -2) @ gh
    out = torch.stack([dq, dk, dv]).to(dt)  # (3, B, H, S, D)
    return out.permute(1, 3, 0, 2, 4).reshape(B, S, 3 * E)


def mha_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention forward (B, S, 3E) → (B, S, E): ``attention_kernel`` of
    ``csrc/block.cu`` on a CUDA tensor, the plain version on a CPU tensor."""
    if not qkv.is_cuda:
        split_heads(qkv, num_heads)
        return reference_mha_qkv(qkv, num_heads)
    out = launch_attention(qkv, num_heads)
    launches.add()
    return out


def mha_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention backward: ``csrc/attention_bwd.cu`` on CUDA tensors (bf16,
    head dim 64), the plain version on CPU tensors."""
    B, S, E, D = split_heads(qkv, num_heads)
    if tuple(g.shape) != (B, S, E):
        raise ValueError(f"g must be {(B, S, E)}, got {tuple(g.shape)}")
    if not qkv.is_cuda:
        return reference_mha_qkv_bwd(qkv, g, num_heads)
    require(qkv, "qkv", torch.bfloat16, 3)
    g = g.to(torch.bfloat16).contiguous()
    require(g, "g", torch.bfloat16, 3, qkv.device)
    limit = kernel("attention_bwd", "pv_attention_bwd_max_seq", [INT])(D)
    if limit == 0 or S > limit:
        raise ValueError(
            f"the attention backward kernel takes head_dim 64 and S ≤ {limit or 'n/a'}; "
            f"got head_dim {D}, S {S}"
        )
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, B, num_heads, S), dtype=torch.float32, device=qkv.device)
    fn = kernel("attention_bwd", "pv_attention_bwd",
                [PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, PTR])
    err = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, S, num_heads, D,
             D**-0.5, stream_ptr(qkv.device))
    check(err, "attention_bwd", "pv_attention_bwd")
    bwd_launches.add()
    return dqkv


class _FusedMHAQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, plain):
        ctx.num_heads, ctx.plain = num_heads, plain
        ctx.save_for_backward(qkv)
        if plain:
            return reference_mha_qkv(qkv, num_heads)
        return mha_qkv(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        if ctx.plain:
            return reference_mha_qkv_bwd(qkv, g, ctx.num_heads), None, None
        return mha_qkv_bwd(qkv, g.contiguous(), ctx.num_heads), None, None


def fused_mha_qkv(qkv: torch.Tensor, num_heads: int, implementation: str | None = None) -> torch.Tensor:
    """Differentiable packed-qkv attention (B, S, 3E) → (B, S, E).
    ``implementation``: None (the kernels on CUDA, the plain versions on the
    CPU) or 'torch' (the plain versions on any device)."""
    if implementation not in (None, "torch"):
        raise ValueError(f"unknown implementation: {implementation!r}")
    split_heads(qkv, num_heads)
    return _FusedMHAQKV.apply(qkv.contiguous(), num_heads, implementation == "torch")
