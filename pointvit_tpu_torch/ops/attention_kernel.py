"""Attention with hand-written kernels in both directions: the packed-qkv
attention, its split-layout front, and the fused attention sublayer (qkv
projection, attention, output projection), each with its plain version and
its ``autograd.Function``.

Counterpart of ``pointvit_tpu/ops/pallas_attention.py``::

    fused_mha_qkv         (B, S, 3E) → (B, S, E)   _mha_qkv_pallas      → csrc/attention.cu
      its backward        qkv, g → dqkv            _mha_qkv_bwd_pallas  → csrc/attention_bwd.cu
      (other dtypes and head dims, both directions)                  → csrc/attention_any.cu
    fused_mha             (B, S, H, D) x 3 → (B, S, H, D): pack, the two kernels above, split
    fused_attention_block x (B, S, E) → (B, S, E)  _attn_block_pallas   → csrc/attn_block.cu + csrc/gemm.cu
      its backward        torch.matmul for the products, csrc/attention_bwd.cu for the attention

``fused_mha_qkv`` is the ``custom_vjp`` that the JAX APF block runs when it
trains (``nn/layers.py:91-99``). As in ``_fused_mha_qkv_fwd``
(``pallas_attention.py:443-444``) the forward saves qkv and nothing else;
the backward recomputes P. The plain backward :func:`reference_mha_qkv_bwd`
repeats ``_mha_qkv_bwd_kernel`` (``pallas_attention.py:271-321``) op by op:
logits, softmax, dP = g·Vᵀ and dS = P∘(dP − Σ(dP∘P))·scale in f32; dS and
P rounded to the compute dtype before dQ = dS·K, dK = dSᵀ·Q and dV = Pᵀ·g,
which accumulate in f32; g cast to qkv.dtype first (``:427``). Kernel and
plain version therefore differ only in summation order.

A CPU tensor takes the plain versions in both directions; a CUDA tensor
launches the kernels and raises on anything they do not take. The attention
and its backward take any S: bf16 at head dim 64 goes to the wgmma kernels,
bf16 or f32 at any other head dim up to 256 (and f32 at 64) to
``csrc/attention_any.cu`` (:func:`~pointvit_tpu_torch.ops.block_kernel.wgmma_attention`
picks). The fused sublayer takes bf16 at head dim 64 and S up to 736.
``implementation='torch'`` takes the plain versions on any device.
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch._build import FLOAT, INT, PTR, LaunchCounter, check, kernel, require, stream_ptr
from pointvit_tpu_torch.ops.block_kernel import (
    MAX_HEAD_DIM, launch_attention, reference_attention, split_heads, wgmma_attention,
)
from pointvit_tpu_torch.ops.gemm_kernel import gemm

__all__ = [
    "attention_block_weights",
    "attn_block",
    "attn_block_max_seq",
    "fused_attention_block",
    "fused_mha",
    "fused_mha_qkv",
    "mha_qkv",
    "mha_qkv_bwd",
    "reference_attn_block",
    "reference_mha",
    "reference_mha_qkv",
    "reference_mha_qkv_bwd",
    "launches",
    "bwd_launches",
    "any_bwd_launches",
    "attn_block_launches",
]

launches = LaunchCounter("mha_qkv")
bwd_launches = LaunchCounter("mha_qkv_bwd")
any_bwd_launches = LaunchCounter("attention_any_bwd")
attn_block_launches = LaunchCounter("attn_block")

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
    """Attention forward (B, S, 3E) → (B, S, E) on a CUDA tensor (any S):
    ``csrc/attention.cu`` for bf16 at head dim 64 (counted as ``mha_qkv``),
    ``csrc/attention_any.cu`` otherwise; the plain version on a CPU tensor."""
    if not qkv.is_cuda:
        split_heads(qkv, num_heads)
        return reference_mha_qkv(qkv, num_heads)
    return launch_attention(qkv, num_heads, launches)


def mha_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention backward on CUDA tensors (any S): ``csrc/attention_bwd.cu``
    for bf16 at head dim 64 (counted as ``mha_qkv_bwd``), else
    ``csrc/attention_any.cu`` (bf16 or f32, head dim up to 256; counted as
    ``attention_any_bwd``); the plain version on CPU tensors. g is cast to
    qkv's dtype first."""
    B, S, E, D = split_heads(qkv, num_heads)
    if tuple(g.shape) != (B, S, E):
        raise ValueError(f"g must be {(B, S, E)}, got {tuple(g.shape)}")
    if not qkv.is_cuda:
        return reference_mha_qkv_bwd(qkv, g, num_heads)
    dt = qkv.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the attention backward kernels take bf16 or f32, got {dt}")
    require(qkv, "qkv", dt, 3)
    g = g.to(dt).contiguous()
    require(g, "g", dt, 3, qkv.device)
    if not wgmma_attention(dt, D):
        return _any_bwd(qkv, g, B, S, num_heads, D)
    dqkv = torch.empty_like(qkv)
    # (row max · c, 1 / row sum, delta) of every query row, rows padded to 64
    stats = torch.empty((3, B, num_heads, -(-S // 64) * 64), dtype=torch.float32, device=qkv.device)
    fn = kernel("attention_bwd", "pv_attention_bwd",
                [PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, PTR])
    err = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, S, num_heads, D,
             D**-0.5, stream_ptr(qkv.device))
    check(err, "attention_bwd", "pv_attention_bwd")
    bwd_launches.add()
    return dqkv


def _any_bwd(qkv, g, B, S, num_heads, D):
    """The backward's two launches of ``csrc/attention_any.cu``."""
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the attention backward kernels take head_dim up to {MAX_HEAD_DIM}; "
                         f"got head_dim {D}, S {S}")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, B, num_heads, S), dtype=torch.float32, device=qkv.device)
    fn = kernel("attention_any", "pv_attention_any_bwd",
                [PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, INT, PTR])
    err = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, S, num_heads, D,
             D**-0.5, int(qkv.dtype == torch.float32), stream_ptr(qkv.device))
    check(err, "attention_any", "pv_attention_any_bwd")
    any_bwd_launches.add()
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


# ------------------------------------------------ split layout: fused_mha


def _pack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) q, k, v → the packed (B, S, 3E) [q | k | v]."""
    if q.dim() != 4 or not q.shape == k.shape == v.shape:
        raise ValueError(f"q, k, v must be (B, S, H, D) alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    return torch.cat([t.reshape(B, S, H * D) for t in (q, k, v)], dim=-1)


def reference_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention on (B, S, H, D) → (B, S, H, D), ``reference_mha`` of
    the JAX package with the kernels' rounding points: f32 logits and
    softmax, P rounded to q.dtype before P·V."""
    B, S, H, D = q.shape
    return reference_mha_qkv(_pack(q, k, v), H).reshape(B, S, H, D)


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, plain):
        ctx.plain = plain
        ctx.save_for_backward(q, k, v)
        B, S, H, D = q.shape
        att = reference_mha_qkv if plain else mha_qkv
        return att(_pack(q, k, v), H).reshape(B, S, H, D)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        B, S, H, D = q.shape
        E = H * D
        bwd = reference_mha_qkv_bwd if ctx.plain else mha_qkv_bwd
        dqkv = bwd(_pack(q, k, v), g.reshape(B, S, E).contiguous(), H)
        return (*(dqkv[..., i * E:(i + 1) * E].reshape(B, S, H, D) for i in range(3)), None)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              implementation: str | None = None) -> torch.Tensor:
    """Differentiable attention on split heads, q/k/v (B, S, H, D) → (B, S,
    H, D), as ``pallas_attention.py::fused_mha``: the forward packs q, k, v
    and runs the packed-qkv kernel (``_mha_pallas``, ``:162-169``), the
    backward packs them and runs the backward kernel, then splits dqkv
    (``_fused_mha_bwd``, ``:186-198``). ``implementation``: None or 'torch',
    as for :func:`fused_mha_qkv`."""
    if implementation not in (None, "torch"):
        raise ValueError(f"unknown implementation: {implementation!r}")
    _pack(q, k, v)
    return _FusedMHA.apply(q, k, v, implementation == "torch")


# ------------------------------- the fused sublayer: fused_attention_block


def attention_block_weights(attn) -> tuple[torch.Tensor, ...]:
    """(wqkv (E, 3E), bqkv (3E,), wproj (E, E), bproj (E,)) of a port
    ``nn.layers.Attention``, in the JAX layouts: views of its parameters, so
    gradients reach them."""
    return attn.qkv.weight.t(), attn.qkv.bias, attn.proj.weight.t(), attn.proj.bias


def _check_block(x, wqkv, bqkv, wproj, bproj, num_heads: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, E), got {tuple(x.shape)}")
    E = x.shape[-1]
    if E % num_heads:
        raise ValueError(f"E={E} is not a multiple of num_heads={num_heads}")
    for name, t, want in (("wqkv", wqkv, (E, 3 * E)), ("bqkv", bqkv, (3 * E,)),
                          ("wproj", wproj, (E, E)), ("bproj", bproj, (E,))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want} for E={E}, got {tuple(t.shape)}")


def _project(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x2 (rows, K) @ w (K, N) + b with w and b cast to x2's dtype first;
    the product and the bias in f32 (f64 for f64), rounded once to x2's
    dtype."""
    dt = x2.dtype
    ct = torch.promote_types(dt, torch.float32)
    return (x2.to(ct) @ w.to(dt).to(ct) + b.to(dt).to(ct)).to(dt)


def _reference_parts(x, wqkv, bqkv, wproj, bproj, num_heads: int):
    """The plain sublayer: (out, o), o the attention output before the
    output projection."""
    B, S, E = x.shape
    qkv = _project(x.reshape(B * S, E), wqkv, bqkv).reshape(B, S, 3 * E)
    o = reference_mha_qkv(qkv, num_heads)
    return _project(o.reshape(B * S, E), wproj, bproj).reshape(B, S, E), o


def reference_attn_block(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                         wproj: torch.Tensor, bproj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_attention_block`, the counterpart of
    ``_reference_attn_block`` (``pallas_attention.py:534-537``)::

        qkv = x @ wqkv + bqkv;  o = MHA(qkv);  out = o @ wproj + bproj

    with the weights and biases cast to x's dtype. Each product and its bias
    are summed in f32 (f64 for f64) and rounded once to x's dtype, as in
    ``_attn_block_kernel``; the MHA is :func:`reference_mha_qkv`."""
    _check_block(x, wqkv, bqkv, wproj, bproj, num_heads)
    return _reference_parts(x, wqkv, bqkv, wproj, bproj, num_heads)[0]


def attn_block_max_seq(head_dim: int) -> int:
    """The longest sequence ``csrc/attn_block.cu`` takes at ``head_dim`` (0:
    that head dim is not taken): 736 at head dim 64, where the head's K and V
    fill a block's shared memory."""
    return kernel("attn_block", "pv_attn_block_max_seq", [INT])(head_dim)


def attn_block(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, wproj: torch.Tensor,
               bproj: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward of the fused sublayer; returns (out, o), o (B, S, E) the
    attention output before the output projection, which the backward saves.

    On a CUDA tensor two launches, counted once as ``attn_block``:
    ``csrc/attn_block.cu`` (the qkv projection and the attention; the (B, S,
    3E) qkv never reaches device memory) and one ``csrc/gemm.cu`` for
    o · wproj + bproj. It takes bf16 x, head dim 64 and S up to
    :func:`attn_block_max_seq` (736), and raises on anything else. On a CPU
    tensor: the plain version."""
    _check_block(x, wqkv, bqkv, wproj, bproj, num_heads)
    if not x.is_cuda:
        return _reference_parts(x, wqkv, bqkv, wproj, bproj, num_heads)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the attn_block kernel computes in bf16, got {x.dtype}")
    require(x, "x", torch.bfloat16, 3)
    B, S, E = x.shape
    D = E // num_heads
    limit = attn_block_max_seq(D)
    if limit == 0 or S > limit:
        raise ValueError(f"the attn_block kernel takes head_dim 64 and S ≤ {limit or 'n/a'}; "
                         f"got head_dim {D}, S {S}")
    dt, dev = x.dtype, x.device
    w = wqkv.detach().to(dev, dt).t().contiguous()  # (3E, E): row n is output column n
    b = bqkv.detach().to(dev, dt).contiguous()
    o = torch.empty_like(x)
    fn = kernel("attn_block", "pv_attn_block", [PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, PTR])
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(), B, S, num_heads, D, D**-0.5,
             stream_ptr(dev))
    check(err, "attn_block", "pv_attn_block")
    out, _ = gemm(o.reshape(B * S, E), wproj.detach().to(dev, dt).t().contiguous(),
                  bproj.detach().to(dev, dt).contiguous(), out_dtype=dt)
    attn_block_launches.add()
    return out.reshape(B, S, E), o


def _attn_block_bwd(x, wqkv, bqkv, wproj, o, g, num_heads: int, plain: bool):
    """The five gradients of the sublayer in x's dtype, as JAX's ``_fab_bwd``
    (the VJP of ``_reference_attn_block``, ``:551-555``) computes them:
    torch.matmul for every product, the attention's VJP by
    :func:`mha_qkv_bwd` (the B6 kernel on the card) or, when ``plain``, its
    plain version. The backward kernel takes any S, so on the card every
    shape the forward took runs the kernel here."""
    B, S, E = x.shape
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)
    x2 = x.reshape(B * S, E)
    g2 = g.to(dt).reshape(B * S, E)
    dwproj = o.reshape(B * S, E).t() @ g2
    dbproj = g2.to(ct).sum(0)
    do = g2 @ wproj.to(dt).t()
    qkv = _project(x2, wqkv, bqkv).reshape(B, S, 3 * E)  # recomputed, as the forward rounds it
    bwd = reference_mha_qkv_bwd if plain else mha_qkv_bwd
    dqkv = bwd(qkv, do.reshape(B, S, E), num_heads).reshape(B * S, 3 * E)
    dx = (dqkv @ wqkv.to(dt).t()).reshape(B, S, E)
    return dx, x2.t() @ dqkv, dqkv.to(ct).sum(0), dwproj, dbproj


class _FusedAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, num_heads, plain):
        parts = _reference_parts if plain else attn_block
        out, o = parts(x, wqkv, bqkv, wproj, bproj, num_heads)
        ctx.num_heads, ctx.plain = num_heads, plain
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, o)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wproj, bproj, o = ctx.saved_tensors
        grads = _attn_block_bwd(x, wqkv, bqkv, wproj, o, g, ctx.num_heads, ctx.plain)
        return (*(d.to(t.dtype) for d, t in zip(grads, (x, wqkv, bqkv, wproj, bproj))), None, None)


def fused_attention_block(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                          wproj: torch.Tensor, bproj: torch.Tensor, num_heads: int,
                          implementation: str | None = None) -> torch.Tensor:
    """qkv projection + multi-head attention + output projection, x (B, S, E)
    → (B, S, E), differentiable in all five tensors; the JAX signature and
    layouts (``pallas_attention.py:541``): wqkv (E, 3E) packed [q | k | v]
    with heads contiguous, bqkv (3E,), wproj (E, E), bproj (E,), all cast to
    x's dtype.

    Forward: :func:`attn_block` (on the card bf16, head dim 64, S ≤ 736).
    Backward: :func:`_attn_block_bwd` from x, the weights and the saved o.
    ``implementation``: None (the kernels on CUDA, the plain versions on the
    CPU) or 'torch' (the plain versions on any device)."""
    if implementation not in (None, "torch"):
        raise ValueError(f"unknown implementation: {implementation!r}")
    _check_block(x, wqkv, bqkv, wproj, bproj, num_heads)
    return _FusedAttentionBlock.apply(x.contiguous(), wqkv, bqkv, wproj, bproj, num_heads,
                                      implementation == "torch")
