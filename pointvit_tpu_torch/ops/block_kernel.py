"""The APF block at inference: LayerNorm kernels (``csrc/block.cu``), the
attention kernel (``csrc/attention.cu``), the block's launch chain, and its
plain version. The LayerNorm with the positional re-add and the attention
kernel here also serve the Pix4Point block (:mod:`pointvit_tpu_torch.ops.vit_block_kernel`).

Counterpart of the APF part of ``pointvit_tpu/ops/pallas_block.py``
(``_attn_half_kernel`` + ``_mlp_half_kernel``)::

    x1  = x + proj(MHA(qkv(LN1 x)))
    out = fc2(gelu(fc1(LN2 x1))) + s·up(relu(down(LNa x1))) + 2·x1

(the reference's double residual: the adapter adds its own x1). On the card
the block is a chain of hand-written launches: three LayerNorms, the packed
qkv attention kernel, and six fused-epilogue GEMMs (``csrc/gemm.cu``). The
rounding follows ``_apf_block_pallas``: LN gammas and betas and all biases
are rounded to bf16 (``pallas_block.py:204-205``); the adapter scale is
folded into ``up`` in f32 and then rounded (``:228-233``); LN statistics
and the softmax are f32 with eps 1e-6; P is rounded to bf16 before P·V;
GELU is the exact erf form. An f32 block (``bf16=False`` models) runs
the same chain in f32: the LayerNorms' f32 instances, the f32 GEMM and the
attention for any head dim (``csrc/attention_any.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import (
    FLOAT, INT, PTR, LaunchCounter, check, exporting, kernel, kernel_op, require, stream_ptr,
)
from pointvit_tpu_torch.ops.gemm_kernel import gemm

__all__ = [
    "apf_block_shapes_ok",
    "apf_launch_weights",
    "apf_block_weights",
    "fused_apf_block",
    "launch_chain",
    "reference_apf_block",
    "layer_norm",
    "reference_layer_norm",
    "pos_layer_norm",
    "reference_pos_layer_norm",
    "attention",
    "attention_max_seq",
    "check_any_shape",
    "launch_attention",
    "MAX_GRID_BH",
    "MAX_HEAD_DIM",
    "wgmma_attention",
    "reference_attention",
    "split_heads",
    "launches",
]

LN_EPS = 1e-6  # the flax LayerNorm default, which the JAX package uses

launches = LaunchCounter("apf_block")
ln_launches = LaunchCounter("layernorm")
pos_ln_launches = LaunchCounter("pos_layernorm")
attn_launches = LaunchCounter("attention")
any_launches = LaunchCounter("attention_any")

MAX_HEAD_DIM = 256  # the largest head dim csrc/attention_any.cu takes
MAX_GRID_BH = 65535  # csrc/attention_any.cu's grid is (S / 64, H, B): B and H at most this


def apf_block_weights(block) -> tuple[torch.Tensor, ...]:
    """An ``APFBlock``'s parameters as the 19-tuple of
    ``pallas_block.py:626-640`` (f32, matrices in the JAX (in, out) layout)."""
    k = lambda lin: lin.weight.detach().float().t()
    v = lambda t: t.detach().float()
    a, m, ad = block.attention, block.mlp, block.adapter
    return (
        v(block.norm1.weight), v(block.norm1.bias),
        k(a.qkv), v(a.qkv.bias), k(a.proj), v(a.proj.bias),
        v(block.norm2.weight), v(block.norm2.bias),
        k(m.fc1), v(m.fc1.bias), k(m.fc2), v(m.fc2.bias),
        v(ad.adapter_norm.weight), v(ad.adapter_norm.bias),
        k(ad.down_proj), v(ad.down_proj.bias), k(ad.up_proj), v(ad.up_proj.bias),
        v(ad.scale),
    )


# ---------------------------------------------------------------- LayerNorm


def reference_layer_norm(x, gamma, beta):
    """Plain LayerNorm with f32 statistics; the output keeps x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + LN_EPS) * gamma.float() + beta.float()).to(x.dtype)


def _float_dtype(x: torch.Tensor) -> torch.dtype:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernels take bf16 or f32, got {x.dtype}")
    return x.dtype


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis of (rows, E), bf16 or f32 (gamma and
    beta in x's dtype): kernel on CUDA, plain on CPU; the op
    ``pointvit_tpu_torch::layer_norm`` while ``torch.export`` traces."""
    if exporting():
        return _layer_norm_op(x, gamma, beta)
    if not x.is_cuda:
        return reference_layer_norm(x, gamma, beta)
    dt = _float_dtype(x)
    require(x, "x", dt, 2)
    E = x.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        require(t, name, dt, 1, x.device)
        if t.shape[0] != E:
            raise ValueError(f"{name} has {t.shape[0]} entries, E={E}")
    y = torch.empty_like(x)
    fn = kernel("block", "pv_layernorm", [PTR, PTR, PTR, PTR, INT, INT, FLOAT, INT, PTR])
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.shape[0], E,
             LN_EPS, int(dt == torch.float32), stream_ptr(x.device))
    check(err, "block", "pv_layernorm")
    ln_launches.add()
    return y


def _pos_rows(x: torch.Tensor, pos: torch.Tensor) -> int:
    if pos.dim() != 2 or pos.shape[1] != x.shape[1] or x.shape[0] % pos.shape[0]:
        raise ValueError(f"pos {tuple(pos.shape)} does not tile x {tuple(x.shape)} by rows")
    if pos.dtype != x.dtype:
        raise ValueError(f"pos is {pos.dtype}, x is {x.dtype}")
    return pos.shape[0]


def reference_pos_layer_norm(x, pos, gamma, beta):
    """Plain version of :func:`pos_layer_norm`: xp = x + pos in x.dtype, then
    LayerNorm of xp with f32 statistics. Returns (xp, LN(xp))."""
    P = _pos_rows(x, pos)
    xp = (x.reshape(-1, P, x.shape[1]) + pos).reshape(x.shape)
    return xp, reference_layer_norm(xp, gamma, beta)


def pos_layer_norm(x: torch.Tensor, pos: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """xp = x + pos, y = LN(xp) in one pass over (rows, E), bf16 or f32;
    row r adds ``pos[r % len(pos)]`` (pos is per row, or one (S, E) table
    shared by every cloud). Returns (xp, y). Kernel on CUDA, plain on CPU;
    the op ``pointvit_tpu_torch::pos_layer_norm`` while ``torch.export``
    traces."""
    P = _pos_rows(x, pos)
    if exporting():
        return _pos_layer_norm_op(x, pos, gamma, beta)
    if not x.is_cuda:
        return reference_pos_layer_norm(x, pos, gamma, beta)
    dt = _float_dtype(x)
    require(x, "x", dt, 2)
    require(pos, "pos", dt, 2, x.device)
    E = x.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        require(t, name, dt, 1, x.device)
        if t.shape[0] != E:
            raise ValueError(f"{name} has {t.shape[0]} entries, E={E}")
    xp, y = torch.empty_like(x), torch.empty_like(x)
    fn = kernel("block", "pv_pos_layernorm",
                [PTR, PTR, INT, PTR, PTR, PTR, PTR, INT, INT, FLOAT, INT, PTR])
    err = fn(x.data_ptr(), pos.data_ptr(), P, gamma.data_ptr(), beta.data_ptr(), xp.data_ptr(),
             y.data_ptr(), x.shape[0], E, LN_EPS, int(dt == torch.float32), stream_ptr(x.device))
    check(err, "block", "pv_pos_layernorm")
    pos_ln_launches.add()
    return xp, y


# ---------------------------------------------------------------- attention


def reference_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain packed-qkv MHA. qkv (B, S, 3E) → (B, S, E) in qkv.dtype; f32
    (f64 for f64 input) logits and softmax, P rounded to qkv.dtype before P·V."""
    B, S, E3 = qkv.shape
    E = E3 // 3
    D = E // num_heads
    ct = torch.promote_types(qkv.dtype, torch.float32)
    r = qkv.reshape(B, S, 3, num_heads, D).permute(2, 0, 3, 1, 4).to(ct)
    q, k, v = r[0], r[1], r[2]  # (B, H, S, D)
    logits = (q @ k.transpose(-1, -2)) * (D ** -0.5)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = (p / p.sum(dim=-1, keepdim=True)).to(qkv.dtype).to(ct)
    att = (p @ v).to(qkv.dtype)
    return att.transpose(1, 2).reshape(B, S, E)


def attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed-qkv MHA (B, S, 3E) → (B, S, E): kernel on CUDA (any S; bf16
    or f32; head dim up to 256), plain on CPU; the op
    ``pointvit_tpu_torch::attention`` while ``torch.export`` traces. The
    wgmma kernel's launches count as ``attention``, the any-head-dim
    kernel's as ``attention_any``."""
    if exporting():
        split_heads(qkv, num_heads)
        return _attention_op(qkv, num_heads)
    if not qkv.is_cuda:
        split_heads(qkv, num_heads)
        return reference_attention(qkv, num_heads)
    return launch_attention(qkv, num_heads, attn_launches)


def split_heads(qkv: torch.Tensor, num_heads: int) -> tuple[int, int, int, int]:
    """(B, S, E, D) of a packed (B, S, 3E) qkv; raises on a width that does
    not split into three times ``num_heads`` heads."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, S, 3E), got {tuple(qkv.shape)}")
    B, S, E3 = qkv.shape
    if E3 % 3 or (E3 // 3) % num_heads:
        raise ValueError(f"qkv width {E3} does not split into 3 x {num_heads} heads")
    return B, S, E3 // 3, E3 // 3 // num_heads


def attention_max_seq(head_dim: int) -> int:
    """The blocks' gate: the longest sequence the fused block chains take
    at ``head_dim`` (0: that head dim is not taken). 1024 at head dim 64,
    the JAX package's fused gate (``pallas_block.py:97-110``: S·S·4 bytes
    of logits within 4 MiB). The attention kernel itself takes any S; above
    this the APF block leaves its fused chain, as the JAX block does."""
    return 1024 if head_dim == 64 else 0


def wgmma_attention(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the attention in either direction takes the wgmma kernels
    (``csrc/attention.cu``, ``csrc/attention_bwd.cu``): bf16 at head dim
    64. Every other dtype and head dim takes ``csrc/attention_any.cu``."""
    return dtype == torch.bfloat16 and head_dim == 64


def check_any_shape(B: int, S: int, num_heads: int, D: int, what: str) -> None:
    """Raise on what ``csrc/attention_any.cu`` cannot take: a head dim past
    256, or more than 65,535 clouds or heads (its grid's y and z)."""
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the {what} take head_dim up to {MAX_HEAD_DIM}; got head_dim {D}, S {S}")
    if B > MAX_GRID_BH or num_heads > MAX_GRID_BH:
        raise ValueError(f"the {what} take at most {MAX_GRID_BH} clouds and {MAX_GRID_BH} heads; "
                         f"got {B} clouds, {num_heads} heads")


def launch_attention(qkv: torch.Tensor, num_heads: int, counter: LaunchCounter) -> torch.Tensor:
    """One attention launch on a CUDA tensor (any S): ``csrc/attention.cu``
    where :func:`wgmma_attention` holds, counted on ``counter`` (each
    caller's own name); else ``csrc/attention_any.cu`` (bf16 or f32, head
    dim 1 to 256), counted as ``attention_any``. Raises on anything else."""
    B, S, E, D = split_heads(qkv, num_heads)
    dt = _float_dtype(qkv)
    require(qkv, "qkv", dt, 3)
    out = torch.empty((B, S, E), dtype=dt, device=qkv.device)
    if wgmma_attention(dt, D):
        fn = kernel("attention", "pv_attention", [PTR, PTR, INT, INT, INT, INT, FLOAT, PTR])
        err = fn(qkv.data_ptr(), out.data_ptr(), B, S, num_heads, D, D ** -0.5,
                 stream_ptr(qkv.device))
        check(err, "attention", "pv_attention")
        counter.add()
        return out
    check_any_shape(B, S, num_heads, D, "attention kernels")
    fn = kernel("attention_any", "pv_attention_any", [PTR, PTR, INT, INT, INT, INT, FLOAT, INT, PTR])
    err = fn(qkv.data_ptr(), out.data_ptr(), B, S, num_heads, D, D ** -0.5,
             int(dt == torch.float32), stream_ptr(qkv.device))
    check(err, "attention_any", "pv_attention_any")
    any_launches.add()
    return out


# ---------------------------------------------------------------- the block


def _rounded(weights, dt):
    """The 19-tuple as the kernels see it: every array in ``dt``, the
    adapter scale folded into ``up`` in f32 first (18 arrays out)."""
    *w, wup, bup, ascale = weights
    s = ascale.reshape(()).float()
    return [t.to(dt) for t in w] + [(wup.float() * s).to(dt), (bup.float() * s).to(dt)]


def reference_apf_block(x: torch.Tensor, weights, num_heads: int,
                        launch_weights=None) -> torch.Tensor:
    """Plain torch APF block with the kernel chain's rounding points; from
    ``launch_weights`` (:func:`apf_launch_weights`, x's dtype) when
    ``weights`` is empty, as an exported program holds them: the same
    arrays, matrices seen through the same transposed strides."""
    B, S, E = x.shape
    dt = x.dtype
    rounded = _rounded(weights, dt) if len(weights) else \
        [t.t() if t.dim() == 2 else t for t in launch_weights]
    (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
     ga, ba, wdn, bdn, wup, bup) = [t.float() for t in rounded]
    rd = lambda t: t.to(dt).float()
    x2 = x.reshape(B * S, E).float()
    h = reference_layer_norm(x2, g1, b1).to(dt).float()
    qkv = rd(h @ wqkv + bqkv)
    att = reference_attention(qkv.to(dt).reshape(B, S, 3 * E), num_heads).reshape(B * S, E)
    x1 = rd(x2 + (att.float() @ wproj + bproj))
    h = rd(reference_layer_norm(x1, g2, b2))
    h = rd(F.gelu(h @ wfc1 + bfc1, approximate="none"))
    mlp = h @ wfc2 + bfc2
    a = rd(reference_layer_norm(x1, ga, ba))
    a = rd(torch.relu(a @ wdn + bdn))
    a = a @ wup + bup
    return (mlp + a + 2.0 * x1).to(dt).reshape(B, S, E)


def apf_block_shapes_ok(S: int, E: int, num_heads: int) -> bool:
    """Whether the APF block takes its fused chain at this shape: head dim
    64 and S ≤ :func:`attention_max_seq` (1024), inside the JAX package's
    gate ``fused_block_shapes_ok``. Elsewhere ``APFBlock`` runs its unfused
    forward, whose attention kernel takes any S."""
    return E % num_heads == 0 and 0 < S <= attention_max_seq(E // num_heads)


def fused_apf_block(x: torch.Tensor, weights, num_heads: int, launch_weights=None) -> torch.Tensor:
    """Whole APF block at inference, x (B, S, E) → (B, S, E). ``weights`` is
    the 19-tuple of :func:`apf_block_weights`. The kernel chain for a CUDA
    tensor (bf16 or f32), the plain version for a CPU tensor.
    ``launch_weights``: :func:`apf_launch_weights` of ``weights`` for x's
    dtype and device, where the caller keeps them (``APFBlock`` does); made
    here otherwise. ``weights`` may be empty when ``launch_weights`` are
    given (an exported program bakes those alone). While ``torch.export``
    traces: the op ``pointvit_tpu_torch::apf_block``, which the traced
    program then calls with the weights it holds."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, E), got {tuple(x.shape)}")
    B, S, E = x.shape
    if E % num_heads:
        raise ValueError(f"E={E} is not a multiple of num_heads={num_heads}")
    if exporting():
        if x.is_cuda:
            _float_dtype(x)
        return _apf_block_op(x, list(weights), num_heads, list(launch_weights or ()))
    if not x.is_cuda:
        return reference_apf_block(x, weights, num_heads, launch_weights)
    _float_dtype(x)
    out = launch_chain(x, weights, num_heads, launch_weights)
    launches.add()
    return out


def apf_launch_weights(weights, dtype: torch.dtype, device) -> tuple[torch.Tensor, ...]:
    """The 19-tuple as the chain launches it: 18 contiguous arrays on
    ``device`` in ``dtype``, the adapter scale folded into ``up``, matrices
    in ``nn.Linear``'s (out, in) layout."""
    return tuple(t.to(device).t().contiguous() if t.dim() == 2 else t.to(device).contiguous()
                 for t in _rounded(weights, dtype))


def launch_chain(x: torch.Tensor, weights, num_heads: int, launch_weights=None) -> torch.Tensor:
    """The block as its chain of LayerNorm, GEMM and attention calls (on a
    CPU tensor each call takes its plain version, which the tests use)."""
    B, S, E = x.shape
    dt = x.dtype
    if launch_weights is None:
        launch_weights = apf_launch_weights(weights, dt, x.device)
    (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
     ga, ba, wdn, bdn, wup, bup) = launch_weights
    x2 = x.reshape(B * S, E).contiguous()
    h = layer_norm(x2, g1, b1)
    qkv, _ = gemm(h, wqkv, bqkv, out_dtype=dt)
    att = attention(qkv.reshape(B, S, 3 * E), num_heads).reshape(B * S, E)
    x1, _ = gemm(att, wproj, bproj, res=x2, out_dtype=dt)
    h = layer_norm(x1, g2, b2)
    a = layer_norm(x1, ga, ba)
    h, _ = gemm(h, wfc1, bfc1, act="gelu", out_dtype=dt)
    a, _ = gemm(a, wdn, bdn, act="relu", out_dtype=dt)
    t, _ = gemm(a, wup, bup, res=x1, res_scale=2.0, out_dtype=torch.float32)
    out, _ = gemm(h, wfc2, bfc2, res=t, out_dtype=dt)
    return out.reshape(B, S, E)


@kernel_op("layer_norm", lambda x, gamma, beta: x.new_empty(x.shape))
def _layer_norm_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, gamma, beta)


@kernel_op("pos_layer_norm", lambda x, pos, gamma, beta: (x.new_empty(x.shape), x.new_empty(x.shape)))
def _pos_layer_norm_op(x: torch.Tensor, pos: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return pos_layer_norm(x, pos, gamma, beta)


def _attention_fake(qkv, num_heads):
    B, S, E3 = qkv.shape
    return qkv.new_empty((B, S, E3 // 3))


@kernel_op("attention", _attention_fake)
def _attention_op(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    return attention(qkv, num_heads)


@kernel_op("apf_block", lambda x, weights, num_heads, launch_weights: x.new_empty(x.shape))
def _apf_block_op(x: torch.Tensor, weights: list[torch.Tensor], num_heads: int,
                  launch_weights: list[torch.Tensor]) -> torch.Tensor:
    """:func:`fused_apf_block` as an op; ``launch_weights`` empty: made from
    ``weights`` (the 19-tuple)."""
    return fused_apf_block(x, weights, num_heads, launch_weights or None)
