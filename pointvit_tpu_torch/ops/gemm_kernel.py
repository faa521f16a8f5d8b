"""bf16 GEMM with a fused epilogue (``csrc/gemm.cu``): wrapper, launch
counter and plain version.

The product engine of the encoder, P3-stage and block kernel chains
(:mod:`~pointvit_tpu_torch.ops.encoder_kernel`,
:mod:`~pointvit_tpu_torch.ops.p3_kernel`,
:mod:`~pointvit_tpu_torch.ops.block_kernel`,
:mod:`~pointvit_tpu_torch.ops.vit_block_kernel`,
:mod:`~pointvit_tpu_torch.ops.serial_block_kernel`). It computes, with f32
accumulation and one rounding per output::

    v = a @ w.T (+ bias)
    pre_out[...] = v.to(bf16)                 # if pre_out is given
    v = v (+ res_scale * res[row // res_div]);  v = act(v)
    out = v.to(out_dtype)                     # if out_dtype is not None
    gmax = max of v over each group of rows   # if group, bf16

``a`` is (M, K) and ``w`` is (N, K), the layout of ``torch.nn.Linear``.
``pre_out`` is a second output that the caller allocates: one launch then
gives a branch rounded to bf16 and the f32 sum of the branch and its
residual, which the serial-adapter block needs from its proj and fc2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import (
    FLOAT, INT, PTR, LaunchCounter, check, kernel, require, stream_ptr,
)

__all__ = ["gemm", "reference_gemm", "launches"]

launches = LaunchCounter("gemm")

_ACTS = {"none": 0, "relu": 1, "gelu": 2}
_TILE_M = 128  # csrc/gemm.cu BM: a row group must not straddle an output tile


def _activate(v: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(v)
    if act == "gelu":
        return F.gelu(v, approximate="none")
    return v


def reference_gemm(a, w, bias=None, *, act="none", res=None, res_scale=1.0, res_div=1,
                   out_dtype=torch.bfloat16, group=0, pre_out=None):
    """Plain torch version of :func:`gemm`: f32 products of the given
    operands; ``gmax`` comes out in ``a``'s dtype (the kernel's is bf16),
    ``pre_out`` is written in its own dtype."""
    v = a.float() @ w.float().t()
    if bias is not None:
        v = v + bias.float()
    if pre_out is not None:
        pre_out.copy_(v)
    if res is not None:
        r = res.float()
        if res_div > 1:
            r = r.repeat_interleave(res_div, dim=0)
        v = v + res_scale * r
    v = _activate(v, act)
    out = v.to(out_dtype) if out_dtype is not None else None
    gmax = None
    if group:
        gmax = v.reshape(-1, group, v.shape[-1]).amax(dim=1).to(a.dtype)
    return out, gmax


def gemm(a, w, bias=None, *, act="none", res=None, res_scale=1.0, res_div=1,
         out_dtype=torch.bfloat16, group=0, pre_out=None):
    """Fused GEMM; returns ``(out, gmax)``, either None when not asked for,
    and writes ``pre_out`` when it is given.

    The CUDA kernel takes bf16 ``a``/``w``/``bias``, a bf16 or f32 ``res``,
    K % 8 == 0, a ``group`` that divides 128 and M, and a bf16 (M, N)
    ``pre_out`` beside an ``out``. CPU tensors take the plain version.
    """
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    if out_dtype is None and not group:
        raise ValueError("nothing to compute: out_dtype is None and group is 0")
    if pre_out is not None and out_dtype is None:
        raise ValueError("pre_out is written beside out: out_dtype must not be None")
    if not a.is_cuda:
        return reference_gemm(a, w, bias, act=act, res=res, res_scale=res_scale,
                              res_div=res_div, out_dtype=out_dtype, group=group,
                              pre_out=pre_out)
    dev = a.device
    require(a, "a", torch.bfloat16, 2)
    require(w, "w", torch.bfloat16, 2, dev)
    M, K = a.shape
    N = w.shape[0]
    if w.shape[1] != K:
        raise ValueError(f"a is (M, {K}) but w is {tuple(w.shape)}")
    if K % 8:
        raise ValueError(f"the GEMM kernel needs K % 8 == 0, got K={K}")
    if bias is not None:
        require(bias, "bias", torch.bfloat16, 1, dev)
        if bias.shape[0] != N:
            raise ValueError(f"bias has {bias.shape[0]} entries, N={N}")
    if res is not None:
        if res.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"res must be bf16 or f32, got {res.dtype}")
        require(res, "res", res.dtype, 2, dev)
        if M % res_div or res.shape != (M // res_div, N):
            raise ValueError(f"res {tuple(res.shape)} does not fit ({M} // {res_div}, {N})")
    if group and (_TILE_M % group or M % group):
        raise ValueError(f"group={group} must divide {_TILE_M} and M={M}")
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16, f32 or None, got {out_dtype}")
    if pre_out is not None:
        require(pre_out, "pre_out", torch.bfloat16, 2, dev)
        if pre_out.shape != (M, N):
            raise ValueError(f"pre_out {tuple(pre_out.shape)} is not ({M}, {N})")
    out = torch.empty((M, N), dtype=out_dtype, device=dev) if out_dtype is not None else None
    gmax = torch.empty((M // group, N), dtype=torch.bfloat16, device=dev) if group else None
    fn = kernel("gemm", "pv_gemm", [
        PTR, PTR, PTR,                           # A, W, bias
        PTR, INT, INT, FLOAT,                    # res, res_div, res_f32, res_scale
        PTR, INT, PTR, PTR, INT,                 # out, out_f32, pre, gmax, group
        INT, INT, INT, INT, PTR,                 # M, N, K, act, stream
    ])
    err = fn(
        a.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        res.data_ptr() if res is not None else None, res_div,
        int(res is not None and res.dtype == torch.float32), float(res_scale),
        out.data_ptr() if out is not None else None, int(out_dtype == torch.float32),
        pre_out.data_ptr() if pre_out is not None else None,
        gmax.data_ptr() if gmax is not None else None, group,
        M, N, K, _ACTS[act], stream_ptr(dev),
    )
    check(err, "gemm", "pv_gemm")
    launches.add()
    return out, gmax
