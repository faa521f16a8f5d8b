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

f32 operands (the f32 models) take the f32 instance of ``csrc/gemm.cu``
(CUDA cores, full f32 products, counted as ``gemm_f32``): every operand and
output, ``pre_out`` and the group max then f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import (
    FLOAT, INT, PTR, LaunchCounter, check, kernel, require, stream_ptr,
)

__all__ = ["gemm", "gemm_instance", "reference_gemm", "INSTANCES", "launches", "f32_launches",
           "pingpong_launches"]

launches = LaunchCounter("gemm")
f32_launches = LaunchCounter("gemm_f32")
pingpong_launches = LaunchCounter("gemm_pingpong")

# The bf16 kernel's instances (csrc/gemm.cu) and their codes in pv_gemm.
INSTANCES = {"128x64": 64, "128x128": 128, "128x256": 256, "pingpong": 1}

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


def gemm_instance(M: int, N: int, K: int, *, act="none", res=None, group=0, pre_out=None) -> str:
    """The bf16 instance that :func:`gemm` launches for a product, by its
    shape and epilogue (measured on the card: ``chip_smoke.py``'s GEMM
    phase times every instance that can take each product). An epilogue is
    heavy with a pre output, GELU, or a residual below K = 2048: the
    ping-pong instance hides it behind the other consumer's main loop. A
    light one takes the persistent 128 x 256 tile where N fills its tiles
    (N % 256 == 0), the ping-pong instance otherwise. The group max has no
    ping-pong form: 128 x 256 when light, else 128 x 128; N <= 64 takes 128
    x 64, and N % 8 != 0 (no TMA store) or K < 256 (one or few K steps,
    where the two-block tile wins) 128 x 128."""
    if N <= 64:
        return "128x64"
    if N % 8 or K < 256:
        return "128x128"
    heavy = pre_out is not None or act == "gelu" or (res is not None and K < 2048)
    if group:
        return "128x128" if heavy else "128x256"
    if heavy or N % 256:
        return "pingpong"
    return "128x256"


def gemm(a, w, bias=None, *, act="none", res=None, res_scale=1.0, res_div=1,
         out_dtype=torch.bfloat16, group=0, pre_out=None, instance=None):
    """Fused GEMM; returns ``(out, gmax)``, either None when not asked for,
    and writes ``pre_out`` when it is given.

    The CUDA kernel takes bf16 ``a``/``w``/``bias``, a bf16 or f32 ``res``,
    K % 8 == 0, a ``group`` that divides 128 and M, and a bf16 (M, N)
    ``pre_out`` beside an ``out``; or f32 throughout (K % 4 == 0), the f32
    instance. CPU tensors take the plain version. ``instance`` (bf16 only):
    None launches :func:`gemm_instance`'s pick; a name of
    :data:`INSTANCES` forces one (the card tests and ``chip_smoke.py``
    compare them).
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
    if a.dtype == torch.float32:
        return _gemm_f32(a, w, bias, act, res, res_scale, res_div, out_dtype, group, pre_out)
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
    if instance is None:
        instance = gemm_instance(M, N, K, act=act, res=res, group=group, pre_out=pre_out)
    if instance not in INSTANCES:
        raise ValueError(f"unknown instance {instance!r}; expected one of {sorted(INSTANCES)}")
    if instance in ("128x256", "pingpong") and N % 8:
        raise ValueError(f"the {instance} instance stores by TMA: it needs N % 8 == 0, got N={N}")
    if (instance == "128x256" and pre_out is not None) or (instance == "pingpong" and group):
        raise ValueError(f"the {instance} instance has no {'pre output' if group == 0 else 'group max'}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev) if out_dtype is not None else None
    gmax = torch.empty((M // group, N), dtype=torch.bfloat16, device=dev) if group else None
    fn = kernel("gemm", "pv_gemm", [
        PTR, PTR, PTR,                           # A, W, bias
        PTR, INT, INT, FLOAT,                    # res, res_div, res_f32, res_scale
        PTR, INT, PTR, PTR, INT,                 # out, out_f32, pre, gmax, group
        INT, INT, INT, INT, INT, PTR,            # M, N, K, act, instance, stream
    ])
    err = fn(
        a.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        res.data_ptr() if res is not None else None, res_div,
        int(res is not None and res.dtype == torch.float32), float(res_scale),
        out.data_ptr() if out is not None else None, int(out_dtype == torch.float32),
        pre_out.data_ptr() if pre_out is not None else None,
        gmax.data_ptr() if gmax is not None else None, group,
        M, N, K, _ACTS[act], INSTANCES[instance], stream_ptr(dev),
    )
    check(err, "gemm", "pv_gemm")
    launches.add()
    if instance == "pingpong":
        pingpong_launches.add()
    return out, gmax


def _gemm_f32(a, w, bias, act, res, res_scale, res_div, out_dtype, group, pre_out):
    """The f32 instance: every tensor f32, out f32 or None, gmax f32."""
    f32, dev = torch.float32, a.device
    require(a, "a", f32, 2)
    require(w, "w", f32, 2, dev)
    M, K = a.shape
    N = w.shape[0]
    if w.shape[1] != K:
        raise ValueError(f"a is (M, {K}) but w is {tuple(w.shape)}")
    if K % 4:
        raise ValueError(f"the f32 GEMM kernel needs K % 4 == 0, got K={K}")
    if bias is not None:
        require(bias, "bias", f32, 1, dev)
        if bias.shape[0] != N:
            raise ValueError(f"bias has {bias.shape[0]} entries, N={N}")
    if res is not None:
        require(res, "res", f32, 2, dev)
        if M % res_div or res.shape != (M // res_div, N):
            raise ValueError(f"res {tuple(res.shape)} does not fit ({M} // {res_div}, {N})")
    if group and (_TILE_M % group or M % group):
        raise ValueError(f"group={group} must divide {_TILE_M} and M={M}")
    if out_dtype not in (None, f32):
        raise ValueError(f"f32 operands give an f32 out or none, not {out_dtype}")
    if pre_out is not None:
        require(pre_out, "pre_out", f32, 2, dev)
        if pre_out.shape != (M, N):
            raise ValueError(f"pre_out {tuple(pre_out.shape)} is not ({M}, {N})")
    out = torch.empty((M, N), dtype=f32, device=dev) if out_dtype is not None else None
    gmax = torch.empty((M // group, N), dtype=f32, device=dev) if group else None
    fn = kernel("gemm", "pv_gemm_f32", [
        PTR, PTR, PTR, PTR, INT, FLOAT,          # A, W, bias, res, res_div, res_scale
        PTR, PTR, PTR, INT,                      # out, pre, gmax, group
        INT, INT, INT, INT, PTR,                 # M, N, K, act, stream
    ])
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = fn(a.data_ptr(), w.data_ptr(), ptr(bias), ptr(res), res_div, float(res_scale),
             ptr(out), ptr(pre_out), ptr(gmax), group, M, N, K, _ACTS[act], stream_ptr(dev))
    check(err, "gemm", "pv_gemm_f32")
    f32_launches.add()
    return out, gmax
