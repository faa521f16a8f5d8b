"""Dynamic w8a8 int8 dense (``csrc/quant.cu``): weight quantizer, wrapper,
launch counter and plain version.

Counterpart of ``pointvit_tpu/ops/pallas_quant.py`` (``_quant_dense_2d``,
``quant_dense``, ``quantize_weight``) with the numerics of
``pointvit_tpu/nn/quant.py::dynamic_quant_matmul`` + bias + cast. With x
(M, K) and W (N, K), the layout of ``torch.nn.Linear.weight``::

    sw[n] = max(amax_k |W[n, k]| / 127, 1e-8);  wq = round(W / sw)   (once per weight)
    sx[m] = max(amax_k |x[m, k]| / 127, 1e-8);  xq = round(x / sx)   (per call)
    acc   = Σ_k xq·wq in int32                                        (exact)
    y     = fl(fl(float(acc) · fl(sx·sw)) + b), rounded to out_dtype

Every step is exact or rounded once, in this order: divisions are IEEE
divisions (a division by a Python scalar would run as a product with its
reciprocal on CUDA, so the divisor is a tensor), rounding is half to even,
and the plain version's int product runs in float64, which is exact here
(|acc| ≤ 127²·K < 2⁵³). So the kernel is bit-equal to
:func:`reference_quant_dense`, and that is bit-equal to the JAX
``dynamic_quant_matmul``. The Pallas kernel itself computes ``amax / 127``
as ``amax · (1/127)`` in interpret mode, which moves some row scales by one
ulp; it is held at the JAX package's own tolerance instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointvit_tpu_torch._build import INT, PTR, LaunchCounter, check, kernel, require, stream_ptr

__all__ = ["quantize_weight", "quant_dense", "reference_quant_dense", "quantize_rows",
           "launch_quantize_rows", "launches"]

launches = LaunchCounter("quant_dense")

_EPS = 1e-8
_K_ALIGN = 16  # bytes: the row stride a TMA tensor map takes is a multiple of 16
_PLAIN_ROWS = 1 << 16  # rows per float64 product in the plain version


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-8) with an IEEE division (the divisor is a tensor)."""
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), _EPS)


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: W (N, K) → (wq (N, K) int8, sw (N,) f32)."""
    w = weight.detach().float()
    sw = _scale(w.abs().amax(dim=1))
    return torch.round(w / sw[:, None]).to(torch.int8), sw


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 of x (M, K): (xq (M, K) int8, sx (M,) f32)."""
    xf = x.float()
    sx = _scale(xf.abs().amax(dim=1))
    return torch.round(xf / sx[:, None]).to(torch.int8), sx


def _check_operands(x, wq, sw, bias):
    K = x.shape[-1]
    if wq.dim() != 2 or wq.shape[1] != K:
        raise ValueError(f"x is (..., {K}) but wq is {tuple(wq.shape)}")
    N = wq.shape[0]
    if sw.shape != (N,) or (bias is not None and bias.shape != (N,)):
        raise ValueError(f"sw {tuple(sw.shape)} and bias {None if bias is None else tuple(bias.shape)}"
                         f" must be ({N},)")
    return K, N


def reference_quant_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                          bias: torch.Tensor | None = None, out_dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """Plain torch version of :func:`quant_dense`, in row chunks (the float64
    operands of a whole encoder layer would take gigabytes)."""
    K, N = _check_operands(x, wq, sw, bias)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    out = torch.empty((x2.shape[0], N), dtype=out_dtype or x.dtype, device=x.device)
    w64, sw = wq.double().t(), sw.float()
    for i in range(0, x2.shape[0], _PLAIN_ROWS):
        xq, sx = quantize_rows(x2[i : i + _PLAIN_ROWS])
        y = (xq.double() @ w64).float() * (sx[:, None] * sw)
        if bias is not None:
            y = y + bias.float()
        out[i : i + _PLAIN_ROWS] = y.to(out.dtype)
    return out.reshape(*lead, N)


def quant_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                bias: torch.Tensor | None = None, out_dtype: torch.dtype | None = None
                ) -> torch.Tensor:
    """Dynamic w8a8 dense ``x @ W.T + bias`` from a weight quantized by
    :func:`quantize_weight`: x (..., K) → (..., N) in ``out_dtype`` (None:
    x's dtype).

    A CPU tensor takes the plain version. A CUDA tensor launches the two
    kernels of ``csrc/quant.cu`` (row quantizer, int8 GEMM with the dequant
    epilogue): x bf16 or f32, wq int8 (N, K), sw and bias f32 (N,), all
    contiguous on one card, out_dtype bf16 or f32; anything else raises.
    Any K: for K % 16 != 0 the quantized rows are written K rounded up to 16
    with zero bytes and the GEMM reads the weight padded with zero columns,
    which add nothing to the int32 sum.
    """
    K, N = _check_operands(x, wq, sw, bias)
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return reference_quant_dense(x, wq, sw, bias, out_dtype)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    dev = x.device
    require(x2, "x", x.dtype, 2)
    require(wq, "wq", torch.int8, 2, dev)
    require(sw, "sw", torch.float32, 1, dev)
    if bias is not None:
        require(bias, "bias", torch.float32, 1, dev)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out.reshape(*lead, N)
    xq, sx = launch_quantize_rows(x2)
    Kp = xq.shape[1]
    if Kp != K:
        wq = F.pad(wq, (0, Kp - K))
    gemm = kernel("quant", "pv_quant_gemm",
                  [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR])
    check(gemm(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
               bias.data_ptr() if bias is not None else None, out.data_ptr(),
               int(out_dtype == torch.float32), M, N, Kp, stream_ptr(dev)), "quant", "pv_quant_gemm")
    launches.add()
    return out.reshape(*lead, N)


def launch_quantize_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first launch of :func:`quant_dense` alone, uncounted: x2 (M, K)
    bf16 or f32 on the card → (xq (M, Kp) int8 with Kp = K rounded up to 16
    and zero bytes past K, sx (M,) f32), as :func:`quantize_rows` gives
    them."""
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x2.dtype}")
    require(x2, "x", x2.dtype, 2)
    M, K = x2.shape
    Kp = -(-K // _K_ALIGN) * _K_ALIGN
    xq = torch.empty((M, Kp), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x2.device)
    rows = kernel("quant", "pv_quantize_rows", [PTR, INT, PTR, PTR, INT, INT, INT, PTR])
    check(rows(x2.data_ptr(), int(x2.dtype == torch.float32), xq.data_ptr(), sx.data_ptr(), M, K,
               Kp, stream_ptr(x2.device)), "quant", "pv_quantize_rows")
    return xq, sx
