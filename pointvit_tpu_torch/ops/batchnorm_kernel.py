"""Train-mode BatchNorm followed by ReLU over the last axis, as one
differentiable op with hand-written kernels in both directions
(``csrc/batchnorm.cu``), each with its plain version.

It replaces no TPU kernel: the JAX package leaves train-mode BatchNorm to
XLA, which fuses it. Here it is the training path's ``relu(batch_norm(h))``
(:func:`~pointvit_tpu_torch.nn.layers.batch_norm_relu`) in four passes over
an (R, C) activation h in place of a chain of f32 casts, reductions and
elementwise ops::

    bn_stats           h                        → (2, C) f64: Σh, Σh²        two launches
    bn_relu            h, those sums, γ, β      → y = relu((h − mean)·s + β), coef
    bn_relu_bwd_stats  dy, h, coef              → (2, C) f64: Σg, Σg·x̂       two launches
    bn_relu_bwd        dy, h, coef, those sums  → dx = s·g − a − (h − mean)·b

with g = dy·[(h − mean)·s + β > 0] and x̂ = (h − mean)·rstd. Each apply
derives its per-column coefficients from the sums with flax's conventions,
as :func:`~pointvit_tpu_torch.nn.layers.batch_norm` does: mean = Σh/n,
biased var = max(Σh²/n − mean², 0), rstd = 1/sqrt(var + eps), s = γ·rstd;
a = s·Σg/n and b = s·rstd·Σg·x̂/n, with b = 0 where the clamp held var at 0,
as autograd gives through ``torch.clamp``. ``bn_relu`` also returns coef,
(6, C) f32 rows mean, s, β, rstd, var and live (1 where var was not
clamped), which the backward and the running statistics read.

Both reductions sum in f64, kernels and plain versions alike, and the sums
are rounded to f32 once, after any all-reduce over the data group: the sums
of bf16 (or f32) values and their products are all but exact in f64, so the
f32 values depend neither on the order nor on how the rows are spread over
ranks, and the kernel path, the plain path and one process over the whole
batch agree. (With f32 sums two summation orders alone moved the gradient
of a weight before a BatchNorm, a sum that nearly cancels, by ~25 % in a
bf16 training step.) Inside a data-parallel step both pairs of sums are
summed over the data group (n is then the global batch's rows), so the
statistics and x's gradient are the global batch's, as SyncBatchNorm
computes them; γ's and β's gradients stay this rank's sums, which the
step's gradient sync adds up. The backward saves h and the (6, C)
coefficients only: no f32 copy of the activation.

A CUDA tensor launches the kernels (bf16 or f32, C a multiple of 8, γ and
β f32) and raises on anything else; a CPU tensor takes the plain versions,
which run the same per-column arithmetic op by op, rounding where the
kernels do (any float dtype: f64 for ``gradcheck``), so the kernels give
their bits.
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch._build import (
    DOUBLE, FLOAT, INT, PTR, LaunchCounter, check, exporting, kernel, kernel_op, require, stream_ptr,
)
from pointvit_tpu_torch.parallel.comm import all_reduce_sum

__all__ = [
    "COEF_ROWS",
    "WIDTH_MULTIPLE",
    "bn_relu",
    "bn_relu_bwd",
    "bn_relu_bwd_stats",
    "bn_stats",
    "reference_bn_relu",
    "reference_bn_relu_bwd",
    "reference_bn_relu_bwd_stats",
    "reference_bn_stats",
    "train_batch_norm_relu",
    "stats_launches",
    "relu_launches",
    "bwd_stats_launches",
    "bwd_launches",
]

WIDTH_MULTIPLE = 8  # the kernels' vectors: 16 bytes of bf16
COEF_ROWS = 6  # bn_relu's coef: mean, s, β, rstd, var, live

stats_launches = LaunchCounter("bn_stats")
relu_launches = LaunchCounter("bn_relu")
bwd_stats_launches = LaunchCounter("bn_relu_bwd_stats")
bwd_launches = LaunchCounter("bn_relu_bwd")

_partial_rows: dict[int, int] = {}  # device index → pv_bn_partial_rows


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _centred(h: torch.Tensor, coef: torch.Tensor):
    """h − mean and the pre-activation (h − mean)·s + β, op by op."""
    d = h.to(coef.dtype) - coef[0]
    return d, d * coef[1] + coef[2]


def reference_bn_stats(h: torch.Tensor) -> torch.Tensor:
    """Plain (R, C) → (2, C) f64: Σh and Σh² per column."""
    hd = h.double()
    return torch.stack([hd.sum(0), (hd * hd).sum(0)])


def _coefficients(sums, n, weight, bias, eps, dtype):
    """(6, C): mean, s, β, rstd, var, live from (Σh, Σh²) over n rows."""
    mean, mean_sq = (sums / n).to(dtype)
    raw = mean_sq - mean * mean
    var = torch.clamp(raw, min=0.0)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    return torch.stack([mean, rstd * weight, bias.to(dtype), rstd, var, (raw >= 0).to(dtype)])


def reference_bn_relu(h, sums, n: float, weight, bias, eps: float):
    """Plain (y, coef): y = relu((h − mean)·s + β) in h's dtype, coef the
    (6, C) coefficients from ``sums`` (Σh, Σh² over n rows)."""
    coef = _coefficients(sums, n, weight, bias, eps, _compute_dtype(h))
    return torch.relu(_centred(h, coef)[1]).to(h.dtype), coef


def reference_bn_relu_bwd_stats(dy: torch.Tensor, h: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Plain (2, C) f64: Σg and Σg·x̂ (x̂ in coef's dtype)."""
    d, pre = _centred(h, coef)
    g = torch.where(pre > 0, dy.to(coef.dtype), 0.0).double()
    return torch.stack([g.sum(0), (g * (d * coef[3]).double()).sum(0)])


def reference_bn_relu_bwd(dy, h, coef, sums, n: float):
    """Plain dx = s·g − a − (h − mean)·b in h's dtype, a and b from
    ``sums`` (Σg, Σg·x̂ over n rows) and coef."""
    mean_g, mean_gx = (sums / n).to(coef.dtype)
    a = coef[1] * mean_g
    b = torch.where(coef[5] > 0, coef[1] * coef[3] * mean_gx, 0.0)
    d, pre = _centred(h, coef)
    g = torch.where(pre > 0, dy.to(coef.dtype), 0.0)
    return (coef[1] * g - a - d * b).to(h.dtype)


def _check(h: torch.Tensor, dy: torch.Tensor | None = None, coef: torch.Tensor | None = None,
           sums: torch.Tensor | None = None, affine=()):
    """Raise unless the kernels take these operands; returns h's dtype."""
    dt = h.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the BatchNorm kernels take bf16 or f32, got {dt}")
    require(h, "h", dt, 2)
    C = h.shape[1]
    if C % WIDTH_MULTIPLE or h.shape[0] < 1:
        raise ValueError(f"the BatchNorm kernels take a width that is a multiple of "
                         f"{WIDTH_MULTIPLE} and at least one row, got {tuple(h.shape)}")
    if dy is not None:
        require(dy, "dy", dt, 2, h.device)
        if dy.shape != h.shape:
            raise ValueError(f"dy {tuple(dy.shape)} is not h's shape {tuple(h.shape)}")
    for name, t, dtype, shape in (("coef", coef, torch.float32, (COEF_ROWS, C)),
                                  ("sums", sums, torch.float64, (2, C)),
                                  *((nm, a, torch.float32, (C,)) for nm, a in affine)):
        if t is not None:
            require(t, name, dtype, len(shape), h.device)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return dt


def _partials(h: torch.Tensor) -> torch.Tensor:
    """Scratch for a reduction's per-block sums: (2, rows, C) f64, as many
    rows as the kernels' grid ever takes on h's device (asked of
    ``csrc/batchnorm.cu`` once a device; a launch writes only its blocks')."""
    idx = h.device.index
    if idx not in _partial_rows:
        rows = kernel("batchnorm", "pv_bn_partial_rows", [INT])(idx)
        check(max(-rows, 0), "batchnorm", "pv_bn_partial_rows")
        _partial_rows[idx] = rows
    return torch.empty((2, _partial_rows[idx], h.shape[1]), dtype=torch.float64, device=h.device)


def bn_stats(h: torch.Tensor) -> torch.Tensor:
    """(R, C) → (2, C) f64: Σh and Σh² per column. Kernel on CUDA (bf16 or
    f32, C a multiple of 8), plain on CPU; the op
    ``pointvit_tpu_torch::bn_stats`` while ``torch.export`` traces."""
    if exporting():
        return _bn_stats_op(h)
    if not h.is_cuda:
        return reference_bn_stats(h)
    dt = _check(h)
    partial = _partials(h)
    out = torch.empty((2, h.shape[1]), dtype=torch.float64, device=h.device)
    fn = kernel("batchnorm", "pv_bn_stats", [PTR, PTR, PTR, INT, INT, INT, INT, PTR])
    err = fn(h.data_ptr(), partial.data_ptr(), out.data_ptr(), h.shape[0], h.shape[1],
             partial.shape[1], int(dt == torch.float32), stream_ptr(h.device))
    check(err, "batchnorm", "pv_bn_stats")
    stats_launches.add()
    return out


def bn_relu(h: torch.Tensor, sums: torch.Tensor, n: float, weight: torch.Tensor,
            bias: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, coef): y = relu((h − mean)·s + β) over (R, C) in h's dtype, coef
    (6, C) f32, from ``sums`` (2, C) f64 (Σh, Σh² over n rows), γ, β (C,)
    f32 and eps. Kernel on CUDA, plain on CPU; the op
    ``pointvit_tpu_torch::bn_relu`` while ``torch.export`` traces."""
    if exporting():
        return _bn_relu_op(h, sums, n, weight, bias, eps)
    if not h.is_cuda:
        return reference_bn_relu(h, sums, n, weight, bias, eps)
    dt = _check(h, sums=sums, affine=(("weight", weight), ("bias", bias)))
    y = torch.empty_like(h)
    coef = torch.empty((COEF_ROWS, h.shape[1]), dtype=torch.float32, device=h.device)
    fn = kernel("batchnorm", "pv_bn_relu", [PTR, PTR, DOUBLE, PTR, PTR, FLOAT, PTR, PTR, INT, INT, INT, PTR])
    err = fn(h.data_ptr(), sums.data_ptr(), n, weight.data_ptr(), bias.data_ptr(), eps, coef.data_ptr(),
             y.data_ptr(), h.shape[0], h.shape[1], int(dt == torch.float32), stream_ptr(h.device))
    check(err, "batchnorm", "pv_bn_relu")
    relu_launches.add()
    return y, coef


def bn_relu_bwd_stats(dy: torch.Tensor, h: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """(2, C) f64: Σg and Σg·x̂ over (R, C) dy and h (one dtype); coef is
    :func:`bn_relu`'s. Kernel on CUDA, plain on CPU; the op
    ``pointvit_tpu_torch::bn_relu_bwd_stats`` while ``torch.export``
    traces."""
    if exporting():
        return _bn_relu_bwd_stats_op(dy, h, coef)
    if not h.is_cuda:
        return reference_bn_relu_bwd_stats(dy, h, coef)
    dt = _check(h, dy, coef)
    partial = _partials(h)
    out = torch.empty((2, h.shape[1]), dtype=torch.float64, device=h.device)
    fn = kernel("batchnorm", "pv_bn_relu_bwd_stats", [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR])
    err = fn(dy.data_ptr(), h.data_ptr(), coef.data_ptr(), partial.data_ptr(), out.data_ptr(),
             h.shape[0], h.shape[1], partial.shape[1], int(dt == torch.float32), stream_ptr(h.device))
    check(err, "batchnorm", "pv_bn_relu_bwd_stats")
    bwd_stats_launches.add()
    return out


def bn_relu_bwd(dy: torch.Tensor, h: torch.Tensor, coef: torch.Tensor, sums: torch.Tensor,
                n: float) -> torch.Tensor:
    """dx = s·g − a − (h − mean)·b over (R, C) in h's dtype, from
    :func:`bn_relu`'s coef and ``sums`` (2, C) f64 (Σg, Σg·x̂ over n rows).
    Kernel on CUDA, plain on CPU; the op ``pointvit_tpu_torch::bn_relu_bwd``
    while ``torch.export`` traces."""
    if exporting():
        return _bn_relu_bwd_op(dy, h, coef, sums, n)
    if not h.is_cuda:
        return reference_bn_relu_bwd(dy, h, coef, sums, n)
    dt = _check(h, dy, coef, sums)
    dx = torch.empty_like(h)
    fn = kernel("batchnorm", "pv_bn_relu_bwd", [PTR, PTR, PTR, PTR, DOUBLE, PTR, INT, INT, INT, PTR])
    err = fn(dy.data_ptr(), h.data_ptr(), coef.data_ptr(), sums.data_ptr(), n, dx.data_ptr(),
             h.shape[0], h.shape[1], int(dt == torch.float32), stream_ptr(h.device))
    check(err, "batchnorm", "pv_bn_relu_bwd")
    bwd_launches.add()
    return dx


class _TrainBatchNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, world, plain):
        h = x.reshape(-1, x.shape[-1])
        n = float(h.shape[0] * world)
        sums = all_reduce_sum((reference_bn_stats if plain else bn_stats)(h), group)
        y, coef = (reference_bn_relu if plain else bn_relu)(h, sums, n, weight, bias, eps)
        ctx.save_for_backward(h, coef)
        ctx.shape, ctx.n, ctx.group, ctx.plain = x.shape, n, group, plain
        ctx.weight_dtype = weight.dtype
        ctx.mark_non_differentiable(coef)
        return y.reshape(x.shape), coef

    @staticmethod
    def backward(ctx, dy, _dcoef):
        h, coef = ctx.saved_tensors
        dy = dy.reshape(h.shape).to(h.dtype).contiguous()
        sums = (reference_bn_relu_bwd_stats if ctx.plain else bn_relu_bwd_stats)(dy, h, coef)
        dbeta, dgamma = sums.to(ctx.weight_dtype)  # this rank's own
        sums = all_reduce_sum(sums, ctx.group)
        dx = (reference_bn_relu_bwd if ctx.plain else bn_relu_bwd)(dy, h, coef, sums, ctx.n)
        return dx.reshape(ctx.shape), dgamma, dbeta, None, None, None, None


def train_batch_norm_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, *,
                          group=None, world: int = 1, plain: bool = False):
    """relu(BatchNorm(x)) over the last axis with the batch's statistics:
    returns (y in x's dtype, coef), coef the (6, C) rows mean, s, β, rstd,
    var and live (f32; f64 for f64), not differentiable; rows 0 and 4 are
    the statistics for the running ones (var the biased variance).
    ``group``/``world``: the data group the batch is spread over, and its
    size (every rank holds as many rows). ``plain`` takes the plain
    versions on any device."""
    if x.shape[-1] % WIDTH_MULTIPLE and not plain:
        raise ValueError(f"the BatchNorm kernels take a width that is a multiple of "
                         f"{WIDTH_MULTIPLE}, got {x.shape[-1]}")
    return _TrainBatchNormReLU.apply(x.contiguous(), weight, bias, eps, group, world, plain)


def _sums_fake(h):
    return h.new_empty((2, h.shape[1]), dtype=torch.float64)


@kernel_op("bn_stats", _sums_fake)
def _bn_stats_op(h: torch.Tensor) -> torch.Tensor:
    return bn_stats(h)


@kernel_op("bn_relu", lambda h, sums, n, weight, bias, eps: (
    torch.empty_like(h), h.new_empty((COEF_ROWS, h.shape[1]), dtype=torch.float32)))
def _bn_relu_op(h: torch.Tensor, sums: torch.Tensor, n: float, weight: torch.Tensor,
                bias: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    return bn_relu(h, sums, n, weight, bias, eps)


@kernel_op("bn_relu_bwd_stats", lambda dy, h, coef: _sums_fake(h))
def _bn_relu_bwd_stats_op(dy: torch.Tensor, h: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    return bn_relu_bwd_stats(dy, h, coef)


@kernel_op("bn_relu_bwd", lambda dy, h, coef, sums, n: torch.empty_like(h))
def _bn_relu_bwd_op(dy: torch.Tensor, h: torch.Tensor, coef: torch.Tensor, sums: torch.Tensor,
                    n: float) -> torch.Tensor:
    return bn_relu_bwd(dy, h, coef, sums, n)
