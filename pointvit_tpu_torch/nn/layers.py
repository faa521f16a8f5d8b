"""Transformer building blocks of the APF and serial-adapter blocks:
attention, MLP, the two adapters, dropout, stochastic depth, and train-mode
BatchNorm.

Counterparts of ``pointvit_tpu/nn/layers.py``. The modules hold the
parameters (names as in the flax modules, so the weight bridge maps them one
to one) and give the unfused forward in the input's dtype, which the APF
block runs when it trains or is quantized. Otherwise, at inference, the
block runs its fused kernel chain over the same parameters
(:mod:`pointvit_tpu_torch.nn.vit`). With ``quantized=True`` the attention's
``qkv`` and ``proj`` and the MLP's ``fc1`` and ``fc2`` are
:class:`~pointvit_tpu_torch.nn.quant.QuantLinear` (dynamic w8a8), as in the
JAX package; the adapters never are.
Every LayerNorm uses eps 1e-6, the flax default.

Randomness is explicit, as with flax's ``deterministic`` flag and PRNG
streams: a forward is stochastic only with ``train=True``, and it draws from
the ``torch.Generator`` it is given (the default generator when None).

Inside a data-parallel step (:func:`~pointvit_tpu_torch.parallel.comm.global_batch`)
a rank draws its masks as this rank's rows of the global batch's draw, and
train-mode BatchNorm takes the global batch's statistics over the data
group, as the JAX package's SPMD step computes them. A layer whose weights
a tensor-parallel plan sharded (DTensors) runs its rank's slice
(:func:`~pointvit_tpu_torch.parallel.mesh.tp_linear`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointvit_tpu_torch.nn.quant import QuantLinear, dense
from pointvit_tpu_torch.ops.attention_kernel import fused_mha_qkv
from pointvit_tpu_torch.ops.batchnorm_kernel import WIDTH_MULTIPLE, train_batch_norm_relu
from pointvit_tpu_torch.ops.block_kernel import LN_EPS
from pointvit_tpu_torch.parallel.comm import all_reduce_sum, current_batch, draw_rows
from pointvit_tpu_torch.parallel.mesh import DTENSOR, tp_attention, tp_linear

__all__ = [
    "Attention",
    "Mlp",
    "AdapterLayer",
    "SimpleAdapter",
    "Dropout",
    "DropPath",
    "Identity",
    "batch_norm",
    "batch_norm_relu",
    "layer_norm",
    "update_running_stats",
    "linear",
]

BN_MOMENTUM = 0.9  # flax convention: r ← 0.9·r + 0.1·batch statistic


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` applied in x's dtype (parameters stay f32, as in flax; their
    gradients come back in f32); a ``QuantLinear`` runs its int8 product."""
    if isinstance(lin, QuantLinear):
        return lin(x)
    if DTENSOR is not None and isinstance(lin.weight, DTENSOR):
        return tp_linear(x, lin)
    b = lin.bias.to(x.dtype) if lin.bias is not None else None
    return F.linear(x, lin.weight.to(x.dtype), b)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """``ln`` with f32 statistics; the output keeps x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(x.dtype)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, *, train: bool,
               deferred: list | None = None) -> torch.Tensor:
    """BatchNorm over the last axis with flax's conventions; the output keeps
    x's dtype, statistics are f32.

    At inference it normalises by the running statistics. In training it
    takes the statistics over all leading axes, normalises by the *biased*
    batch variance (E[x²] − E[x]², clipped at 0, as flax computes it) and
    updates ``r ← 0.9·r + 0.1·stat`` with that same biased variance.
    ``F.batch_norm(training=True)`` would update ``running_var`` with the
    unbiased variance, so it is not used in training. Inside a
    ``global_batch`` the two means are averaged over the data group (every
    rank holds as many rows), differentiably, so every rank normalises by
    the global batch's statistics. With ``deferred`` (a list) the update is
    not applied but appended as ``(bn, mean, var)`` for
    :func:`update_running_stats`: a region that runs again in the backward
    (activation checkpointing) must not move the statistics twice.
    """
    xf = x.float()
    if not train:  # rows of the last axis: F.batch_norm takes channels on axis 1
        y = F.batch_norm(xf.reshape(-1, xf.shape[-1]), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, training=False, eps=bn.eps)
        return y.reshape(x.shape).to(x.dtype)
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=dims)
    mean_sq = (xf * xf).mean(dim=dims)
    batch = current_batch()
    if batch is not None:
        both = all_reduce_sum(torch.stack([mean, mean_sq]), batch.group) / batch.size
        mean, mean_sq = both[0], both[1]
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    if deferred is None:
        update_running_stats([(bn, mean, var)])
    else:
        deferred.append((bn, mean.detach(), var.detach()))
    y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.to(x.dtype)


def batch_norm_relu(x: torch.Tensor, bn: nn.BatchNorm1d, *, train: bool,
                    deferred: list | None = None, implementation: str | None = None) -> torch.Tensor:
    """``relu(batch_norm(x, bn, train=train, deferred=deferred))``, the
    training path's one op for it. In training, over a width that is a
    multiple of 8, it is
    :func:`~pointvit_tpu_torch.ops.batchnorm_kernel.train_batch_norm_relu`:
    the kernels of ``csrc/batchnorm.cu`` in both directions on the card (the
    plain versions on the CPU, or with ``implementation='torch'``), the same
    statistics, running-statistics update, ``deferred`` and global-batch
    semantics as :func:`batch_norm`. Any other width, and inference, take
    :func:`batch_norm` and ``torch.relu``."""
    if not train or x.shape[-1] % WIDTH_MULTIPLE:
        return torch.relu(batch_norm(x, bn, train=train, deferred=deferred))
    batch = current_batch()
    y, coef = train_batch_norm_relu(
        x, bn.weight, bn.bias, bn.eps, group=batch.group if batch is not None else None,
        world=batch.size if batch is not None else 1, plain=implementation == "torch")
    stats = (bn, coef[0], coef[4])  # the batch's mean and biased variance
    if deferred is None:
        update_running_stats([stats])
    else:
        deferred.append(stats)
    return y


def update_running_stats(updates) -> None:
    """Apply ``r ← 0.9·r + 0.1·stat`` for each ``(bn, mean, var)``."""
    with torch.no_grad():
        for bn, mean, var in updates:
            bn.running_mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1.0 - BN_MOMENTUM)
            bn.running_var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1.0 - BN_MOMENTUM)


def _uniform(shape, generator: torch.Generator | None, device: torch.device) -> torch.Tensor:
    """U[0, 1) draws made on the generator's own device, then moved to
    ``device`` (a CUDA generator draws on the card); this rank's rows of the
    global batch's draw inside a ``global_batch``."""
    where = generator.device if generator is not None else device
    return draw_rows(lambda s: torch.rand(s, generator=generator, device=where), shape).to(device)


class Dropout(nn.Module):
    """Element-wise dropout like flax's ``nn.Dropout``: keep each element with
    probability ``1 − rate`` and scale the kept ones by ``1/keep``."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        mask = _uniform(x.shape, generator, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Identity(nn.Module):
    """The identity, with the other layers' keyword arguments."""

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return x


class DropPath(nn.Module):
    """Stochastic depth: drop a sample's whole residual branch with
    probability ``rate`` in training; identity otherwise."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = _uniform(shape, generator, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Attention(nn.Module):
    """Multi-head self-attention with one packed ``qkv`` projection (with
    bias) and an output ``proj``, both int8 when ``quantized``; the
    attention itself is
    :func:`~pointvit_tpu_torch.ops.attention_kernel.fused_mha_qkv` (the
    forward and backward kernels on the card)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 implementation: str | None = None, quantized: bool = False) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim={dim} is not a multiple of num_heads={num_heads}")
        self.num_heads = num_heads
        self.implementation = implementation
        self.qkv = dense(quantized, dim, 3 * dim, qkv_bias, implementation)
        self.proj = dense(quantized, dim, dim, True, implementation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if DTENSOR is not None and isinstance(self.qkv.weight, DTENSOR):
            return tp_attention(x, self, self.implementation)
        att = fused_mha_qkv(linear(x, self.qkv), self.num_heads, self.implementation)
        return linear(att, self.proj)


class Mlp(nn.Module):
    """fc1 → exact GELU → dropout → fc2 → dropout (timm layout,
    ``pointvit_tpu/nn/layers.py:35-55``); both products int8 when
    ``quantized``. ``dropout_rate`` is 0 by default, as the APF block passes
    none; the Pix4Point trunk's blocks pass theirs. ``out_features`` is fc2's
    width (None: ``dim``, the input's, as in flax)."""

    def __init__(self, dim: int, hidden_features: int, quantized: bool = False,
                 implementation: str | None = None, dropout_rate: float = 0.0,
                 out_features: int | None = None) -> None:
        super().__init__()
        self.fc1 = dense(quantized, dim, hidden_features, True, implementation)
        self.fc2 = dense(quantized, hidden_features, out_features or dim, True, implementation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Random draws, in order: after the GELU, after fc2."""
        kw = dict(train=train, generator=generator)
        h = self.dropout(F.gelu(linear(x, self.fc1), approximate="none"), **kw)
        return self.dropout(linear(h, self.fc2), **kw)


class AdapterLayer(nn.Module):
    """APF bottleneck adapter: LN → down → ReLU → dropout → up → ×scale, plus
    its own residual when ``add_residual`` (the reference's internal add,
    kept as the JAX package keeps it; the default). ``up_proj`` starts at
    zero and ``scale`` at one, as in flax."""

    def __init__(self, dim: int, bottleneck: int = 64, dropout_rate: float = 0.0,
                 add_residual: bool = True) -> None:
        super().__init__()
        self.add_residual = add_residual
        self.adapter_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.down_proj = nn.Linear(dim, bottleneck)
        self.dropout = Dropout(dropout_rate)
        self.up_proj = nn.Linear(bottleneck, dim)
        self.scale = nn.Parameter(torch.ones(1))
        nn.init.zeros_(self.down_proj.bias)
        nn.init.zeros_(self.up_proj.weight)
        nn.init.zeros_(self.up_proj.bias)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = torch.relu(linear(layer_norm(x, self.adapter_norm), self.down_proj))
        h = self.dropout(h, train=train, generator=generator)
        h = linear(h, self.up_proj) * self.scale.to(x.dtype)
        return h + x if self.add_residual else h


class SimpleAdapter(nn.Module):
    """Serial adapter of the renderer's ViT blocks: x + up(gelu(down(x)))
    (``pointvit_tpu/nn/layers.py:182-211``). ``down_proj`` starts as a tiny
    Xavier-uniform matrix (gain 1e-3) with zero bias and ``up_proj`` at zero,
    as in flax, so the adapter starts as the identity."""

    def __init__(self, dim: int, bottleneck: int = 64) -> None:
        super().__init__()
        self.down_proj = nn.Linear(dim, bottleneck)
        self.up_proj = nn.Linear(bottleneck, dim)
        nn.init.xavier_uniform_(self.down_proj.weight, gain=1e-3)
        nn.init.zeros_(self.down_proj.bias)
        nn.init.zeros_(self.up_proj.weight)
        nn.init.zeros_(self.up_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(linear(x, self.down_proj), approximate="none")
        return x + linear(h, self.up_proj)
