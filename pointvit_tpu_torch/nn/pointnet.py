"""Point-feature encoders: the APF mini-PointNet group encoder, and
Pix4Point's P3Embed tokenizer and positional MLP.

Counterpart of ``pointvit_tpu/nn/pointnet.py``. ``GroupFeatureEncoder``
(layers as in ``nn/pointnet.py:90-132``)::

    first:  first_0 (C→256) → first_bn0 → ReLU → first_1 (256→512) → first_bn1
            → ReLU → first_2 (512→E)                      = loc, g = max_K loc
    second: second_0_global(g) + second_0_local(loc)      (the concat([g, loc])
            product split in two; the local half has no bias)
            → second_bn0 → ReLU → second_1 (H→E) → max_K

``second_width`` is H (None: 2·E, the reference width). At inference the
BatchNorms fold into the products and the encoder runs
:func:`~pointvit_tpu_torch.ops.encoder_kernel.fused_group_encoder` (the
kernel chain on the card) or, with ``implementation='torch'``, its plain
version. In training it runs the unfolded body with batch statistics, as
the JAX encoder refuses its fused kernel when ``train``
(``nn/pointnet.py:54-56``): plain products, each BatchNorm + ReLU one op
(:func:`~pointvit_tpu_torch.nn.layers.batch_norm_relu`, kernels on the
card). With ``quantized=True`` (inference only)
``first_1``, ``first_2``, ``second_0_local`` and ``second_1`` are
:class:`~pointvit_tpu_torch.nn.quant.QuantLinear` and the encoder runs the
same unfolded body with BatchNorm on its running statistics, as the JAX
encoder refuses its fused kernel when quantized (``:55``); ``first_0``
(depth C) and ``second_0_global`` (one row per group) stay plain products.

With ``remat=True`` the training body runs under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant), as the JAX encoder's
``nn.remat`` (``nn/pointnet.py:87, 134-139``): its (M, K, H) activations are
recomputed in the backward instead of held. The BatchNorms' running
statistics are updated once, from the first run, and not again by the
recompute, as flax updates ``batch_stats`` once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pointvit_tpu_torch.nn.layers import batch_norm_relu, linear, update_running_stats
from pointvit_tpu_torch.nn.quant import dense
from pointvit_tpu_torch.ops.encoder_kernel import (
    BN_EPS,
    fold_encoder_params,
    fused_group_encoder,
    reference_folded_encoder,
)
from pointvit_tpu_torch.ops.fps import random_starts
from pointvit_tpu_torch.parallel.comm import batch_in_force, current_batch
from pointvit_tpu_torch.ops.group import p3_group
from pointvit_tpu_torch.ops.p3_kernel import (
    fold_p3_stage_params,
    fused_p3_embed,
    reference_folded_p3,
)
from pointvit_tpu_torch.utils.profiling import span

__all__ = ["GroupFeatureEncoder", "P3Embed", "PosEmbedMLP"]


class GroupFeatureEncoder(nn.Module):
    def __init__(
        self,
        in_channels: int,
        embed_dim: int,
        second_width: int | None = None,
        dtype: torch.dtype = torch.float32,
        implementation: str | None = None,
        quantized: bool = False,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        E = embed_dim
        self.remat = remat
        H = second_width or 2 * E
        self.embed_dim = E
        self.second_width = H
        self.dtype = dtype
        self.implementation = implementation
        self.quantized = quantized
        bn = lambda n: nn.BatchNorm1d(n, eps=BN_EPS, momentum=0.1)  # flax momentum 0.9
        q = lambda i, o, bias=True: dense(quantized, i, o, bias, implementation)  # noqa: E731
        self.first_0 = nn.Linear(in_channels, 256)
        self.first_bn0 = bn(256)
        self.first_1 = q(256, 512)
        self.first_bn1 = bn(512)
        self.first_2 = q(512, E)
        self.second_0_global = nn.Linear(E, H)
        self.second_0_local = q(E, H, bias=False)
        self.second_bn0 = bn(H)
        self.second_1 = q(H, E)

    def forward(self, groups: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """(B, G, K, C) → (B, G, E) in the encoder's dtype."""
        B, G, K, C = groups.shape
        x = groups.to(self.dtype).reshape(B * G, K, C)
        if train and self.remat:
            out = self._body_remat(x)
        elif train or self.quantized:
            out = self._body(x, train=train)
        else:
            with span("encoder.fold", device=True):
                weights = fold_encoder_params(self)
            if self.implementation == "torch":
                out = reference_folded_encoder(x, weights)
            else:
                out = fused_group_encoder(x, weights)
        return out.reshape(B, G, self.embed_dim)

    def _body_remat(self, x: torch.Tensor) -> torch.Tensor:
        """The training body under activation checkpointing. The recompute
        runs in the backward, outside the forward's ``global_batch``, so the
        body puts the first run's batch in force again; the running
        statistics move once, by the first run's statistics."""
        batch, updates = current_batch(), []

        def body(t):
            with batch_in_force(batch):
                return self._body(t, train=True, deferred=updates)

        out = checkpoint(body, x, use_reentrant=False)
        update_running_stats(updates)
        return out

    def _body(self, x: torch.Tensor, *, train: bool, deferred: list | None = None) -> torch.Tensor:
        """The unfolded body of ``nn/pointnet.py:90-132``, (M, K, C) → (M, E),
        layer by layer; BatchNorms on batch statistics over all M·K rows when
        ``train``, else on their running statistics; ``deferred`` collects
        the running-statistics updates instead of applying them."""
        bn = lambda t, m: batch_norm_relu(t, m, train=train, deferred=deferred,  # noqa: E731
                                          implementation=self.implementation)
        x = bn(linear(x, self.first_0), self.first_bn0)
        x = bn(linear(x, self.first_1), self.first_bn1)
        x = linear(x, self.first_2)
        g = x.amax(dim=-2, keepdim=True)  # (M, 1, E)
        # concat([g, x]) @ W split in two: the global half runs once per group.
        x = linear(g, self.second_0_global) + linear(x, self.second_0_local)
        x = bn(x, self.second_bn0)
        return linear(x, self.second_1).amax(dim=-2)


class P3Embed(nn.Module):
    """Progressive point-patch tokenizer (Pix4Point ``P3Embed``,
    ``nn/pointnet.py:142-279``).

    ``int(log_scale(1 / sample_ratio))`` stages, as in flax; the reference's
    sampling (ratio 0.25, scale 4) gives one. Stage ``s`` has layers named
    ``s{s}_*`` and width ``embed_dim / 2^(stages-1) · 2^s`` (the last stage's
    is ``embed_dim``): FPS to a quarter of its input's points (the reference
    fixes that ratio whatever ``scale``), kNN grouping (absolute neighbour
    coordinates), concat [coords, features], conv1 (``layers/2`` linears,
    only the last with a bias, then BN → ReLU), concat [global max, local],
    conv2 (``layers/2`` linears without bias, each BN → ReLU; widths 2·dim …
    dim), max over the group. Stage ``s + 1`` takes stage ``s``'s centres as
    its points and its tokens as its features: 2048 points → 512 tokens of
    width ``embed_dim`` in one stage, → 512 → 128 in two.

    At inference each stage runs
    :func:`~pointvit_tpu_torch.ops.p3_kernel.fused_p3_embed` on
    :func:`~pointvit_tpu_torch.ops.p3_kernel.fold_p3_stage_params` of that
    stage (the kernels on the card: the group-MLP kernels inside their gate,
    else the GEMM chain) where the JAX package takes its fused stage:
    ``layers == 4`` and B·S % 16 == 0 (``nn/pointnet.py:168-186``).
    ``implementation='torch'`` runs the fused stage's plain version. Any
    other shape runs :meth:`stage_unfused` (eval-mode BN, eps 1e-5) on
    either device, as the JAX stage runs its unfused stack there
    (``nn/pointnet.py:166-186``): one cloud of 1000 points (S = 250) does.

    ``train=True`` runs :meth:`stage_unfused` with train-mode BatchNorm
    (batch statistics, running statistics updated with flax's conventions;
    each BatchNorm + ReLU one op,
    :func:`~pointvit_tpu_torch.nn.layers.batch_norm_relu`), as the JAX stage
    leaves its fused kernel when training (``nn/pointnet.py:168-171``).
    FPS starts at point 0, or, in training with a generator, at a random
    point of every cloud drawn from it (one draw per stage), as the JAX
    stage draws its starts from the ``'fps'`` stream, split once a stage.
    """

    def __init__(self, in_channels: int = 3, sample_ratio: float = 0.25, scale: int = 4,
                 k: int = 16, layers: int = 4, embed_dim: int = 256,
                 dtype: torch.dtype = torch.float32, implementation: str | None = None) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        self.stages = int(math.log(1 / sample_ratio, scale))
        if self.stages < 1:
            raise ValueError(f"sample_ratio={sample_ratio}, scale={scale} give no stage")
        self.k = k
        self.layers = layers
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.implementation = implementation
        bn = lambda n: nn.BatchNorm1d(n, eps=BN_EPS, momentum=0.1)  # flax momentum 0.9
        half, dim, in_ch = layers // 2, int(embed_dim // 2 ** (self.stages - 1)), in_channels
        for s in range(self.stages):
            width = 3 + in_ch
            for i in range(half):
                self.add_module(f"s{s}_conv1_{i}", nn.Linear(width, dim, bias=i == half - 1))
                width = dim
            self.add_module(f"s{s}_conv1_bn", bn(dim))
            width = 2 * dim
            for i, w in enumerate([2 * dim] * (half - 1) + [dim]):
                self.add_module(f"s{s}_conv2_{i}", nn.Linear(width, w, bias=False))
                self.add_module(f"s{s}_conv2_bn{i}", bn(w))
                width = w
            in_ch, dim = dim, 2 * dim

    def forward(self, points: torch.Tensor, features: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """points (B, N, 3), features (B, N, C_in) → (centres (B, N/4^stages,
        3), tokens (B, N/4^stages, embed_dim) in the module's dtype)."""
        p, f = points, features
        for s in range(self.stages):
            with span("p3.group", device=True):
                start = random_starts(p, generator) if train and generator is not None else None
                # The reference fixes the ratio at 4 (pix4point.py:174).
                centers, dp, fj = p3_group(p, f, p.shape[1] // 4, self.k, start=start,
                                           implementation=self.implementation)
                x = torch.cat([dp, fj], dim=-1).to(self.dtype)  # (B, S, k, 3 + C)
            f = self._stage(x, s, train)
            p = centers
        return p, f

    def _stage(self, x: torch.Tensor, stage: int, train: bool) -> torch.Tensor:
        """One stage's conv stacks on its groups (B, S, K, C) → (B, S, dim)."""
        B, S, K, C = x.shape
        fused = not train and self.layers == 4 and (B * S) % 16 == 0
        if fused:
            with span("p3.fold", device=True):
                fold = fold_p3_stage_params(self, stage)
        with span("p3.embed", device=True):
            if not fused:
                return self.stage_unfused(x, train=train, stage=stage)
            run = reference_folded_p3 if self.implementation == "torch" else fused_p3_embed
            return run(x.reshape(B * S, K, C), fold).reshape(B, S, -1)

    def stage_unfused(self, x: torch.Tensor, *, train: bool = False, stage: int = 0) -> torch.Tensor:
        """Stage ``stage``'s conv stacks layer by layer, (B, S, K, C) →
        (B, S, dim), with BatchNorm on batch statistics when ``train``, else
        on its running statistics."""
        bn = lambda t, m: batch_norm_relu(t, m, train=train,  # noqa: E731
                                          implementation=self.implementation)
        layer = lambda name: getattr(self, f"s{stage}_{name}")  # noqa: E731
        half = self.layers // 2
        for i in range(half):
            x = linear(x, layer(f"conv1_{i}"))
        x = bn(x, layer("conv1_bn"))
        g = x.amax(dim=-2, keepdim=True)
        x = torch.cat([g.expand_as(x), x], dim=-1)
        for i in range(half):
            x = linear(x, layer(f"conv2_{i}"))
            x = bn(x, layer(f"conv2_bn{i}"))
        return x.amax(dim=-2)


class PosEmbedMLP(nn.Module):
    """Learned 3D positional embedding: fc1 (3→128) → exact GELU → fc2
    (128→E) (``nn/pointnet.py:282-296``). Plain ``F.linear`` in the compute
    dtype, as the JAX package leaves these to XLA."""

    def __init__(self, embed_dim: int, hidden: int = 128, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(3, hidden)
        self.fc2 = nn.Linear(hidden, embed_dim)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        h = F.gelu(linear(xyz.to(self.dtype), self.fc1), approximate="none")
        return linear(h, self.fc2)
