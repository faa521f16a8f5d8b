"""APF mini-PointNet group encoder.

Counterpart of ``pointvit_tpu/nn/pointnet.py::GroupFeatureEncoder``
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
version. In training it runs the unfolded body in plain PyTorch with batch
statistics, as the JAX encoder refuses its fused kernel when ``train``
(``nn/pointnet.py:54-56``).
"""

from __future__ import annotations

import torch
from torch import nn

from pointvit_tpu_torch.nn.layers import batch_norm, linear
from pointvit_tpu_torch.ops.encoder_kernel import (
    BN_EPS,
    fold_encoder_params,
    fused_group_encoder,
    reference_folded_encoder,
)

__all__ = ["GroupFeatureEncoder"]


class GroupFeatureEncoder(nn.Module):
    def __init__(
        self,
        in_channels: int,
        embed_dim: int,
        second_width: int | None = None,
        dtype: torch.dtype = torch.float32,
        implementation: str | None = None,
    ) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        E = embed_dim
        H = second_width or 2 * E
        self.embed_dim = E
        self.second_width = H
        self.dtype = dtype
        self.implementation = implementation
        bn = lambda n: nn.BatchNorm1d(n, eps=BN_EPS, momentum=0.1)  # flax momentum 0.9
        self.first_0 = nn.Linear(in_channels, 256)
        self.first_bn0 = bn(256)
        self.first_1 = nn.Linear(256, 512)
        self.first_bn1 = bn(512)
        self.first_2 = nn.Linear(512, E)
        self.second_0_global = nn.Linear(E, H)
        self.second_0_local = nn.Linear(E, H, bias=False)
        self.second_bn0 = bn(H)
        self.second_1 = nn.Linear(H, E)

    def forward(self, groups: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """(B, G, K, C) → (B, G, E) in the encoder's dtype."""
        B, G, K, C = groups.shape
        x = groups.to(self.dtype).reshape(B * G, K, C)
        if train:
            out = self._body(x)
        else:
            weights = fold_encoder_params(self)
            if self.implementation == "torch":
                out = reference_folded_encoder(x, weights)
            else:
                out = fused_group_encoder(x, weights)
        return out.reshape(B, G, self.embed_dim)

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        """Training body of ``nn/pointnet.py:90-132``, (M, K, C) → (M, E):
        plain products, BatchNorms on batch statistics over all M·K rows."""
        bn = lambda t, m: batch_norm(t, m, train=True)  # noqa: E731
        x = torch.relu(bn(linear(x, self.first_0), self.first_bn0))
        x = torch.relu(bn(linear(x, self.first_1), self.first_bn1))
        x = linear(x, self.first_2)
        g = x.amax(dim=-2, keepdim=True)  # (M, 1, E)
        # concat([g, x]) @ W split in two: the global half runs once per group.
        x = linear(g, self.second_0_global) + linear(x, self.second_0_local)
        x = torch.relu(bn(x, self.second_bn0))
        return linear(x, self.second_1).amax(dim=-2)
