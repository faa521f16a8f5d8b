"""Classification heads of the APF, Pix4Point and renderer models.

Counterparts of ``pointvit_tpu/nn/heads.py``: ``ClassificationHead`` (APF,
E → 512 → 256 → classes, Dropout(0.4), ``heads.py:16-30``) and ``ClsHead``
(Pix4Point, 2E → 256 → 256 → classes, Dropout(0.5), ``heads.py:33-51``;
its ``mlps`` and ``dropout_rate`` as in flax): each hidden layer is Linear → BatchNorm (eps 1e-5) → ReLU → Dropout, with
submodules ``fc0, bn0, fc1, bn1, out``. ``RendererHead`` (``heads.py:54-69``)
is LayerNorm ``norm`` → ``fc0`` (512) → GELU → Dropout → ``fc1`` (256) →
GELU → Dropout → ``out``. At inference the BatchNorms use
their running statistics and the dropout is the identity; in training they
use batch statistics with flax's conventions
(:func:`~pointvit_tpu_torch.nn.layers.batch_norm_relu`; ``implementation``
as the models') and the dropout draws
from the generator given. The products are plain ``F.linear`` in the
compute dtype, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointvit_tpu_torch.nn.layers import Dropout, batch_norm_relu, layer_norm, linear
from pointvit_tpu_torch.ops.block_kernel import LN_EPS

__all__ = ["ClassificationHead", "ClsHead", "RendererHead"]


class ClassificationHead(nn.Module):
    def __init__(self, in_dim: int, num_classes: int, widths=(512, 256),
                 dropout_rate: float = 0.4, implementation: str | None = None) -> None:
        super().__init__()
        self.depth = len(widths)
        self.implementation = implementation
        for i, w in enumerate(widths):
            self.add_module(f"fc{i}", nn.Linear(in_dim, w))
            self.add_module(f"bn{i}", nn.BatchNorm1d(w, eps=1e-5, momentum=0.1))
            in_dim = w
        self.out = nn.Linear(in_dim, num_classes)
        self.dropout = Dropout(dropout_rate)  # fixed, as in the JAX heads

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for i in range(self.depth):
            h = batch_norm_relu(linear(x, getattr(self, f"fc{i}")), getattr(self, f"bn{i}"),
                                train=train, implementation=self.implementation)
            x = self.dropout(h, train=train, generator=generator)
        return linear(x, self.out)


class ClsHead(ClassificationHead):
    """Pix4Point head: 2E → ``mlps`` (256 → 256) → classes, Dropout(0.5)."""

    def __init__(self, in_dim: int, num_classes: int, mlps=(256, 256),
                 dropout_rate: float = 0.5, implementation: str | None = None) -> None:
        super().__init__(in_dim, num_classes, widths=tuple(mlps), dropout_rate=dropout_rate,
                         implementation=implementation)


class RendererHead(nn.Module):
    """Renderer classifier head: LN → 512 → GELU → 256 → GELU → classes,
    Dropout(0.1) after each GELU."""

    def __init__(self, in_dim: int, num_classes: int, dropout_rate: float = 0.1) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.fc0 = nn.Linear(in_dim, 512)
        self.fc1 = nn.Linear(512, 256)
        self.out = nn.Linear(256, num_classes)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = layer_norm(x, self.norm)
        for fc in (self.fc0, self.fc1):
            h = F.gelu(linear(x, fc), approximate="none")
            x = self.dropout(h, train=train, generator=generator)
        return linear(x, self.out)
