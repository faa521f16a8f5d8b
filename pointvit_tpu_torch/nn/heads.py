"""APF classification head.

Counterpart of ``pointvit_tpu/nn/heads.py::ClassificationHead``:
E → 512 → 256 → classes, each hidden layer Linear → BatchNorm (eps 1e-5)
→ ReLU → Dropout(0.4) (``heads.py:20-30``). At inference the BatchNorms use
their running statistics and the dropout is the identity; in training they
use batch statistics with flax's conventions
(:func:`~pointvit_tpu_torch.nn.layers.batch_norm`) and the dropout draws
from the generator given. The products are plain ``F.linear`` in the
compute dtype, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from pointvit_tpu_torch.nn.layers import Dropout, batch_norm, linear

__all__ = ["ClassificationHead"]


class ClassificationHead(nn.Module):
    def __init__(self, in_dim: int, num_classes: int) -> None:
        super().__init__()
        self.fc0 = nn.Linear(in_dim, 512)
        self.bn0 = nn.BatchNorm1d(512, eps=1e-5, momentum=0.1)
        self.fc1 = nn.Linear(512, 256)
        self.bn1 = nn.BatchNorm1d(256, eps=1e-5, momentum=0.1)
        self.out = nn.Linear(256, num_classes)
        self.dropout = Dropout(0.4)  # fixed, as in the JAX head

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for fc, bn in ((self.fc0, self.bn0), (self.fc1, self.bn1)):
            h = torch.relu(batch_norm(linear(x, fc), bn, train=train))
            x = self.dropout(h, train=train, generator=generator)
        return linear(x, self.out)
