"""The APF transformer block.

Counterpart of ``pointvit_tpu/nn/vit.py::APFBlock``, with the reference's
double residual (``nn/vit.py:153-226``)::

    x   = x + drop_path(attn(norm1(x)))
    out = drop_path(mlp(norm2(x))) + adapter(x) + x     # adapter(x) adds x itself

At inference the block runs :func:`~pointvit_tpu_torch.ops.block_kernel.fused_apf_block`
(the kernel chain on the card) or, with ``implementation='torch'``, its
plain version. In training it leaves the fused block, as the JAX block does
when dropout is on (``nn/vit.py:70-71``): LayerNorms and products are plain
PyTorch, the attention is ``fused_mha_qkv`` (its forward and backward
kernels on the card), and the adapter's dropout and both drop-paths draw
from the generator given.
"""

from __future__ import annotations

import torch
from torch import nn

from pointvit_tpu_torch.nn.layers import AdapterLayer, Attention, DropPath, Mlp, layer_norm
from pointvit_tpu_torch.ops.block_kernel import (
    LN_EPS,
    apf_block_weights,
    fused_apf_block,
    reference_apf_block,
)

__all__ = ["APFBlock"]


class APFBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        adapter_bottleneck: int = 64,
        dtype: torch.dtype = torch.float32,
        implementation: str | None = None,
        drop_path_rate: float = 0.0,
        dropout_rate: float = 0.1,
    ) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.implementation = implementation
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = Attention(dim, num_heads, implementation=implementation)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 4 * dim)
        self.adapter = AdapterLayer(dim, adapter_bottleneck, dropout_rate)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, S, E) → (B, S, E) in the block's dtype."""
        x = x.to(self.dtype)
        if train:
            return self.forward_unfused(x, train=True, generator=generator)
        weights = apf_block_weights(self)
        if self.implementation == "torch":
            return reference_apf_block(x, weights, self.num_heads)
        return fused_apf_block(x, weights, self.num_heads)

    def forward_unfused(self, x: torch.Tensor, *, train: bool = False,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """The block through its layer modules, one plain op at a time (with
        the attention kernels on the card). Random draws, in order: the
        attention branch's drop-path, the adapter's dropout, the MLP
        branch's drop-path."""
        kw = dict(train=train, generator=generator)
        x = x + self.drop_path(self.attention(layer_norm(x, self.norm1)), **kw)
        adapt = self.adapter(x, **kw)
        return self.drop_path(self.mlp(layer_norm(x, self.norm2)), **kw) + adapt + x
