"""Mixture-of-experts layers over the expert-parallel core.

Counterpart of ``pointvit_tpu/nn/moe.py``:

- :class:`MoEMlp`: a drop-in for :class:`~pointvit_tpu_torch.nn.layers.Mlp`,
  a router and E stacked expert FFNs (``gate`` (M, E), ``w1`` (E, M, F),
  ``b1``, ``w2`` (E, F, M), ``b2``: the JAX layout and names, so the weight
  bridge maps ``blocks_i/mlp/*`` without a transpose) through
  :func:`~pointvit_tpu_torch.parallel.expert.moe_ffn`, over an expert mesh
  when one is given. Each keeps the load-balance loss of its last forward
  (``aux_loss``), where flax sows it; :func:`collect_moe_aux_loss` takes
  their mean.
- :class:`MoEViTBlock`: the pre-norm block of the JAX layout (``norm1``,
  ``attn``, ``norm2``, ``mlp``; ``pos`` re-added first) with the MLP widened
  to experts and the block's dropout on the combined output. Its attention
  is the port's :class:`~pointvit_tpu_torch.nn.layers.Attention`: the
  attention kernels on the card (forward and backward) where the JAX block
  takes ``fused_mha_qkv``, the plain path with ``implementation='torch'``.
"""

from __future__ import annotations

import torch
from torch import nn

from pointvit_tpu_torch.nn.layers import Attention, Dropout, DropPath, layer_norm
from pointvit_tpu_torch.ops.block_kernel import LN_EPS
from pointvit_tpu_torch.parallel.expert import fan_in_normal_init, moe_ffn

__all__ = ["MoEMlp", "MoEViTBlock", "collect_moe_aux_loss"]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (differentiable), or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


class MoEMlp(nn.Module):
    """Mixture-of-experts transformer MLP: (B, S, M) → (B, S, M) in the
    layer's ``dtype`` (the weights are cast to it, then the routing and the
    experts compute in f32, as in JAX). With ``mesh`` the experts and the
    tokens shard over ``expert_axis`` (see ``parallel/expert.py``); the
    module then holds every expert and each rank uses its E/n, or, after
    :func:`~pointvit_tpu_torch.parallel.expert.shard_experts` (the
    ``Trainer`` on an expert mesh), its E/n alone."""

    def __init__(self, dim: int, num_experts: int, hidden_features: int, *, top_k: int = 2,
                 capacity_factor: float = 2.0, normalize_gates: bool = False,
                 dtype: torch.dtype = torch.float32, mesh=None, expert_axis: str = "expert",
                 data_axis: str | None = None) -> None:
        super().__init__()
        m, f, e = dim, hidden_features, num_experts
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.normalize_gates = normalize_gates
        self.dtype = dtype
        self.mesh = mesh
        self.expert_axis = expert_axis
        self.data_axis = data_axis
        self.gate = nn.Parameter(fan_in_normal_init(m)((m, e)))
        self.w1 = nn.Parameter(fan_in_normal_init(m)((e, m, f)))
        self.b1 = nn.Parameter(torch.zeros(e, f))
        self.w2 = nn.Parameter(fan_in_normal_init(f)((e, f, m)))
        self.b2 = nn.Parameter(torch.zeros(e, m))
        self.aux_loss: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Expert weights sharded by parallel.expert.shard_experts enter as
        # this rank's E/n experts (their local shards).
        params = {k: _local(getattr(self, k)).to(self.dtype) for k in ("gate", "w1", "b1", "w2", "b2")}
        out, self.aux_loss = moe_ffn(
            x.to(self.dtype), params, self.mesh, expert_axis=self.expert_axis,
            data_axis=self.data_axis, top_k=self.top_k, capacity_factor=self.capacity_factor,
            normalize_gates=self.normalize_gates)
        return out


class MoEViTBlock(nn.Module):
    """Pre-norm ViT block with a mixture-of-experts MLP
    (``pointvit_tpu/nn/moe.py:95-147``)::

        x = x + pos;  x = x + drop_path(attn(norm1(x)))
        out = x + drop_path(dropout(moe(norm2(x))))

    In the block's dtype, LayerNorm statistics in f32. Random draws with
    ``train=True``, in order: the attention branch's drop-path, the dropout
    on the combined expert output, the MLP branch's drop-path.
    """

    def __init__(self, dim: int, num_heads: int, num_experts: int, *, mlp_ratio: float = 4.0,
                 top_k: int = 2, capacity_factor: float = 2.0, normalize_gates: bool = False,
                 drop_path_rate: float = 0.0, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, mesh=None, expert_axis: str = "expert",
                 data_axis: str | None = None, implementation: str | None = None) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.implementation = implementation
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, implementation=implementation)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MoEMlp(dim, num_experts, int(dim * mlp_ratio), top_k=top_k,
                          capacity_factor=capacity_factor, normalize_gates=normalize_gates,
                          dtype=dtype, mesh=mesh, expert_axis=expert_axis, data_axis=data_axis)
        self.dropout = Dropout(dropout_rate)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, *, pos: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, S, E) → (B, S, E) in the block's dtype."""
        kw = dict(train=train, generator=generator)
        x = x.to(self.dtype)
        if pos is not None:
            x = x + pos.to(x.dtype)
        x = x + self.drop_path(self.attn(layer_norm(x, self.norm1)), **kw)
        h = self.dropout(self.mlp(layer_norm(x, self.norm2)), **kw)
        return x + self.drop_path(h, **kw)


def collect_moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """Mean of the load-balance losses the model's :class:`MoEMlp` layers
    kept from their last forward (f32; 0 when there are none), the port's
    counterpart of collecting the sown ``intermediates/aux_loss``::

        loss = task_loss(model(x, train=True)) + 0.01 * collect_moe_aux_loss(model)
    """
    leaves = [m.aux_loss.float().reshape(()) for m in model.modules()
              if isinstance(m, MoEMlp) and m.aux_loss is not None]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.mean(torch.stack(leaves))
