"""Pix4Point: progressive point-patch tokenizer → 2D ViT trunk.

Counterpart of ``pointvit_tpu/models/pix4point.py`` (``:26-194``): P3Embed
(FPS + kNN conv tokenizer, 2048 → 512 tokens of width 256) → ``proj`` to the
ViT width → learned 3D positional MLP → cls token prepended → ``depth`` ViT
blocks with the positional embedding re-added before *every* block → final
LayerNorm → global feature (``global_features``: by default [max over
tokens ‖ cls token]) → ``ClsHead``. Module names follow the flax names
(``model.patch_embed``, ``model.proj``, ``model.pos_embed``,
``model.cls_token``, ``model.cls_pos``, ``model.blocks.{i}``,
``model.norm``, ``cls_head``), so the weight bridge
(:mod:`pointvit_tpu_torch.convert`) maps a JAX tree one to one.

``implementation=None`` runs the kernel wrappers (the CUDA kernels for CUDA
tensors); ``'torch'`` runs every kernel's plain version on any device.

``forward(points, train=True, generator=g)`` is the training forward: FPS
starts at a random point of every cloud (drawn from ``g``), the P3 stage
and the head use batch statistics, the blocks run unfused (attention
through the forward and backward kernels on the card) and every dropout
draws from ``g``. Random draws, in order: the FPS starts, each block's
(none at the trunk's dropout 0, the model's default, as in JAX), the
head's two dropouts. Freezing is ``requires_grad``:
:func:`pix4point_trainable_mask` names the parameters that train.

With ``moe_experts > 0`` every ``moe_every``-th block (``i % moe_every ==
moe_every − 1``, ``pix4point.py:111-121``) is a
:class:`~pointvit_tpu_torch.nn.moe.MoEViTBlock`: its attention through the
attention kernels, its MLP E experts of which each token visits
``moe_top_k``, expert-parallel over ``moe_mesh`` when one is given. Each
training forward leaves the router load-balance losses on the MoE layers
(:func:`~pointvit_tpu_torch.nn.moe.collect_moe_aux_loss`).
"""

from __future__ import annotations

import torch
from torch import nn

from pointvit_tpu_torch.nn.heads import ClsHead
from pointvit_tpu_torch.nn.layers import layer_norm, linear
from pointvit_tpu_torch.nn.moe import MoEViTBlock
from pointvit_tpu_torch.nn.pointnet import P3Embed, PosEmbedMLP
from pointvit_tpu_torch.nn.vit import ViTBlock
from pointvit_tpu_torch.ops.block_kernel import LN_EPS

__all__ = ["PointViT", "Pix4Point", "VIT_PRESETS", "pix4point_trainable_mask"]

# Depth / heads / width of the timm backbones the reference names.
VIT_PRESETS = {
    "vit_small_patch16_384.augreg_in21k_ft_in1k": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_small_patch16_384": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch16_384.augreg_in21k_ft_in1k": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch16_384": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12),
}


class PointViT(nn.Module):
    """Point tokenizer + ViT trunk → the global feature (B, n·E): for each
    comma-separated entry of ``global_features``, in order, the cls token
    and/or the max over the tokens, as the JAX loop takes them
    (``pix4point.py:135-142``); the default ``'max,cls'`` gives [max ‖ cls].
    ``in_channels`` is the width of the ``features`` input (the coordinates
    themselves when it is None); ``dropout_rate`` goes to every block."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 k_neighbors: int = 16, in_channels: int = 3, global_features: str = "max,cls",
                 dropout_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 implementation: str | None = None, moe_experts: int = 0, moe_every: int = 2,
                 moe_top_k: int = 2, moe_normalize_gates: bool = False, moe_mesh=None,
                 moe_expert_axis: str = "expert", moe_data_axis: str | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.moe_experts = moe_experts
        self.global_features = global_features
        self.num_features = embed_dim * sum(
            ("cls" in t) + ("max" in t) for t in global_features.split(","))
        # PointViT passes no embed_dim to P3Embed: its tokens are 256 wide.
        self.patch_embed = P3Embed(in_channels, k=k_neighbors, dtype=dtype,
                                   implementation=implementation)
        self.proj = nn.Linear(self.patch_embed.embed_dim, embed_dim)
        self.pos_embed = PosEmbedMLP(embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, embed_dim))
        self.cls_pos = nn.Parameter(0.02 * torch.randn(1, 1, embed_dim))
        def block(i):
            if moe_experts and i % moe_every == moe_every - 1:
                return MoEViTBlock(embed_dim, num_heads, moe_experts, top_k=moe_top_k,
                                   normalize_gates=moe_normalize_gates, dropout_rate=dropout_rate,
                                   dtype=dtype, mesh=moe_mesh, expert_axis=moe_expert_axis,
                                   data_axis=moe_data_axis, implementation=implementation)
            return ViTBlock(embed_dim, num_heads, dtype=dtype, implementation=implementation,
                            dropout_rate=dropout_rate)

        self.blocks = nn.ModuleList(block(i) for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, points: torch.Tensor, features: torch.Tensor | None = None, *,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        B = points.shape[0]
        if features is None:  # the reference clones the coordinates as the features
            features = points
        centers, tokens = self.patch_embed(points, features, train=train, generator=generator)
        x = linear(tokens, self.proj)
        pos = self.pos_embed(centers)
        E = x.shape[-1]
        x = torch.cat([self.cls_token.expand(B, 1, E).to(x.dtype), x], dim=1)
        pos = torch.cat([self.cls_pos.expand(B, 1, E).to(pos.dtype), pos], dim=1).contiguous()
        for block in self.blocks:  # pos is re-added before every block
            x = block(x, pos=pos, train=train, generator=generator)
        x = layer_norm(x, self.norm)
        feats = []
        for token_type in self.global_features.split(","):
            if "cls" in token_type:
                feats.append(x[:, 0])
            if "max" in token_type:
                feats.append(x[:, 1:].amax(dim=1))
        return torch.cat(feats, dim=-1)


class Pix4Point(nn.Module):
    """Pix4Point classifier: (B, N, 3) points → (B, classes) logits in the
    model's dtype. The ``moe_*`` options shape the MoE trunk (see
    :class:`PointViT`)."""

    def __init__(self, num_classes: int = 15, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, k_neighbors: int = 16, dtype: torch.dtype = torch.float32,
                 implementation: str | None = None, moe_experts: int = 0, moe_every: int = 2,
                 moe_top_k: int = 2, moe_normalize_gates: bool = False, moe_mesh=None,
                 moe_expert_axis: str = "expert", moe_data_axis: str | None = None) -> None:
        super().__init__()
        self.moe_experts = moe_experts
        self.model = PointViT(embed_dim, depth, num_heads, k_neighbors, dtype=dtype,
                              implementation=implementation, moe_experts=moe_experts,
                              moe_every=moe_every, moe_top_k=moe_top_k,
                              moe_normalize_gates=moe_normalize_gates, moe_mesh=moe_mesh,
                              moe_expert_axis=moe_expert_axis, moe_data_axis=moe_data_axis)
        self.cls_head = ClsHead(self.model.num_features, num_classes)

    @classmethod
    def from_pretrained_name(cls, pretrained_model: str, **kwargs) -> "Pix4Point":
        """Build with the depth, heads and width of a named timm backbone,
        with seeded weights: the backbone's own come from the weight cache
        through :func:`~pointvit_tpu_torch.pretrained.load_pix4point_vit_weights`
        (``Pix4PointTrainer`` with ``pretrained``)."""
        preset = VIT_PRESETS.get(pretrained_model)
        if preset is None:
            raise ValueError(f"unknown backbone preset: {pretrained_model!r}")
        return cls(**{**preset, **kwargs})

    def forward(self, points: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feat = self.model(points, train=train, generator=generator)
        return self.cls_head(feat, train=train, generator=generator)


def pix4point_trainable_mask(model: nn.Module, *, frozen: bool = False) -> set[str]:
    """Names of the trainable Pix4Point parameters
    (``pointvit_tpu/models/pix4point.py:197-223``): every parameter, or with
    ``frozen=True`` all but the ViT trunk's blocks and final norm
    (``model.blocks.*``, ``model.norm.*``). ``cls_token`` and ``cls_pos``
    stay trainable, as in JAX and the reference."""
    names = [name for name, _ in model.named_parameters()]
    if not frozen:
        return set(names)
    trunk = ("blocks", "norm")
    return {n for n in names if not any(part in trunk for part in n.split("."))}
