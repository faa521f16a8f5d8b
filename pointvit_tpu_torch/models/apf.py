"""AdaptPointFormer (APF).

Counterpart of ``pointvit_tpu/models/apf.py``: FPS + Morton + kNN grouping
→ mini-PointNet group encoder → ``depth`` adapter ViT blocks → LayerNorm →
max over tokens → classification head. Module names follow the flax names
(``point_encoder``, ``blocks.{i}``, ``encoder_norm``, ``head``), so the
weight bridge (:mod:`pointvit_tpu_torch.convert`) maps a JAX checkpoint one
to one.

``forward(points, train=True, generator=g)`` is the training forward:
FPS starts at a random point of every cloud (drawn from ``g``), the group
encoder and the head use batch statistics, and dropout and drop-path draw
from ``g``. Random draws, in order: the FPS starts, each block's (see
:meth:`APFBlock.forward_unfused`), the dropout after the max-pool, the
head's two dropouts. Without a generator FPS starts at point 0, as the JAX
model does without an 'fps' PRNG stream, and dropout draws from the
default generator.

Freezing is ``requires_grad``: :func:`apf_trainable_mask` names the
trainable parameters with the JAX mask's patterns (``models/apf.py:137-164``)
and :func:`pointvit_tpu_torch.train.trainer.set_trainable` (which
``build_optimizer`` calls) applies them.

``implementation=None`` runs the kernel wrappers (the CUDA kernels for CUDA
tensors); ``'torch'`` runs every kernel's plain version on any device.

``quantized=True`` is the JAX package's serving mode: the encoder's and
blocks' products (``first_1``, ``first_2``, ``second_0_local``,
``second_1``, ``qkv``, ``proj``, ``fc1``, ``fc2``) run in dynamic w8a8 int8
(:mod:`pointvit_tpu_torch.nn.quant`), the encoder and blocks unfused. It is
inference-only: ``train=True`` raises.

``remat_encoder=True`` recomputes the group encoder's activations in the
training backward (``models/apf.py:59, 90``): less memory, the same loss,
gradients and BatchNorm statistics.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pointvit_tpu_torch.nn.heads import ClassificationHead
from pointvit_tpu_torch.nn.layers import Dropout, layer_norm
from pointvit_tpu_torch.nn.pointnet import GroupFeatureEncoder
from pointvit_tpu_torch.nn.vit import APFBlock
from pointvit_tpu_torch.ops.block_kernel import LN_EPS
from pointvit_tpu_torch.ops.fps import random_starts
from pointvit_tpu_torch.ops.group import apf_group
from pointvit_tpu_torch.utils.profiling import span

__all__ = ["AdaptPointFormer", "APF_PRESETS", "apf_preset_config", "apf_serving_preset",
           "apf_trainable_mask"]

# The benchmark's preset table (bench.py:93-103): overrides of the APF ViT-B
# configuration below. 'slim2' is the served default.
APF_PRESETS = {
    "exact": {},
    "slim": {"encoder_second_width": 768},
    "v2": {"encoder_second_width": 768, "nsample": 16},
    "k24": {"nsample": 24},
    "g160": {"npoint": 160},
    "slim_k24": {"encoder_second_width": 768, "nsample": 24},
    "stack": {"encoder_second_width": 768, "nsample": 24, "npoint": 160},
    "v3": {"encoder_second_width": 768, "nsample": 16, "npoint": 160},
    "slim2": {"encoder_second_width": 384, "nsample": 16},
}


def apf_preset_config(name: str = "slim2", **overrides) -> dict:
    """Constructor kwargs of the benchmark's ModelNet40 APF ViT-B model
    (bench.py:115-125) under preset ``name``, in bf16."""
    cfg = dict(
        num_classes=40, in_channels=3, embedding_dim=768, npoint=196, nsample=32,
        depth=12, num_heads=12, dtype=torch.bfloat16,
    )
    cfg.update(APF_PRESETS[name])
    cfg.update(overrides)
    return cfg


def apf_serving_preset(**overrides) -> dict:
    """Constructor kwargs of the JAX package's documented serving
    configuration (``pointvit_tpu/models/apf.py:117-134``): the
    reference-exact model in bf16 with the encoder's second stack at width
    768 instead of 2E, updated with ``overrides``."""
    cfg = dict(dtype=torch.bfloat16, encoder_second_width=768)
    cfg.update(overrides)
    return cfg


class AdaptPointFormer(nn.Module):
    """APF model: (B, N, C) points (C = 3 xyz [+1 height]) → (B, classes) logits."""

    def __init__(
        self,
        num_classes: int = 15,
        embedding_dim: int = 768,
        npoint: int = 196,
        nsample: int = 32,
        in_channels: int = 3,
        depth: int = 12,
        num_heads: int = 12,
        dropout_rate: float = 0.1,
        dropout_path_rate: float = 0.1,
        adapter_bottleneck: int = 64,
        dtype: torch.dtype = torch.float32,
        encoder_second_width: int | None = None,
        implementation: str | None = None,
        quantized: bool = False,
        remat_encoder: bool = False,
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.npoint = npoint
        self.nsample = nsample
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.dropout_path_rate = dropout_path_rate
        self.implementation = implementation
        self.quantized = quantized
        self.point_encoder = GroupFeatureEncoder(
            2 * in_channels, embedding_dim, encoder_second_width, dtype, implementation, quantized,
            remat=remat_encoder,
        )
        # Stochastic-depth schedule: linspace(0, rate, depth) (JAX apf.py:96).
        dpr = np.linspace(0.0, dropout_path_rate, depth).tolist()
        self.blocks = nn.ModuleList(
            APFBlock(embedding_dim, num_heads, adapter_bottleneck, dtype, implementation,
                     drop_path_rate=dpr[i], dropout_rate=dropout_rate, quantized=quantized)
            for i in range(depth)
        )
        self.encoder_norm = nn.LayerNorm(embedding_dim, eps=LN_EPS)
        self.dropout = Dropout(dropout_rate)
        self.head = ClassificationHead(embedding_dim, num_classes, implementation=implementation)

    def forward(self, points: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """points (B, N, in_channels) → logits (B, num_classes) in the model's
        dtype."""
        if points.shape[-1] != self.in_channels:
            raise ValueError(
                f"expected {self.in_channels} input channels, got {points.shape[-1]}"
            )
        if self.quantized and train:
            raise ValueError("quantized=True is an inference-only mode (int8 rounding has no "
                             "useful gradient); construct with quantized=False for training")
        with span("apf.group", device=True):
            start = random_starts(points, generator) if train and generator is not None else None
            neighborhood, _ = apf_group(
                points, points[..., :3], self.npoint, self.nsample, start=start,
                implementation=self.implementation,
            )
        with span("apf.encoder", device=True):
            x = self.point_encoder(neighborhood, train=train)
        with span("apf.blocks", device=True):
            for block in self.blocks:
                x = block(x, train=train, generator=generator)
        with span("apf.head", device=True):
            x = layer_norm(x, self.encoder_norm)
            x = x.amax(dim=-2)  # global max-pool over tokens
            x = self.dropout(x, train=train, generator=generator)
            return self.head(x, train=train, generator=generator)


def apf_trainable_mask(model: nn.Module, *, reference_quirks: bool = False) -> set[str]:
    """Names of the trainable APF parameters, by the JAX mask's patterns
    (``pointvit_tpu/models/apf.py:137-164``): adapters, head, final norm and
    point encoder train; the ViT trunk is frozen. With ``reference_quirks``
    the adapters stay frozen too, as the reference's ``_freeze`` leaves them."""
    if reference_quirks:
        patterns = ("head", "encoder_norm", "point_encoder")
    else:
        patterns = ("adapter", "head", "encoder_norm", "point_encoder")
    return {name for name, _ in model.named_parameters() if any(p in name for p in patterns)}
