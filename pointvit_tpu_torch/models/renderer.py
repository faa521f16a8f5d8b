"""Multi-view renderer classifier: point cloud → rendered views → a ViT with
serial adapters per view → learned view aggregation → head.

Counterpart of ``pointvit_tpu/models/renderer.py`` (``:37-185``). Module and
parameter names follow the flax names (``view_transform_net``, ``vit``
(``conv_proj``, ``class_token``, ``pos_embedding``, ``encoder_layer.{i}``,
``ln``), ``view_aggregation``, ``classifier``), so the weight bridge
(:mod:`pointvit_tpu_torch.convert`) maps a JAX tree one to one.

The views of all clouds go through the ViT as one (B·V, H, W, 3) batch; the
single-channel image is broadcast to RGB at the patchify input. With
``diff_renderer`` the learned ``ViewTransformationNetwork`` picks each
cloud's camera angles (computed in the model dtype) and the bilinear splat
renders the f32 points; without it the fixed camera ring and the amax
raster do. ``implementation=None`` runs the kernel wrappers (the CUDA
kernels for CUDA tensors); ``'torch'`` runs their plain versions on any
device.

In training (``train=True``) the view network normalises by batch
statistics and updates its running ones, the ViT's blocks leave their
fused chains for ``forward_unfused`` (the attention forward and backward
kernels on the card), the patchify is a plain product with autograd, and
the head's dropouts draw from the generator given, as the JAX model trains
(``models/renderer.py:150-180``). The loss reaches the learned camera
angles through the frozen ViT, the patchify and the splat.
:func:`renderer_trainable_mask` names what trains.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from pointvit_tpu_torch.nn.heads import RendererHead
from pointvit_tpu_torch.nn.layers import batch_norm_relu, linear
from pointvit_tpu_torch.nn.vit import ImageViT
from pointvit_tpu_torch.ops.render import render_diff_views, render_fixed_views

__all__ = [
    "TORCHVISION_VIT_PRESETS",
    "ViewTransformationNetwork",
    "PointCloudRendererClassifier",
    "renderer_trainable_mask",
]

# The torchvision variants the reference supports.
TORCHVISION_VIT_PRESETS = {
    "vit_b_16": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "vit_b_32": dict(patch_size=32, embed_dim=768, depth=12, num_heads=12),
    "vit_l_16": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16),
    "vit_l_32": dict(patch_size=32, embed_dim=1024, depth=24, num_heads=16),
}


def _angle_ring(num_views: int, which: str) -> torch.Tensor:
    """The heads' initial bias: the default camera ring in radians."""
    if which == "az":
        angles = np.linspace(0.0, 360.0, num_views + 1)[:-1]
    else:
        if num_views > 6:
            raise ValueError("the default elevation ring has 6 views")
        angles = np.asarray([0.0, 30.0, -30.0, 0.0, 0.0, 0.0])[:num_views]
    return torch.from_numpy(np.deg2rad(angles)).float()


class ViewTransformationNetwork(nn.Module):
    """Per-cloud view angles: azimuth in [−π, π], elevation in [−π/3, π/3].
    Three pointwise Linear → BatchNorm → ReLU layers (64, 128, hidden), a max
    over points, two Linear → ReLU, and the two heads (zero weights, the
    camera ring as bias), all in ``dtype``. The BatchNorms use batch
    statistics in training
    (:func:`~pointvit_tpu_torch.nn.layers.batch_norm_relu`: flax's momentum
    0.9 and biased variance), running ones otherwise."""

    def __init__(self, num_views: int = 6, hidden_dim: int = 256,
                 dtype: torch.dtype = torch.float32, implementation: str | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.implementation = implementation
        widths = (3, 64, 128, hidden_dim)
        for i in range(3):
            setattr(self, f"enc{i}", nn.Linear(widths[i], widths[i + 1]))
            setattr(self, f"enc_bn{i}", nn.BatchNorm1d(widths[i + 1], eps=1e-5, momentum=0.1))
        self.pred0 = nn.Linear(hidden_dim, hidden_dim)
        self.pred1 = nn.Linear(hidden_dim, hidden_dim)
        self.azimuth_head = nn.Linear(hidden_dim, num_views)
        self.elevation_head = nn.Linear(hidden_dim, num_views)
        with torch.no_grad():
            for head, which in ((self.azimuth_head, "az"), (self.elevation_head, "el")):
                head.weight.zero_()
                head.bias.copy_(_angle_ring(num_views, which))

    def forward(self, points: torch.Tensor, *,
                train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3) → (azimuth, elevation), each (B, V) in radians."""
        x = points.to(self.dtype)
        for i in range(3):
            h = linear(x, getattr(self, f"enc{i}"))
            x = batch_norm_relu(h, getattr(self, f"enc_bn{i}"), train=train,
                                implementation=self.implementation)
        x = x.amax(dim=1)
        for fc in (self.pred0, self.pred1):
            x = torch.relu(linear(x, fc))
        az = torch.tanh(linear(x, self.azimuth_head)) * math.pi
        el = torch.tanh(linear(x, self.elevation_head)) * (math.pi / 3)
        return az, el


class PointCloudRendererClassifier(nn.Module):
    """Render → per-view ViT with serial adapters → softmax-weighted sum over
    views → ``RendererHead``: (B, N, 3) f32 points → (B, classes) logits in
    the model's dtype."""

    def __init__(self, num_classes: int = 15, vit_name: str = "vit_b_16", adapter_dim: int = 64,
                 num_views: int = 6, img_size: int = 224, diff_renderer: bool = False,
                 view_transform_hidden: int = 256, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, implementation: str | None = None) -> None:
        super().__init__()
        preset = TORCHVISION_VIT_PRESETS.get(vit_name)
        if preset is None:
            raise ValueError(f"unsupported ViT model: {vit_name!r}")
        self.num_views = num_views
        self.img_size = img_size
        self.diff_renderer = diff_renderer
        self.dtype = dtype
        if diff_renderer:
            self.view_transform_net = ViewTransformationNetwork(
                num_views, view_transform_hidden, dtype=dtype, implementation=implementation)
        self.vit = ImageViT(preset["depth"], preset["embed_dim"], preset["num_heads"],
                            preset["patch_size"], img_size, adapter_dim, dtype=dtype,
                            implementation=implementation)
        self.view_aggregation = nn.Parameter(torch.full((num_views,), 1.0 / num_views))
        self.classifier = RendererHead(preset["embed_dim"], num_classes, dropout_rate)

    def render_views(self, points: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """(B, N, 3) → (B, V, H, W) depth-shaded views."""
        B, N, _ = points.shape
        V, S = self.num_views, self.img_size
        if not self.diff_renderer:
            return render_fixed_views(points, S, V)
        az, el = self.view_transform_net(points, train=train)
        flat = points[:, None].expand(B, V, N, 3).reshape(B * V, N, 3)
        views = render_diff_views(flat, az.to(points.dtype).reshape(-1),
                                  el.to(points.dtype).reshape(-1), S)
        return views.reshape(B, V, S, S)

    def predict_views(self, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The learned view angles in degrees, each (B, V)."""
        if not self.diff_renderer:
            raise ValueError("predict_views requires diff_renderer=True")
        az, el = self.view_transform_net(points)
        return torch.rad2deg(az), torch.rad2deg(el)

    def forward(self, points: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B = points.shape[0]
        V, S = self.num_views, self.img_size
        views = self.render_views(points, train=train)
        images = views.reshape(B * V, S, S, 1).expand(B * V, S, S, 3).to(self.dtype)
        feats = self.vit(images, train=train, generator=generator).reshape(B, V, -1)
        # Softmax and weighted sum in the compute dtype, as the JAX model.
        v = self.view_aggregation.to(feats.dtype)
        e = torch.exp(v - v.amax())
        agg = torch.einsum("bvc,v->bc", feats, e / e.sum())
        return self.classifier(agg, train=train, generator=generator)


def renderer_trainable_mask(model: nn.Module) -> set[str]:
    """Names of the trainable renderer parameters
    (``pointvit_tpu/models/renderer.py:188-203``): inside the ViT (``vit.*``)
    only the adapters'; outside it everything (the view network, the view
    aggregation, the head)."""
    return {name for name, _ in model.named_parameters()
            if not name.startswith("vit.") or "adapter" in name}
