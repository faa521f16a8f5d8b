"""Modules of the APF, Pix4Point and renderer models: layers, point
encoders, transformer blocks (the MoE block too), heads."""

from pointvit_tpu_torch.nn.layers import (
    AdapterLayer,
    Attention,
    DropPath,
    Identity,
    Mlp,
    SimpleAdapter,
)
from pointvit_tpu_torch.nn.moe import MoEMlp, MoEViTBlock, collect_moe_aux_loss
from pointvit_tpu_torch.nn.vit import APFBlock, ImageViT, SerialAdapterBlock, ViTBlock
from pointvit_tpu_torch.nn.pointnet import GroupFeatureEncoder, P3Embed, PosEmbedMLP
from pointvit_tpu_torch.nn.heads import ClassificationHead, ClsHead, RendererHead

__all__ = [
    "AdapterLayer",
    "Attention",
    "DropPath",
    "Identity",
    "Mlp",
    "MoEMlp",
    "MoEViTBlock",
    "SimpleAdapter",
    "collect_moe_aux_loss",
    "APFBlock",
    "ImageViT",
    "SerialAdapterBlock",
    "ViTBlock",
    "GroupFeatureEncoder",
    "P3Embed",
    "PosEmbedMLP",
    "ClassificationHead",
    "ClsHead",
    "RendererHead",
]
