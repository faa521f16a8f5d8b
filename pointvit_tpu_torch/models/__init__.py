"""Model families of the port: APF, Pix4Point and the renderer classifier,
and the factory that builds each from a reference-style config dict."""

from pointvit_tpu_torch.models.apf import (
    APF_PRESETS,
    AdaptPointFormer,
    apf_preset_config,
    apf_serving_preset,
    apf_trainable_mask,
)
from pointvit_tpu_torch.models.factory import build_model, detect_family
from pointvit_tpu_torch.models.pix4point import (
    VIT_PRESETS,
    PointViT,
    Pix4Point,
    pix4point_trainable_mask,
)
from pointvit_tpu_torch.models.renderer import (
    TORCHVISION_VIT_PRESETS,
    PointCloudRendererClassifier,
    ViewTransformationNetwork,
    renderer_trainable_mask,
)

__all__ = [
    "APF_PRESETS",
    "AdaptPointFormer",
    "PointCloudRendererClassifier",
    "PointViT",
    "Pix4Point",
    "TORCHVISION_VIT_PRESETS",
    "VIT_PRESETS",
    "ViewTransformationNetwork",
    "apf_preset_config",
    "apf_serving_preset",
    "apf_trainable_mask",
    "build_model",
    "detect_family",
    "pix4point_trainable_mask",
    "renderer_trainable_mask",
]
