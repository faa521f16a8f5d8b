"""Model factory: one reference-style config dict → one module, per family.

Counterpart of ``pointvit_tpu/models/factory.py`` (``:21-111``), construction
for construction, so a checkpoint's ``model_config`` rebuilds its
architecture. ``bf16`` (default True) selects the compute dtype; parameters
are always f32. ``implementation`` (None: kernel wrappers; 'torch': plain
versions) is the port's own switch.
"""

from __future__ import annotations

import torch

__all__ = ["FAMILIES", "detect_family", "build_model"]

FAMILIES = ("apf", "pix4point", "renderer")


def detect_family(model_config: dict) -> str:
    """The model family from the reference config-dict keys:
    ``pretrained_model`` → Pix4Point; ``num_views`` → renderer;
    ``in_channels`` → APF."""
    if "pretrained_model" in model_config:
        return "pix4point"
    if "num_views" in model_config:
        return "renderer"
    if "in_channels" in model_config:
        return "apf"
    raise ValueError(
        f"cannot infer model family from model_config keys {sorted(model_config)}; "
        "pass family= explicitly"
    )


def build_model(model_config: dict, family: str | None = None, *,
                implementation: str | None = None) -> torch.nn.Module:
    """Build the family's module from a reference-style config dict, as the
    JAX factory does."""
    family = family or detect_family(model_config)
    dtype = torch.bfloat16 if model_config.get("bf16", True) else torch.float32

    if family == "apf":
        from pointvit_tpu_torch.models.apf import AdaptPointFormer

        if model_config.get("remat_encoder", False):
            raise NotImplementedError("remat_encoder=True (recomputed encoder activations in "
                                      "training) is not ported (ROADMAP A12)")
        return AdaptPointFormer(
            num_classes=model_config["num_classes"],
            in_channels=model_config["in_channels"],
            embedding_dim=model_config.get("embedding_dim", 768),
            npoint=model_config.get("npoint", 196),
            nsample=model_config.get("nsample", 32),
            dropout_rate=model_config.get("dropout_rate", 0.1),
            # The reference reads drop_path_rate while its entry script
            # supplies dropout_path_rate: both spellings are honoured.
            dropout_path_rate=model_config.get(
                "drop_path_rate", model_config.get("dropout_path_rate", 0.1)),
            depth=model_config.get("depth", 12),
            num_heads=model_config.get("num_heads", 12),
            dtype=dtype,
            encoder_second_width=model_config.get("encoder_second_width"),
            implementation=implementation,
            quantized=model_config.get("quantized", False),
        )
    if family == "pix4point":
        from pointvit_tpu_torch.models.pix4point import Pix4Point

        overrides = {k: model_config[k] for k in ("depth", "num_heads", "moe_experts", "moe_every",
                                                  "moe_top_k", "moe_normalize_gates")
                     if k in model_config}
        return Pix4Point.from_pretrained_name(
            model_config["pretrained_model"],
            num_classes=model_config["num_classes"],
            k_neighbors=model_config["k_neighbors"],
            embed_dim=model_config["embed_dim"],
            dtype=dtype,
            implementation=implementation,
            **overrides,
        )
    if family == "renderer":
        from pointvit_tpu_torch.models.renderer import PointCloudRendererClassifier

        return PointCloudRendererClassifier(
            num_classes=model_config["num_classes"],
            vit_name=model_config["vit_name"],
            adapter_dim=model_config["adapter_dim"],
            num_views=model_config["num_views"],
            img_size=model_config["img_size"],
            dropout_rate=model_config["dropout_rate"],
            diff_renderer=model_config.get("diff_renderer", False),
            view_transform_hidden=model_config.get("view_transform_hidden", 256),
            dtype=dtype,
            implementation=implementation,
        )
    raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")
