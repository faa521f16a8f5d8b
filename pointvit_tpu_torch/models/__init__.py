"""Model families of the port (APF in this slice)."""

from pointvit_tpu_torch.models.apf import (
    APF_PRESETS,
    AdaptPointFormer,
    apf_preset_config,
    apf_trainable_mask,
)

__all__ = ["AdaptPointFormer", "APF_PRESETS", "apf_preset_config", "apf_trainable_mask"]
