"""Dynamic w8a8 int8 products for inference: ``QuantLinear`` and the
``dense`` factory.

Counterpart of ``pointvit_tpu/nn/quant.py``. :class:`QuantLinear` is an
``nn.Linear`` with the same f32 ``weight`` and ``bias``, so the weight
bridge, ``state_dict`` names and trainable masks do not change; only the
forward differs. It quantizes the weight per output channel once and keeps
the int8 weight and its scales until ``weight`` changes (an in-place update
such as ``load_state_dict`` bumps the tensor's version, a move to another
device changes its storage), and quantizes the activations per row on every
call (:mod:`pointvit_tpu_torch.ops.quant_kernel`). It is inference-only, as
in the JAX package: rounding has no useful gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from pointvit_tpu_torch._build import baked_weights, exporting, is_baking, record_baked
from pointvit_tpu_torch.ops.quant_kernel import quant_dense, quantize_weight, reference_quant_dense

__all__ = ["QuantLinear", "dense", "dynamic_quant_matmul"]


def dynamic_quant_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain int8×int8→int32 product ``x @ weight.T`` with dynamic scales,
    weight (N, K) in ``nn.Linear``'s layout; returns f32
    (``pointvit_tpu/nn/quant.py:44-65``)."""
    wq, sw = quantize_weight(weight)
    return reference_quant_dense(x, wq, sw, None, torch.float32)


class QuantLinear(nn.Linear):
    """``nn.Linear`` running its product in dynamic w8a8 int8; the output
    keeps x's dtype. ``implementation``: None (the kernel for a CUDA tensor,
    the plain version for a CPU tensor) or 'torch' (the plain version)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 implementation: str | None = None) -> None:
        super().__init__(in_features, out_features, bias=bias)
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        self.implementation = implementation
        self._quantized = None  # ((version, data_ptr, device) of weight, wq, sw)

    def quantized_weight(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(wq (N, K) int8, sw (N,) f32), rebuilt only when ``weight`` changed;
        made anew, and not kept, under ``inference_mode`` (no version counter
        to key on) and while ``torch.export`` traces (fake tensors); in an
        exported program the pair baked at export
        (:func:`~pointvit_tpu_torch._build.bake`)."""
        baked = baked_weights(self)
        if baked is not None:
            return baked
        w = self.weight
        if is_baking():
            made = quantize_weight(w)
            record_baked(self, made)
            return made
        if w.is_inference() or exporting():
            return quantize_weight(w)
        key = (w._version, w.data_ptr(), w.device)
        if self._quantized is None or self._quantized[0] != key:
            self._quantized = (key, *quantize_weight(w))
        return self._quantized[1], self._quantized[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wq, sw = self.quantized_weight()
        bias = self.bias.detach() if self.bias is not None else None
        product = reference_quant_dense if self.implementation == "torch" else quant_dense
        return product(x, wq, sw, bias, x.dtype)


def dense(quantized: bool, in_features: int, out_features: int, bias: bool = True,
          implementation: str | None = None) -> nn.Linear:
    """``QuantLinear`` when ``quantized``, else ``nn.Linear`` (the JAX
    ``dense`` factory, ``pointvit_tpu/nn/quant.py:103-107``)."""
    if quantized:
        return QuantLinear(in_features, out_features, bias, implementation)
    return nn.Linear(in_features, out_features, bias=bias)
