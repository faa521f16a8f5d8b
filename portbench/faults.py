"""Faults planted under the timed path, to show that the check of
``correct`` catches them (:mod:`portbench.calibrate`, the tests):

- ``altered``: one answer of every forward altered where it is produced
  (its logits reversed);
- ``half_batch``: half of the batch left out, the other half's answers
  given in its place.

:class:`Stand_in` puts a plain function of the clouds in the model's place.
"""

from __future__ import annotations

import torch

__all__ = ["Stand_in", "planted", "FAULTS"]

FAULTS = ("altered", "half_batch")


class Stand_in(torch.nn.Module):
    def __init__(self, fn, in_channels: int = 3) -> None:
        super().__init__()
        self.fn, self.in_channels = fn, in_channels

    def forward(self, points: torch.Tensor, **_) -> torch.Tensor:
        return self.fn(points)


def _altered(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[0] = out[0].flip(-1)
    return out


def _half_batch(out: torch.Tensor) -> torch.Tensor:
    half = (len(out) + 1) // 2
    return torch.cat([out[:half], out[:half]])[: len(out)]


def planted(model: torch.nn.Module, fault: str) -> torch.nn.Module:
    """``model`` whose every forward's output carries ``fault``."""
    change = {"altered": _altered, "half_batch": _half_batch}[fault]
    model.register_forward_hook(lambda _m, _a, out: change(out))
    return model
