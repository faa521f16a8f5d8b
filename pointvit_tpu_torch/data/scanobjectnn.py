"""ScanObjectNN with its offline FPS on the port.

The JAX package's ``ScanObjectNN`` (``pointvit_tpu/data/scanobjectnn.py``)
is numpy apart from ``_offline_fps``, which imports jax
(``scanobjectnn.py:136-146``). This subclass runs that step through the
port's :func:`~pointvit_tpu_torch.ops.fps.farthest_point_sample` (the CUDA
kernel when a card is present, its plain version on the CPU); everything
else is the JAX package's class as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from pointvit_tpu.data.scanobjectnn import ScanObjectNN as _ScanObjectNN
from pointvit_tpu_torch.ops.fps import farthest_point_sample, fps_gather

__all__ = ["ScanObjectNN"]


class ScanObjectNN(_ScanObjectNN):
    @staticmethod
    def _offline_fps(data: np.ndarray, num_points: int, chunk: int = 512) -> np.ndarray:
        """Batched FPS over the whole array, starting every cloud at point 0."""
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        out = []
        for start in range(0, len(data), chunk):
            block = torch.from_numpy(np.ascontiguousarray(data[start : start + chunk], np.float32))
            block = block.to(device)
            idx = farthest_point_sample(block, num_points)
            out.append(fps_gather(block, idx).cpu().numpy())
        return np.concatenate(out, axis=0)
