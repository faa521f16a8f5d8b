"""Serving: a model behind a ladder of batch buckets.

Counterpart of ``pointvit_tpu/serve.py::InferenceSession``
(``serve.py:85-209``). A request of n clouds is padded up to the smallest
bucket that holds it by repeating its last cloud, a request larger than the
top bucket runs in top-bucket chunks, and the logits are sliced back to n.
Serving a few fixed batch shapes keeps the kernels' launch shapes, and the
memory they take, to a known set.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["InferenceSession"]

_DEFAULT_BUCKETS = (8, 32, 128, 256)


class InferenceSession:
    """A model in inference mode on ``device`` behind a bucket ladder.

    Args:
        model: an ``AdaptPointFormer``, ``Pix4Point`` or
            ``PointCloudRendererClassifier`` (any module mapping (B, N, C)
            float32 points to (B, classes) logits).
        buckets: batch sizes to serve; requests pad to the smallest that fits.
        device: where the model and the requests run: the card unless the
            caller asks for another device (the CPU tests pass ``"cpu"``).
    """

    def __init__(self, model: torch.nn.Module, buckets=_DEFAULT_BUCKETS, device="cuda") -> None:
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.device = torch.device(device)
        self.model = model.eval().to(self.device)

    @torch.inference_mode()
    def _forward(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).to(self.device)
        return self.model(x).float().cpu().numpy()

    def warmup(self, example: np.ndarray) -> None:
        """Run every bucket once; ``example`` is one (N, C) cloud. This also
        fills the model's per-device caches (a quantized model's int8
        weights), so the first request served does not build them."""
        for b in self.buckets:
            self._forward(np.broadcast_to(example, (b,) + tuple(example.shape)))

    def predict_logits(self, points: np.ndarray) -> np.ndarray:
        """(n, N, C) clouds → (n, classes) float32 logits, any n ≥ 1."""
        points = np.asarray(points, dtype=np.float32)
        n = points.shape[0]
        if n < 1:
            raise ValueError("a request needs at least one cloud")
        cap = self.buckets[-1]
        if n > cap:
            return np.concatenate(
                [self.predict_logits(points[i : i + cap]) for i in range(0, n, cap)], axis=0
            )
        bucket = next(b for b in self.buckets if b >= n)
        if n < bucket:
            pad = np.broadcast_to(points[-1:], (bucket - n,) + points.shape[1:])
            points = np.concatenate([points, pad], axis=0)
        return self._forward(points)[:n]

    def predict(self, points: np.ndarray) -> np.ndarray:
        """(n, N, C) clouds → (n,) class ids."""
        return np.argmax(self.predict_logits(points), axis=-1)
