"""Farthest-point sampling and index gathers.

Counterpart of ``pointvit_tpu/ops/fps.py``. The start point is an explicit
(B,) index tensor; ``None`` starts every cloud at index 0, as the JAX
package does without a PRNG key (``ops/fps.py:104-105``). A JAX PRNG start
cannot be reproduced in torch, so callers that want random starts draw them
with their own ``torch.Generator``.
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch.ops import fps_kernel

__all__ = ["farthest_point_sample", "fps_gather", "random_starts"]


def farthest_point_sample(
    xyz: torch.Tensor,
    num_samples: int,
    start: torch.Tensor | None = None,
    *,
    implementation: str | None = None,
) -> torch.Tensor:
    """Select ``num_samples`` well-spread point indices per cloud.

    Args:
        xyz: (B, N, 3) float32 coordinates.
        num_samples: S ≤ N.
        start: (B,) start indices, or None for index 0.
        implementation: None (the kernel wrapper: the CUDA kernel on a CUDA
            tensor, its plain version on a CPU tensor) or 'torch' (the plain
            version on any device).

    Returns:
        (B, S) int32 indices; ties go to the lowest index.
    """
    B = xyz.shape[0]
    if start is None:
        start = torch.zeros((B,), dtype=torch.int32, device=xyz.device)
    start = start.to(device=xyz.device, dtype=torch.int32)
    xyz = xyz.to(torch.float32).contiguous()
    if implementation == "torch":
        return fps_kernel.reference_fps(xyz, num_samples, start)
    if implementation is not None:
        raise ValueError(f"unknown implementation: {implementation!r}")
    return fps_kernel.fps(xyz, num_samples, start)


def random_starts(points: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(B,) FPS start indices of the (B, N, C) clouds, uniform over the N
    points and drawn from ``generator`` on its own device: the port's
    counterpart of the JAX package's key → start (``ops/fps.py:104-107``)."""
    B, N = points.shape[:2]
    return torch.randint(0, N, (B,), generator=generator, device=generator.device)


def fps_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-batch rows by index. points (B, N, C); idx (B, S) or
    (B, S, K) → (B, S, C) or (B, S, K, C)."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"idx must be rank 2 or 3, got {tuple(idx.shape)}")
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).to(torch.int64)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)
