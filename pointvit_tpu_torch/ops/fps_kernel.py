"""Farthest-point sampling kernel (``csrc/fps.cu``): wrapper, launch counter
and plain version.

Counterpart of ``pointvit_tpu/ops/pallas_fps.py``. The kernel and
:func:`reference_fps` make the same selection bit for bit: both compute the
squared distance as ``((dx*dx + dy*dy) + dz*dz)`` without FMA contraction,
keep a running min-distance field that starts at +inf, and break arg-max
ties to the lowest index (``jnp.argmax``'s rule, as in ``ops/fps.py::_fps_xla``).
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch._build import INT, PTR, LaunchCounter, check, kernel, require, stream_ptr

__all__ = ["fps", "reference_fps", "launches"]

launches = LaunchCounter("fps")


def reference_fps(xyz: torch.Tensor, num_samples: int, start: torch.Tensor) -> torch.Tensor:
    """Plain torch FPS. xyz (B, N, 3) f32, start (B,) int → (B, S) int32."""
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    min_dist = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    far = start.to(torch.int64)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(num_samples):
        out[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        d = dx * dx
        d = d + dy * dy
        d = d + dz * dz
        min_dist = torch.minimum(min_dist, d)
        far = torch.argmax(min_dist, dim=1)  # first index of the max
    return out


def fps(xyz: torch.Tensor, num_samples: int, start: torch.Tensor) -> torch.Tensor:
    """FPS indices (B, S) int32: the kernel for CUDA tensors (any N; above
    14,528 points its distance field is in device memory), the plain
    version for CPU tensors."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    if not 0 < num_samples <= N:
        raise ValueError(f"num_samples={num_samples} must be in [1, N={N}]")
    if start.shape != (B,):
        raise ValueError(f"start must be ({B},), got {tuple(start.shape)}")
    if not xyz.is_cuda:
        return reference_fps(xyz, num_samples, start)
    require(xyz, "xyz", torch.float32, 3)
    require(start, "start", torch.int32, 1, xyz.device)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=xyz.device)
    # Above this N the distance field lives in a device-memory scratch.
    dist = None
    if N > kernel("fps", "pv_fps_smem_max_points", [])():
        dist = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    fn = kernel("fps", "pv_fps", [PTR, PTR, PTR, PTR, INT, INT, INT, PTR])
    err = fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
             dist.data_ptr() if dist is not None else None, B, N, num_samples,
             stream_ptr(xyz.device))
    check(err, "fps", "pv_fps")
    launches.add()
    return out
