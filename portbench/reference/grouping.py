"""Point grouping of the plain reference: farthest-point sampling, Morton
order and the packed-key k-nearest-neighbour gather, in plain torch.

These are the algorithms' definitions, frozen here so that a change to the
program cannot move them:

- FPS keeps, for every point, its squared distance (summed x, y, z in that
  order) to the nearest centre chosen so far, and takes the first index of
  the largest as the next centre; ``start`` is the first centre.
- Morton order normalises each cloud's centres to a 10-bit grid per axis,
  interleaves the bits (x lowest) and sorts stably.
- kNN ranks the points of a cloud by one int32 key a (centre, point) pair:
  the bits of the f32 squared distance with the low ``lane_bits(N)`` bits
  replaced by the point's index, so ties go to the lowest index and the
  order is total.
"""

from __future__ import annotations

import torch

__all__ = ["fps", "gather", "morton_argsort", "knn_group", "apf_group", "p3_group"]


def fps(xyz: torch.Tensor, num_samples: int, start: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) f32 → (B, S) int64 centre indices."""
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    far = (torch.zeros(B, dtype=torch.int64, device=xyz.device) if start is None
           else start.to(device=xyz.device, dtype=torch.int64))
    min_dist = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    out = torch.empty((B, num_samples), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(num_samples):
        out[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        min_dist = torch.minimum(min_dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(min_dist, dim=1)
    return out


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) → (B, ..., C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).to(torch.int64)
    return torch.gather(points, 1, flat[..., None].expand(-1, -1, C)).reshape(*idx.shape, C)


def _spread(n: torch.Tensor) -> torch.Tensor:
    n = n.to(torch.int64) & 0x3FF
    n = (n ^ (n << 16)) & 0xFF0000FF
    n = (n ^ (n << 8)) & 0x0300F00F
    n = (n ^ (n << 4)) & 0x030C30C3
    return (n ^ (n << 2)) & 0x09249249


def morton_argsort(points: torch.Tensor) -> torch.Tensor:
    """(B, S, 3) → (B, S) int64: the stable sort along the Z-order curve."""
    lo = points.amin(dim=1, keepdim=True)
    hi = points.amax(dim=1, keepdim=True)
    cell = (((points - lo) / (hi - lo + 1e-8)) * 1023).to(torch.int32)
    code = (_spread(cell[..., 2]) << 2) + (_spread(cell[..., 1]) << 1) + _spread(cell[..., 0])
    return torch.argsort(code, dim=1, stable=True)


def _lane_bits(n: int) -> int:
    bits = 10
    while (1 << bits) < n:
        bits += 1
    return bits


def knn_group(points: torch.Tensor, centers: torch.Tensor, features: torch.Tensor,
              k: int, rows: int = 64) -> torch.Tensor:
    """The features (B, S, k, C) of each centre's k nearest points, nearest
    first; ``rows`` centres at a time, so that the (B, rows, N) keys fit."""
    B, N, _ = points.shape
    mask = (1 << _lane_bits(N)) - 1
    lane = torch.arange(N, dtype=torch.int32, device=points.device)
    out = []
    for s in range(0, centers.shape[1], rows):
        c = centers[:, s:s + rows]
        d = None
        for a in range(3):
            diff = c[:, :, a, None] - points[:, None, :, a]
            d = diff * diff if d is None else d + diff * diff
        keys = (d.view(torch.int32) & ~mask) | lane
        idx = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values & mask
        out.append(gather(features, idx))
    return torch.cat(out, dim=1)


def apf_group(points: torch.Tensor, num_group: int, group_size: int,
              start: torch.Tensor | None = None) -> torch.Tensor:
    """APF's grouping of (B, N, C) clouds (xyz first): FPS centres in Morton
    order, each with its k nearest points; returns (B, G, K, 2C) rows of
    [point − centre point, centre point], the centre being its own nearest."""
    xyz = points[..., :3].float().contiguous()
    center = gather(xyz, fps(xyz, num_group, start))
    center = gather(center, morton_argsort(center))
    grouped = knn_group(xyz, center, points.float(), group_size)
    first = grouped[:, :, :1]
    return torch.cat([grouped - first, first.expand_as(grouped)], dim=-1)


def p3_group(points: torch.Tensor, features: torch.Tensor, num_samples: int, k: int,
             start: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One P3 stage's grouping: FPS centres (not reordered) and, per centre,
    its k nearest points as [absolute xyz ‖ features]; returns (centres
    (B, S, 3), groups (B, S, k, 3 + C))."""
    xyz = points.float().contiguous()
    centers = gather(xyz, fps(xyz, num_samples, start))
    groups = knn_group(xyz, centers, torch.cat([xyz, features.float()], dim=-1), k)
    return centers, groups
