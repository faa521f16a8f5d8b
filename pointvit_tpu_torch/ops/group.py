"""Point grouping: FPS centres → kNN neighbourhoods.

Counterpart of ``pointvit_tpu/ops/group.py``:

- :func:`apf_group` (APF): the centres are Morton-sorted *before* grouping:
  each group's kNN is independent of the others, so this gives the
  reference's post-hoc sort of the (B, G, K, 2C) tensor without that gather
  (``group.py:106-112``). The centre's feature is neighbour row 0: an FPS
  centre is a support point at distance 0, and its packed key has the lowest
  index among exact duplicates (``group.py:117-119``).
- :func:`p3_group` (one Pix4Point P3Embed stage, ``group.py:137-182``): FPS
  centres from ``start`` (index 0 without it) and the kNN gather of points
  and features, with the grouped coordinates absolute unless
  ``relative_pos``.

Both take the packed-key kNN kernel where the JAX package takes its Pallas
kNN (lane-aligned N ≤ 2048, :func:`_packed_knn_ok`) and the exact top-k of
:mod:`~pointvit_tpu_torch.ops.knn` for any other N, as the JAX package runs
XLA there (``group.py:56-68``).
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch.ops import knn_kernel
from pointvit_tpu_torch.ops.fps import farthest_point_sample, fps_gather
from pointvit_tpu_torch.ops.knn import knn_gather, knn_group, knn_indices
from pointvit_tpu_torch.ops.morton import morton_argsort

__all__ = ["apf_group", "p3_group"]


def _packed_knn_ok(n_points: int) -> bool:
    """The JAX package's gate for the packed-key kNN kernel on its
    accelerator (``group.py:48-53``): lane-aligned N, at most 2048 points
    (the point index lives in the distance key's low bits)."""
    return n_points % 128 == 0 and n_points <= 2048


def apf_group(
    x: torch.Tensor,
    xyz: torch.Tensor,
    num_group: int,
    group_size: int,
    *,
    start: torch.Tensor | None = None,
    implementation: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group features around FPS centres and serialise by Morton order.

    Args:
        x: (B, N, C) per-point features.
        xyz: (B, N, 3) coordinates for sampling and ordering.
        num_group: G centres.
        group_size: K neighbours per centre.
        start: (B,) FPS start indices; None starts every cloud at index 0.
        implementation: None (kernel wrappers) or 'torch' (plain versions).

    Returns:
        neighborhood (B, G, K, 2C) float32: centre-relative features
        concatenated with the centre feature, groups in Morton order;
        center (B, G, 3) Morton-ordered centres.
    """
    xyz = xyz.to(torch.float32).contiguous()
    fps_idx = farthest_point_sample(xyz, num_group, start, implementation=implementation)
    center = fps_gather(xyz, fps_idx)
    order = morton_argsort(center)
    center = torch.gather(center, 1, order[..., None].expand(-1, -1, 3)).contiguous()

    feats = x.to(torch.float32).contiguous()
    if _packed_knn_ok(xyz.shape[1]):
        group = knn_kernel.reference_knn_group if implementation == "torch" else knn_kernel.knn_group
        _, grouped = group(xyz, center, feats, group_size)
    else:
        grouped = knn_gather(feats, knn_indices(center, xyz, group_size))
    center_feat = grouped[:, :, :1, :]
    neighborhood = torch.cat(
        [grouped - center_feat, center_feat.expand_as(grouped)], dim=-1
    )
    return neighborhood, center


def p3_group(
    points: torch.Tensor,
    features: torch.Tensor,
    num_samples: int,
    k: int,
    *,
    start: torch.Tensor | None = None,
    relative_pos: bool = False,
    implementation: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One progressive-tokenizer grouping stage (Pix4Point P3Embed).

    Args:
        points: (B, N, 3) coordinates.
        features: (B, N, D) features.
        num_samples: S FPS centres.
        k: neighbours per centre.
        start: (B,) FPS start indices (the JAX package's key → start,
            ``ops/fps.py:104-107``); None starts every cloud at index 0.
        relative_pos: return centre-relative grouped coordinates; False
            (the reference) keeps them absolute.
        implementation: None (kernel wrappers) or 'torch' (plain versions).

    Returns:
        (centers (B, S, 3), grouped_points (B, S, k, 3), grouped_features
        (B, S, k, D)), float32. For lane-aligned N ≤ 2048, one
        packed-key kNN gathers [points ‖ features] and splits it, as the JAX
        package does on its accelerator; otherwise an exact top-k.
    """
    points = points.to(torch.float32).contiguous()
    feats = features.to(torch.float32)
    fps_idx = farthest_point_sample(points, num_samples, start, implementation=implementation)
    centers = fps_gather(points, fps_idx).contiguous()
    if _packed_knn_ok(points.shape[1]):
        combined = torch.cat([points, feats], dim=-1).contiguous()
        group = knn_kernel.reference_knn_group if implementation == "torch" else knn_kernel.knn_group
        _, grouped = group(points, centers, combined, k)
        grouped_points, grouped_features = grouped[..., :3], grouped[..., 3:]
    else:
        grouped_points, grouped_features = knn_group(points, centers, feats, k)
    if relative_pos:
        grouped_points = grouped_points - centers[:, :, None, :]
    return centers, grouped_points, grouped_features
