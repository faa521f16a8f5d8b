"""APF point grouping: FPS centres → Morton order → kNN neighbourhoods.

Counterpart of ``pointvit_tpu/ops/group.py::apf_group``. The centres are
Morton-sorted *before* grouping: each group's kNN is independent of the
others, so this gives the reference's post-hoc sort of the (B, G, K, 2C)
tensor without that gather (``group.py:106-112``). The centre's feature is
neighbour row 0: an FPS centre is a support point at distance 0, and its
packed key has the lowest index among exact duplicates (``group.py:117-119``).
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch.ops import knn_kernel
from pointvit_tpu_torch.ops.fps import farthest_point_sample, fps_gather
from pointvit_tpu_torch.ops.morton import morton_argsort

__all__ = ["apf_group"]


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
    if implementation == "torch":
        _, grouped = knn_kernel.reference_knn_group(xyz, center, feats, group_size)
    else:
        _, grouped = knn_kernel.knn_group(xyz, center, feats, group_size)
    center_feat = grouped[:, :, :1, :]
    neighborhood = torch.cat(
        [grouped - center_feat, center_feat.expand_as(grouped)], dim=-1
    )
    return neighborhood, center
