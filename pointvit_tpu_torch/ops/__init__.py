"""Point-cloud ops and the kernel wrappers of the APF and Pix4Point paths.

The op functions are re-exported under the JAX package's names
(``pointvit_tpu/ops/__init__.py``). ``fps_sampling_with_knn`` and
``benchmark_fps_implementations`` are not ported yet (ROADMAP A12).
Importing this package builds no kernel: each builds at its first launch.
"""

from pointvit_tpu_torch.ops.fps import farthest_point_sample, fps_gather
from pointvit_tpu_torch.ops.group import apf_group, p3_group
from pointvit_tpu_torch.ops.knn import knn_gather, knn_group, knn_indices, square_distance
from pointvit_tpu_torch.ops.morton import encode_morton3, morton_argsort, morton_codes, part1by2
from pointvit_tpu_torch.ops.render import (
    depth_intensity,
    fixed_view_angles,
    project_orthographic,
    project_points_spherical,
    rasterize_amax,
    render_diff_views,
    render_fixed_views,
    rotate_az_el,
    splat_bilinear,
)

__all__ = [
    "farthest_point_sample",
    "fps_gather",
    "knn_gather",
    "knn_group",
    "knn_indices",
    "square_distance",
    "encode_morton3",
    "morton_argsort",
    "morton_codes",
    "part1by2",
    "apf_group",
    "p3_group",
    "depth_intensity",
    "fixed_view_angles",
    "project_orthographic",
    "project_points_spherical",
    "rasterize_amax",
    "render_diff_views",
    "render_fixed_views",
    "rotate_az_el",
    "splat_bilinear",
]
