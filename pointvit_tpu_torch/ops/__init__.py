"""Point-cloud ops and the kernel wrappers of the APF and Pix4Point paths.

The op functions are re-exported under the JAX package's names
(``pointvit_tpu/ops/__init__.py``), the standalone sampler
``fps_sampling_with_knn`` and its benchmark among them. Importing this package registers every kernel wrapper's custom op
(``torch.ops.pointvit_tpu_torch.*``), which is what a program exported by
:mod:`pointvit_tpu_torch.export` needs to run, and builds no kernel: each
builds at its first launch.
"""

from pointvit_tpu_torch.ops import (  # noqa: F401  (each registers its custom ops)
    attention_kernel,
    batchnorm_kernel,
    block_kernel,
    encoder_kernel,
    fps_kernel,
    gemm_kernel,
    group_mlp_kernel,
    knn_kernel,
    p3_kernel,
    quant_kernel,
    serial_block_kernel,
    vit_block_kernel,
)

from pointvit_tpu_torch.ops.fps import farthest_point_sample, fps_gather
from pointvit_tpu_torch.ops.group import apf_group, p3_group
from pointvit_tpu_torch.ops.knn import knn_gather, knn_group, knn_indices, square_distance
from pointvit_tpu_torch.ops.morton import encode_morton3, morton_argsort, morton_codes, part1by2
from pointvit_tpu_torch.ops.sampler_bench import benchmark_fps_implementations, fps_sampling_with_knn
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
    "fps_sampling_with_knn",
    "benchmark_fps_implementations",
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
