"""Point cloud → single-channel views: the renderer classifier's two
renderers, in plain PyTorch.

Counterpart of ``pointvit_tpu/ops/render.py`` (all of it). Neither renderer
is a Pallas kernel in the JAX package: the differentiable splat is two dense
hat matrices and one batched product, the fixed-view raster a scatter-max.

- :func:`splat_bilinear`: bilinear splatting is separable, so the image is
  ``(Hyᵀ · diag(f)) · Hx`` with ``hat(t) = max(0, 1 - |t|)`` evaluated
  densely. The product runs in full f32 (the JAX package asks for
  ``Precision.HIGHEST``), never TF32, and so do its backward products and
  those of the rotation (:func:`_f32_matmul`): the renderer trains through
  the images. A point is dropped unless all four of its neighbours lie
  inside the image (``render.py:129-134``).
- :func:`rasterize_amax`: 5×5 NDC dilation, quantisation by truncation
  toward zero (a coordinate in (−1, 0) lands on pixel 0), out-of-bounds
  writes to a dump slot, per-pixel max by ``scatter_reduce``.
- :func:`rasterize_amax_fast`: one pixel per point, then a 3×3 max-pool. The
  image is ≥ 0 (zeros, then a max), so ``max_pool2d``'s −inf padding equals
  the JAX package's zero padding.

Images are (B, H, W); callers broadcast them to RGB.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = [
    "rotate_az_el",
    "project_orthographic",
    "depth_intensity",
    "splat_bilinear",
    "rasterize_amax",
    "rasterize_amax_fast",
    "project_points_spherical",
    "render_diff_views",
    "render_fixed_views",
    "fixed_view_angles",
]


@contextlib.contextmanager
def _full_f32():
    """Products in full f32 on the card whatever the global TF32 switch says."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class _F32Matmul(torch.autograd.Function):
    """Batched ``a @ b`` of two f32 tensors of the same batch shape whose
    forward and backward products both run in full f32, never TF32:
    autograd runs a backward outside the forward's ``_full_f32``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _full_f32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _full_f32():
            ga = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
            gb = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gb


_f32_matmul = _F32Matmul.apply


def fixed_view_angles(num_views: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Default camera angles in degrees (azimuths, elevations); at most 6 views."""
    if num_views > 6:
        raise ValueError("the fixed renderer takes at most 6 views")
    azimuths = torch.linspace(0.0, 360.0, num_views + 1, device=device)[:-1]
    elevations = torch.tensor([0.0, 30.0, -30.0, 0.0, 0.0, 0.0], device=device)[:num_views]
    return azimuths, elevations


def rotate_az_el(points: torch.Tensor, azimuth: torch.Tensor, elevation: torch.Tensor) -> torch.Tensor:
    """Rotate clouds by azimuth (about y), then elevation (about x), radians:
    points (B, N, 3), angles (B,) → (B, N, 3), as points @ (R_el @ R_az)ᵀ."""
    cos_az, sin_az = torch.cos(azimuth), torch.sin(azimuth)
    cos_el, sin_el = torch.cos(elevation), torch.sin(elevation)
    zeros, ones = torch.zeros_like(cos_az), torch.ones_like(cos_az)
    r_az = torch.stack([
        torch.stack([cos_az, zeros, sin_az], -1),
        torch.stack([zeros, ones, zeros], -1),
        torch.stack([-sin_az, zeros, cos_az], -1),
    ], -2)
    r_el = torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, cos_el, -sin_el], -1),
        torch.stack([zeros, sin_el, cos_el], -1),
    ], -2)
    return _f32_matmul(points, _f32_matmul(r_el, r_az).transpose(-1, -2))


def project_orthographic(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotated points → (NDC xy (B, N, 2), depth z (B, N))."""
    return points[..., :2], points[..., 2]


def depth_intensity(z: torch.Tensor) -> torch.Tensor:
    """Per-cloud depth shading 0.3 + 0.7·ẑ, ẑ = (z − min) / (max − min + 1e-6)."""
    z_min = z.amin(dim=1, keepdim=True)
    z_max = z.amax(dim=1, keepdim=True)
    return 0.3 + 0.7 * ((z - z_min) / (z_max - z_min + 1e-6))


def _hat_weights(coord: torch.Tensor, size: int) -> torch.Tensor:
    """(B, N) continuous pixel coordinates → (B, N, size) with entry j =
    max(0, 1 − |coord − j|)."""
    grid = torch.arange(size, dtype=coord.dtype, device=coord.device)
    return torch.clamp(1.0 - (coord[..., None] - grid).abs(), min=0.0)


def splat_bilinear(points_2d: torch.Tensor, features: torch.Tensor, img_size: int) -> torch.Tensor:
    """Bilinear splat of per-point features: points_2d (B, N, 2) in NDC,
    features (B, N) → (B, H, W), H = W = ``img_size``."""
    H = W = img_size
    px = (points_2d[..., 0] + 1.0) * 0.5 * W - 0.5
    py = (points_2d[..., 1] + 1.0) * 0.5 * H - 0.5
    px1, py1 = torch.floor(px), torch.floor(py)
    valid = (px1 >= 0) & (py1 >= 0) & (px1 + 1 < W) & (py1 + 1 < H)
    f = torch.where(valid, features, torch.zeros_like(features))
    hx = _hat_weights(px, W)
    hy = _hat_weights(py, H)
    # image[y, x] = Σ_n f_n · hy[n, y] · hx[n, x]
    image = _f32_matmul((hy * f[..., None]).transpose(1, 2).float(), hx.float())
    return image.to(points_2d.dtype)


def _scatter_max(flat: torch.Tensor, vals: torch.Tensor, B: int, img_size: int) -> torch.Tensor:
    """Max of ``vals`` into B zero images of (H·W + 1) slots (the last one
    catches the out-of-bounds writes) → (B, H, W)."""
    HW = img_size * img_size
    image = torch.zeros(B * (HW + 1), dtype=vals.dtype, device=vals.device)
    image.scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1), reduce="amax")
    return image.reshape(B, HW + 1)[:, :HW].reshape(B, img_size, img_size)


def _flat_pixels(x: torch.Tensor, y: torch.Tensor, img_size: int) -> torch.Tensor:
    """NDC coordinates (B, ...) → flat slot indices per image: truncating
    quantisation, out-of-bounds to the dump slot H·W, offset by b·(H·W + 1)."""
    H = W = img_size
    px = torch.trunc((x + 1.0) * 0.5 * (img_size - 1)).to(torch.int64)
    py = torch.trunc((y + 1.0) * 0.5 * (img_size - 1)).to(torch.int64)
    valid = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    flat = torch.where(valid, py * W + px, torch.full_like(px, H * W))
    base = torch.arange(x.shape[0], device=x.device) * (H * W + 1)
    return flat + base.reshape((-1,) + (1,) * (flat.dim() - 1))


def rasterize_amax(points_2d: torch.Tensor, features: torch.Tensor, img_size: int,
                   kernel_size: int = 5) -> torch.Tensor:
    """Depth-shaded max raster with the fixed renderer's NDC dilation:
    points_2d (B, N, 2), features (B, N) → (B, H, W); each pixel holds the
    max intensity of the points whose dilated footprint covers it."""
    B, N, _ = points_2d.shape
    offset = torch.linspace(-2.0 / img_size, 2.0 / img_size, kernel_size, device=points_2d.device)
    dx = offset.repeat(kernel_size)  # x varies fastest
    dy = offset.repeat_interleave(kernel_size)
    flat = _flat_pixels(points_2d[..., 0][..., None] + dx, points_2d[..., 1][..., None] + dy,
                        img_size)
    vals = features[..., None].expand(B, N, kernel_size * kernel_size)
    return _scatter_max(flat, vals.contiguous(), B, img_size)


def rasterize_amax_fast(points_2d: torch.Tensor, features: torch.Tensor, img_size: int) -> torch.Tensor:
    """:func:`rasterize_amax` with one pixel per point and a 3×3 max-pool in
    place of the 5×5 dilation: the full 3×3 box always, where the exact
    footprint drops an edge row or column for points within 1/S of a pixel
    edge (``render.py:196-235``)."""
    B = points_2d.shape[0]
    flat = _flat_pixels(points_2d[..., 0], points_2d[..., 1], img_size)
    image = _scatter_max(flat, features, B, img_size)
    return F.max_pool2d(image[:, None], 3, stride=1, padding=1)[:, 0]


def render_diff_views(points: torch.Tensor, azimuth: torch.Tensor, elevation: torch.Tensor,
                      img_size: int) -> torch.Tensor:
    """Differentiable render: rotate → project → shade → bilinear splat;
    points (B, N, 3), angles (B,) in radians → (B, H, W)."""
    points_2d, z = project_orthographic(rotate_az_el(points, azimuth, elevation))
    return splat_bilinear(points_2d, depth_intensity(z), img_size)


def project_points_spherical(points: torch.Tensor, azimuth_deg: torch.Tensor,
                             elevation_deg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fixed renderer's projection, angles in degrees ((B,) or scalar);
    its rotation is the inverse convention of :func:`rotate_az_el`, as in
    the reference. Returns (NDC xy (B, N, 2), depth (B, N))."""
    az = torch.deg2rad(azimuth_deg)
    el = torch.deg2rad(elevation_deg)
    cos_az, sin_az = torch.cos(az)[..., None], torch.sin(az)[..., None]
    cos_el, sin_el = torch.cos(el)[..., None], torch.sin(el)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    x_rot = x * cos_az - z * sin_az
    z_rot = x * sin_az + z * cos_az
    y_rot = y * cos_el - z_rot * sin_el
    z_final = y * sin_el + z_rot * cos_el
    return torch.stack([x_rot, y_rot], dim=-1), z_final


def render_fixed_views(points: torch.Tensor, img_size: int, num_views: int, *,
                       exact_raster: bool = False) -> torch.Tensor:
    """Render from the fixed camera ring, batched over clouds and views:
    points (B, N, 3) → (B, V, H, W)."""
    B, N, _ = points.shape
    az_deg, el_deg = fixed_view_angles(num_views, points.device)
    pts = points[:, None].expand(B, num_views, N, 3).reshape(B * num_views, N, 3)
    points_2d, z = project_points_spherical(pts, az_deg.repeat(B), el_deg.repeat(B))
    raster = rasterize_amax if exact_raster else rasterize_amax_fast
    image = raster(points_2d, depth_intensity(z), img_size)
    return image.reshape(B, num_views, img_size, img_size)
