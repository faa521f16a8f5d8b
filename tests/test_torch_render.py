"""Port parity: the renderer's two renderers (``pointvit_tpu_torch.ops.render``)
against ``pointvit_tpu.ops.render``, on the CPU.

Same numpy inputs from a seed on both sides. Float outputs agree to 1e-5
relative to the largest reference value (the two frameworks order a few f32
operations differently); a raster is a per-pixel max of the same feature
values, so it must be equal. The splat is held with points that straddle
the border (dropped unless all four neighbours are inside), the raster with
coordinates whose quantised value lies in (−1, 0), where truncation (pixel
0) and flooring (out of bounds) differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.ops import render as jrender
from pointvit_tpu_torch.ops import render

REL_TOL = 1e-5
S = 32  # image size
T = torch.from_numpy


def _assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|d| / max|ref| = {err:.3g} > {tol:.3g}"


def _clouds(seed, B=3, N=96):
    """Clouds scaled into the unit sphere, as the dataset's normalisation."""
    pts = np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1).max(axis=1)[:, None, None]


def _angles(seed, B=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-np.pi, np.pi, B).astype(np.float32),
            rng.uniform(-np.pi / 3, np.pi / 3, B).astype(np.float32))


@pytest.mark.parametrize("num_views", [1, 2, 3, 4, 5, 6])
def test_fixed_view_angles(num_views):
    az, el = render.fixed_view_angles(num_views)
    jaz, jel = jrender.fixed_view_angles(num_views)
    np.testing.assert_array_equal(az.numpy(), np.asarray(jaz))
    np.testing.assert_array_equal(el.numpy(), np.asarray(jel))


def test_fixed_view_angles_take_at_most_six_views():
    with pytest.raises(ValueError, match="6 views"):
        render.fixed_view_angles(7)


def test_rotation_projection_and_shading():
    pts = _clouds(0)
    az, el = _angles(1)
    rot = render.rotate_az_el(T(pts), T(az), T(el))
    jrot = jrender.rotate_az_el(jnp.asarray(pts), jnp.asarray(az), jnp.asarray(el))
    _assert_rel(rot, jrot)
    xy, z = render.project_orthographic(rot)
    jxy, jz = jrender.project_orthographic(jrot)
    _assert_rel(xy, jxy)
    _assert_rel(z, jz)
    _assert_rel(render.depth_intensity(T(np.array(jz))), jrender.depth_intensity(jz))


@pytest.mark.parametrize("angles", ["per_cloud", "scalar"])
def test_project_points_spherical(angles):
    pts = _clouds(2)
    if angles == "per_cloud":
        az, el = (np.rad2deg(a) for a in _angles(3))
    else:
        az, el = np.float32(60.0), np.float32(-30.0)
    xy, z = render.project_points_spherical(T(pts), torch.as_tensor(az), torch.as_tensor(el))
    jxy, jz = jrender.project_points_spherical(jnp.asarray(pts), jnp.asarray(az), jnp.asarray(el))
    _assert_rel(xy, jxy)
    _assert_rel(z, jz)


def test_splat_bilinear_drops_points_that_straddle_the_border():
    rng = np.random.default_rng(4)
    inside = rng.uniform(-0.9, 0.9, (2, 40, 2))
    # pixel coordinate (x + 1)·S/2 − 0.5 within one pixel of either edge or
    # just past it: some keep all four neighbours, some lose one
    edge = (np.array([-0.5, 0.2, 0.7, S - 1.7, S - 1.2, S - 0.6]) + 0.5) * 2 / S - 1
    border = np.stack([np.repeat(edge, 6), np.tile(edge, 6)], -1)[None].repeat(2, 0)
    pts = np.concatenate([inside, border, rng.uniform(-1.3, 1.3, (2, 20, 2))], 1).astype(np.float32)
    feats = rng.uniform(0.3, 1.0, pts.shape[:2]).astype(np.float32)
    got = render.splat_bilinear(T(pts), T(feats), S)
    want = jrender.splat_bilinear(jnp.asarray(pts), jnp.asarray(feats), S)
    _assert_rel(got, want)
    # the border points change the image: some are kept, some dropped
    no_border = np.concatenate([inside, pts[:, 76:]], 1).astype(np.float32)
    f_no = np.concatenate([feats[:, :40], feats[:, 76:]], 1)
    base = render.splat_bilinear(T(no_border), T(f_no), S)
    assert 0 < (got - base).abs().sum() < feats[:, 40:76].sum()


def _raster_case(seed):
    """Points whose quantised coordinate lies in (−1, 0) (x slightly below
    −1), inside the image and past it."""
    rng = np.random.default_rng(seed)
    low = -1.0 - rng.uniform(0.05, 0.95, (2, 12)) * 2.0 / (S - 1)
    pts = np.concatenate([
        np.stack([low, rng.uniform(-0.9, 0.9, (2, 12))], -1),
        np.stack([rng.uniform(-0.9, 0.9, (2, 12)), low], -1),
        rng.uniform(-1.1, 1.1, (2, 50, 2)),
    ], 1).astype(np.float32)
    feats = rng.uniform(0.3, 1.0, pts.shape[:2]).astype(np.float32)
    return pts, feats


def test_raster_truncates_toward_zero():
    pts, feats = _raster_case(5)
    got = render.rasterize_amax_fast(T(pts), T(feats), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jrender.rasterize_amax_fast(jnp.asarray(pts), jnp.asarray(feats), S)))
    # floor would drop the (−1, 0) points; truncation paints column 0
    q = (pts[:, :12, 0].astype(np.float64) + 1) * 0.5 * (S - 1)
    assert ((q > -1) & (q < 0)).all()
    low = render.rasterize_amax_fast(T(pts[:, :12].copy()), T(feats[:, :12].copy()), S)
    assert (low[:, :, 0] > 0).sum() >= 12


@pytest.mark.parametrize("kernel_size", [5, 3])
def test_rasterize_amax(kernel_size):
    pts, feats = _raster_case(6)
    got = render.rasterize_amax(T(pts), T(feats), S, kernel_size)
    want = jrender.rasterize_amax(jnp.asarray(pts), jnp.asarray(feats), S, kernel_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_render_diff_views():
    pts = _clouds(7)
    az, el = _angles(8)
    got = render.render_diff_views(T(pts), T(az), T(el), S)
    want = jrender.render_diff_views(jnp.asarray(pts), jnp.asarray(az), jnp.asarray(el), S)
    assert got.shape == (3, S, S)
    _assert_rel(got, want)


@pytest.mark.parametrize("exact_raster", [False, True])
def test_render_fixed_views(exact_raster):
    pts = _clouds(9)
    got = render.render_fixed_views(T(pts), S, 6, exact_raster=exact_raster)
    want = jrender.render_fixed_views(jnp.asarray(pts), S, 6, exact_raster=exact_raster)
    assert got.shape == (3, 6, S, S)
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)  # the same pixels
    _assert_rel(got, want)
