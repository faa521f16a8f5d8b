"""Inputs of every cell, made on the device from the seed.

Clouds follow the pattern of the port's ``data/synthetic.py::make_shape_clouds``
(15 geometric primitives: shells, balls, surfaces, curves and disjoint
parts, per-point jitter, 8 % uniform outliers, a uniform random rotation),
drawn here in bulk with a ``torch.Generator`` on the card, each cloud's
points in random order and scaled into the unit sphere as the datasets'
``normalize`` does. The training augmentation is ScanObjectNN's
``use_custom_augmentation`` path of ``augmentedrot_scale75``: each of four
steps with probability 0.8 — a rotation (full about z, ±15° about y and x),
an isotropic scale in [0.8, 1.2], a jitter of σ 0.03 clipped at 0.05, and
a fifth of the points replaced by noise in the cloud's box (σ 0.05 more).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["derive_seeds", "shape_clouds", "augment", "AUGMENT_P"]

AUGMENT_P = 0.8  # each step applies when U > 0.2


def derive_seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 62-bit seeds from one run seed of any size."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    return [int(s >> np.uint64(2)) for s in state]


def _sphere(gen, shape, dev) -> torch.Tensor:
    v = torch.randn(*shape, 3, generator=gen, device=dev)
    return v / v.norm(dim=-1, keepdim=True)


def _primitive(c: int, m: int, n: int, gen, dev) -> torch.Tensor:
    """(m, n, 3) points on class ``c``'s primitive (0-14), about unit size."""
    u = lambda: torch.rand(m, n, generator=gen, device=dev)  # noqa: E731
    g = lambda *s: torch.randn(m, n, *s, generator=gen, device=dev)  # noqa: E731
    stack = lambda *a: torch.stack(a, dim=-1)  # noqa: E731
    tau = 2 * math.pi
    if c == 0:  # sphere shell
        return 0.9 * _sphere(gen, (m, n), dev)
    if c == 1:  # solid ball
        return 0.95 * _sphere(gen, (m, n), dev) * u()[..., None] ** (1 / 3)
    if c == 2:  # cube surface
        pts = 1.4 * torch.rand(m, n, 3, generator=gen, device=dev) - 0.7
        face = torch.randint(0, 3, (m, n, 1), generator=gen, device=dev)
        side = 0.7 * torch.sign(g())[..., None]
        return pts.scatter(-1, face, side)
    if c == 3:  # cylinder surface
        th = tau * u()
        return stack(0.5 * th.cos(), 0.5 * th.sin(), 1.6 * u() - 0.8)
    if c == 4:  # cone surface
        h, th = u().sqrt(), tau * u()
        return stack(0.6 * h * th.cos(), 0.6 * h * th.sin(), 0.9 - 1.6 * h)
    if c == 5:  # torus
        th, ph = tau * u(), tau * u()
        w = 0.65 + 0.22 * ph.cos()
        return stack(w * th.cos(), w * th.sin(), 0.22 * ph.sin())
    if c == 6:  # two disjoint spheres
        pts = 0.42 * _sphere(gen, (m, n), dev)
        side = torch.where(u() < 0.5, 1.0, -1.0)
        return pts + stack(0.55 * side, torch.zeros_like(side), torch.zeros_like(side))
    if c == 7:  # flat disk
        r, th = u().sqrt(), tau * u()
        return stack(0.9 * r * th.cos(), 0.9 * r * th.sin(), 0.02 * g())
    if c == 8:  # thin rod
        return stack(0.04 * g(), 0.04 * g(), 1.9 * u() - 0.95)
    if c == 9:  # helix, three turns
        t = u()
        return stack(0.55 * (3 * tau * t).cos(), 0.55 * (3 * tau * t).sin(), 1.7 * t - 0.85) \
            + 0.02 * g(3)
    if c == 10:  # three orthogonal rods
        pts = 0.04 * g(3)
        axis = torch.randint(0, 3, (m, n, 1), generator=gen, device=dev)
        return pts.scatter(-1, axis, 1.8 * u()[..., None] - 0.9)
    if c == 11:  # concentric double shell
        r = torch.where(u() < 0.5, 0.45, 0.9)
        return r[..., None] * _sphere(gen, (m, n), dev)
    if c in (12,):  # hemisphere bowl
        v = _sphere(gen, (m, n), dev)
        return 0.85 * torch.cat([v[..., :2], v[..., 2:].abs()], dim=-1)
    verts = torch.tensor([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                         dtype=torch.float32, device=dev)
    if c == 13:  # tetrahedron wireframe
        ends = torch.tensor([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], device=dev)
        e = ends[torch.randint(0, 6, (m, n), generator=gen, device=dev)]
        a, b = 0.6 * verts[e[..., 0]], 0.6 * verts[e[..., 1]]
        return a + u()[..., None] * (b - a) + 0.02 * g(3)
    if c == 14:  # four small balls at a tetrahedron's vertices
        which = torch.randint(0, 4, (m, n), generator=gen, device=dev)
        return 0.55 * verts[which] + 0.18 * _sphere(gen, (m, n), dev) * u()[..., None] ** (1 / 3)
    raise ValueError(f"class {c} out of range (0-14)")


def _rotations(m: int, gen, dev) -> torch.Tensor:
    """(m, 3, 3) uniform rotations: QR of a Gaussian, signs fixed, det +1."""
    q, r = torch.linalg.qr(torch.randn(m, 3, 3, generator=gen, device=dev))
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    flip = torch.where(torch.linalg.det(q) < 0, -1.0, 1.0)
    return torch.cat([q[..., :1] * flip[:, None, None], q[..., 1:]], dim=-1)


def _normalize(pts: torch.Tensor) -> torch.Tensor:
    pts = pts - pts.mean(dim=1, keepdim=True)
    return pts / pts.norm(dim=-1).amax(dim=1).clamp_min(1e-12)[:, None, None]


def shape_clouds(count: int, points: int, seed: int, device, classes: int = 15,
                 noise_frac: float = 0.08, jitter: float = 0.01):
    """(count, points, 3) f32 clouds and (count,) labels in [0, classes)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    labels = torch.randint(0, classes, (count,), generator=gen, device=device)
    clouds = torch.empty(count, points, 3, device=device)
    for c in range(classes):  # every class drawn, so a seed's work is the same
        rows = (labels == c).nonzero().flatten()
        pts = _primitive(c, int(rows.numel()), points, gen, device)
        clouds[rows] = pts
    clouds += jitter * torch.randn(clouds.shape, generator=gen, device=device)
    k = int(noise_frac * points)
    order = torch.rand(count, points, generator=gen, device=device).argsort(dim=1)
    outliers = 2 * torch.rand(count, k, 3, generator=gen, device=device) - 1
    clouds.scatter_(1, order[:, :k, None].expand(-1, -1, 3), outliers)
    clouds = clouds @ _rotations(count, gen, device)
    shuffle = torch.rand(count, points, generator=gen, device=device).argsort(dim=1)
    clouds = torch.gather(clouds, 1, shuffle[..., None].expand(-1, -1, 3))
    return _normalize(clouds).contiguous(), labels


def _axis(theta: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Rotations by ``theta`` in the (i, j) plane: (m, 3, 3)."""
    m = torch.zeros(theta.shape[0], 3, 3, device=theta.device)
    m[:, 0, 0] = m[:, 1, 1] = m[:, 2, 2] = 1.0
    c, s = theta.cos(), theta.sin()
    m[:, i, i], m[:, i, j], m[:, j, i], m[:, j, j] = c, -s, s, c
    return m


def augment(clouds: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The training augmentation of the module docstring, per cloud."""
    m, n, _ = clouds.shape
    dev = clouds.device
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    on = lambda: (u(m) < AUGMENT_P)[:, None, None]  # noqa: E731
    rz = _axis(2 * math.pi * u(m), 0, 1)
    ry = _axis((u(m) - 0.5) * (math.pi / 6), 2, 0)
    rx = _axis((u(m) - 0.5) * (math.pi / 6), 1, 2)
    out = torch.where(on(), clouds @ (rz @ ry @ rx).transpose(1, 2), clouds)
    out = torch.where(on(), out * (0.8 + 0.4 * u(m))[:, None, None], out)
    jit = torch.clamp(0.03 * torch.randn(m, n, 3, generator=gen, device=dev), -0.05, 0.05)
    out = torch.where(on(), out + jit, out)
    k = int(0.2 * n)
    lo, hi = out.amin(dim=1, keepdim=True), out.amax(dim=1, keepdim=True)
    noise = lo + (hi - lo) * u(m, k, 3) + 0.05 * torch.randn(m, k, 3, generator=gen, device=dev)
    idx = u(m, n).argsort(dim=1)[:, :k, None].expand(-1, -1, 3)
    out = torch.where(on(), out.scatter(1, idx, noise), out)
    return out.contiguous()
