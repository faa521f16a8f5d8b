"""Exact k-nearest neighbours, plain torch.

Counterpart of ``pointvit_tpu/ops/knn.py`` (matmul-form distances and an
exact top-k). The groupings of :mod:`pointvit_tpu_torch.ops.group` call
these for point counts that the packed-key kernel of
:mod:`pointvit_tpu_torch.ops.knn_kernel` does not take (N % 128 ≠ 0 or
N > 2048), as the JAX package runs its XLA top-k there.
"""

from __future__ import annotations

import torch

__all__ = ["square_distance", "knn_indices", "knn_gather", "knn_group"]


def square_distance(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances: ||q||² + ||s||² − 2⟨q, s⟩.
    query (B, S, C), support (B, N, C) → (B, S, N) float32."""
    q = query.to(torch.float32)
    s = support.to(torch.float32)
    qq = (q * q).sum(-1, keepdim=True)
    ss = (s * s).sum(-1, keepdim=True)
    return qq + ss.transpose(-1, -2) - 2.0 * torch.bmm(q, s.transpose(-1, -2))


def knn_indices(query: torch.Tensor, support: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S, k) indices of the k nearest support points, nearest first."""
    if k > support.shape[1]:
        raise ValueError(f"k={k} > N={support.shape[1]}")
    d = square_distance(query, support)
    return torch.topk(d, k, dim=-1, largest=False, sorted=True).indices


def knn_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, C), idx (B, S, k) → (B, S, k, C)."""
    B, S, K = idx.shape
    C = values.shape[-1]
    flat = idx.reshape(B, S * K).to(torch.int64)
    return torch.gather(values, 1, flat[..., None].expand(-1, -1, C)).reshape(B, S, K, C)


def knn_group(points: torch.Tensor, centroids: torch.Tensor, features: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points and their features around each centroid: an
    exact top-k and two gathers (``pointvit_tpu/ops/knn.py:76-96``).
    points (B, N, 3), centroids (B, S, 3), features (B, N, D) →
    (grouped_points (B, S, k, 3), absolute as in the reference,
    grouped_features (B, S, k, D))."""
    idx = knn_indices(centroids, points, k)
    return knn_gather(points, idx), knn_gather(features, idx)
