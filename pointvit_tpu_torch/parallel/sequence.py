"""Sequence parallelism: exact attention with the tokens sharded over a
``seq`` mesh axis.

Counterpart of ``pointvit_tpu/parallel/sequence.py``. Each rank passes its
block of the sequence, ``(B_local, S/n, H, D)``, and gets its block of the
output; with a ``data`` axis the batch is split too and the data group plays
no part in the attention. Both functions accumulate in f32 whatever the
input dtype and are plain PyTorch math, as the JAX functions are einsums.

- :func:`ring_mha` (Liu et al., arXiv:2310.01889): queries stay; the K/V
  blocks travel the ring (a rank sends to the previous one and receives
  from the next), folded into online-softmax accumulators, so no rank holds
  more than a (S/n, S/n) logits block. A hop is a differentiable
  all-to-all whose backward is the reverse hop.
- :func:`ulysses_mha` (DeepSpeed-Ulysses, arXiv:2309.14509): one
  all-to-all turns the sequence sharding into a head sharding (every rank
  sees the whole sequence for H/n heads), a plain softmax attention, and a
  second all-to-all turns it back.
"""

from __future__ import annotations

import torch

from pointvit_tpu_torch.parallel.comm import all_to_all, ring_shift

__all__ = ["ring_mha", "ulysses_mha"]


def _seq_group(mesh, seq_axis: str):
    return mesh.get_group(seq_axis), mesh.size(mesh.mesh_dim_names.index(seq_axis))


def _check(q, k, v) -> None:
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"q, k, v blocks differ: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def ring_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *, seq_axis: str = "seq",
             data_axis: str | None = None) -> torch.Tensor:
    """Exact MHA over a sequence sharded on ``seq_axis``: this rank's
    ``(B_local, S/n, H, D)`` blocks of q, k, v → its block of the output,
    in q's dtype. Every rank's block has the same shape (S divisible by n,
    as the JAX function requires)."""
    del data_axis  # the data group holds other rows; the attention is per row
    _check(q, k, v)
    group, n = _seq_group(mesh, seq_axis)
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    bl, sl, h, d = q.shape
    m = torch.full((bl, h, sl), float("-inf"), device=q.device)
    l = torch.zeros((bl, h, sl), device=q.device)
    acc = torch.zeros((bl, h, sl, d), device=q.device)
    kb, vb = k, v
    for step in range(n):
        s = torch.einsum("bshd,bthd->bhst", qf, kb.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vb.float())
        m = m_new
        if step < n - 1:  # send to the previous rank, receive from the next
            kb, vb = ring_shift(kb, group, -1), ring_shift(vb, group, -1)
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


def ulysses_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                seq_axis: str = "seq", data_axis: str | None = None) -> torch.Tensor:
    """Exact MHA over a sequence sharded on ``seq_axis`` through two
    head-scattering all-to-alls: this rank's ``(B_local, S/n, H, D)``
    blocks → its output block, in q's dtype. Needs ``H % n == 0``."""
    del data_axis
    _check(q, k, v)
    group, n = _seq_group(mesh, seq_axis)
    b, sl, h, d = q.shape
    if h % n:
        raise ValueError(f"heads {h} not divisible by {n} seq shards")
    hn = h // n

    def seq_to_heads(x):  # (B, S/n, H, D) → (B, S, H/n, D): scatter heads, gather seq
        parts = x.reshape(b, sl, n, hn, d).permute(2, 0, 1, 3, 4)
        got = all_to_all(parts.contiguous(), group)  # (n, B, S/n, H/n, D), by source rank
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * sl, hn, d)

    def heads_to_seq(x):  # (B, S, H/n, D) → (B, S/n, H, D)
        parts = x.reshape(b, n, sl, hn, d).permute(1, 0, 2, 3, 4)
        got = all_to_all(parts.contiguous(), group)  # (n, B, S/n, H/n, D): heads by rank
        return got.permute(1, 2, 0, 3, 4).reshape(b, sl, h, d)

    qh, kh, vh = (seq_to_heads(x).float() for x in (q, k, v))
    logits = torch.einsum("bshd,bthd->bhst", qh, kh) * (d ** -0.5)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, vh).to(q.dtype)
    return heads_to_seq(out)
