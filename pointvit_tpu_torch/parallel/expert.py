"""Expert parallelism: the mixture-of-experts FFN, over an ``expert`` mesh
axis or on one device.

Counterpart of ``pointvit_tpu/parallel/expert.py``, routing for routing:
top-k picks taken k-major (each pick masks the earlier ones), a token's
position in its expert from one count over the k-major flattened picks
(all k = 0 picks claim capacity before any k = 1), capacity
``ceil(cf · T_local · K / E)``, tokens past it dropped, optional gate
normalisation, and the Switch load-balance terms from the k = 0 picks.

What differs is the layout of the dispatch. The JAX package builds a
(T, E, C) one-hot ``dispatch`` and ``combine`` and contracts them with the
tokens (``expert.py:154-163``). At Pix4Point's serving shape (T = 256 × 513,
E 4, top-2, cf 2) C equals T and one such f32 tensor would take 276 GB. Here
the same slots are indices: the expert, the slot and a kept flag for each
(token, pick). Tokens are copied into a flat (E·C, M) buffer whose slots are
unique, so the expert inputs equal the one-hot contraction's bit for bit
(it sums one nonzero product), and gathered back weighted by their gates
(K terms, which may round in another order than the contraction's E·C).
The buffer is as wide as the busiest expert's filled slots, not the
capacity: the experts compute no slot that no token fills, which at cf 2
and top-2 of 4 experts is about half of them.
The expert FFN's products are batched matmuls in f32, as the JAX einsums
promote the f32 tokens and the weights.

With ``mesh`` (a ``DeviceMesh`` with an expert dimension) the experts shard
over the expert group and each rank routes its own tokens; one differentiable
``all_to_all`` each way exchanges the (E, C, M) buffer as JAX's tiled
all-to-all does (split axis 0, concatenate axis 1), and the aux loss is
averaged over the expert group and the optional data group. Inside a
data-parallel step with no expert mesh (:func:`~pointvit_tpu_torch.parallel.comm.global_batch`),
routing follows the global batch, as JAX's SPMD step calls ``moe_ffn`` with
no mesh on the global array: capacity from the global token count, slots
from one count over every rank's tokens, and the load-balance terms averaged
over the group before their product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pointvit_tpu_torch.parallel.comm import all_gather, all_reduce_sum, all_to_all, current_batch

__all__ = [
    "moe_ffn",
    "fan_in_normal_init",
    "init_moe_params",
    "moe_load_balance_loss",
    "upcycle_dense_mlp",
]


def fan_in_normal_init(fan_in: int):
    """``normal / sqrt(fan_in)`` initializer (the flax Dense scale), shared by
    :func:`init_moe_params` and :class:`~pointvit_tpu_torch.nn.moe.MoEMlp`:
    ``init(shape, generator=None, dtype=torch.float32, device=None)``."""

    def init(shape, generator=None, dtype=torch.float32, device=None):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * (
            1.0 / math.sqrt(fan_in))

    return init


def init_moe_params(generator: torch.Generator | None, embed_dim: int, hidden_dim: int,
                    num_experts: int, dtype=torch.float32, device=None) -> dict:
    """Router and per-expert FFN weights in the JAX layout, the experts
    stacked on a leading E axis: ``gate`` (M, E), ``w1`` (E, M, F), ``b1``
    (E, F), ``w2`` (E, F, M), ``b2`` (E, M); drawn from ``generator``."""
    e, m, f = num_experts, embed_dim, hidden_dim
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "gate": fan_in_normal_init(m)((m, e), **kw),
        "w1": fan_in_normal_init(m)((e, m, f), **kw),
        "b1": torch.zeros((e, f), dtype=dtype, device=device),
        "w2": fan_in_normal_init(f)((e, f, m), **kw),
        "b2": torch.zeros((e, m), dtype=dtype, device=device),
    }


def upcycle_dense_mlp(generator: torch.Generator | None, fc1_kernel: torch.Tensor,
                      fc1_bias: torch.Tensor, fc2_kernel: torch.Tensor, fc2_bias: torch.Tensor,
                      num_experts: int, *, router_scale: float = 1e-2) -> dict:
    """Sparse upcycling (Komatsuzaki et al., arXiv:2212.05055): a trained
    dense MLP becomes E identical experts and a small random router. The
    kernels are in the flax layout (in, out): a port ``Mlp``'s are
    ``fc1.weight.T`` and ``fc2.weight.T``. With ``normalize_gates=True`` the
    layer computes the dense MLP's function until the experts diverge."""
    e, m = num_experts, fc1_kernel.shape[0]
    gate = torch.randn((m, e), generator=generator, device=fc1_kernel.device) * (
        router_scale / math.sqrt(m))
    return {
        "gate": gate.to(fc1_kernel.dtype),
        "w1": fc1_kernel[None].expand(e, *fc1_kernel.shape).clone(),
        "b1": fc1_bias[None].expand(e, *fc1_bias.shape).clone(),
        "w2": fc2_kernel[None].expand(e, *fc2_kernel.shape).clone(),
        "b2": fc2_bias[None].expand(e, *fc2_bias.shape).clone(),
    }


def _route(gate_logits: torch.Tensor, capacity: int, top_k: int, normalize_gates: bool,
           data_group=None):
    """Top-k routing with per-expert capacity, as index tensors.

    gate_logits (T, E) → ``expert`` (K, T) the picks, ``gates`` (K, T) their
    router weights, ``pos`` (K, T) each pick's position in its expert,
    ``keep`` (K, T) ``pos < capacity``, and the load-balance terms f_e, p_e.
    With ``data_group`` the positions are those of the global batch's one
    count (this rank's tokens after the lower ranks' at each pick level).
    """
    t, e = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)
    experts, gates, masks = [], [], []
    remaining = probs
    for _ in range(top_k):
        idx = remaining.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
        mask = F.one_hot(idx, e).to(probs.dtype)
        experts.append(idx)
        masks.append(mask)
        gates.append(probs.gather(1, idx[:, None])[:, 0])  # the router weight of the pick
        remaining = remaining * (1.0 - mask)
    if normalize_gates:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    expert = torch.stack(experts)  # (K, T)
    # (K, E, T): the counts run along the innermost axis (a scan over an
    # outer axis of E columns leaves the card nearly idle)
    hot = F.one_hot(expert, e).to(torch.int32).transpose(1, 2).contiguous()
    counts = hot.sum(dim=2)  # (K, E) picks of each expert at each level
    before = torch.cumsum(hot, dim=2) - hot  # earlier picks of the same level
    if data_group is not None:
        with torch.no_grad():
            every = all_gather(counts[None], data_group)  # (W, K, E)
        r = torch.distributed.get_rank(data_group)
        level_start = every.sum(dim=0)
        lower = every[:r].sum(dim=0)
    else:
        level_start, lower = counts, torch.zeros_like(counts)
    offset = torch.cumsum(level_start, dim=0) - level_start + lower  # (K, E)
    pos = before.gather(1, expert[:, None, :])[:, 0] + offset.gather(1, expert)
    keep = pos < capacity
    f_e = masks[0].mean(dim=0)  # the fraction of tokens whose top-1 is e
    p_e = probs.mean(dim=0)  # the mean router probability of e
    return expert, torch.stack(gates), pos, keep, f_e, p_e


def _expert_ffn(xin: torch.Tensor, w1, b1, w2, b2, activation) -> torch.Tensor:
    """Per-expert MLP on dispatched tokens: (E', C', M) → (E', C', M), f32."""
    h = activation(torch.bmm(xin, w1.float()) + b1.float()[:, None, :])
    return torch.bmm(h, w2.float()) + b2.float()[:, None, :]


def moe_load_balance_loss(f_e: torch.Tensor, p_e: torch.Tensor) -> torch.Tensor:
    """Switch aux loss ``E · Σ_e f_e · p_e`` (1 at perfect balance)."""
    return f_e.shape[-1] * torch.sum(f_e * p_e)


def _exact_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def moe_ffn(
    x: torch.Tensor,
    params: dict,
    mesh=None,
    *,
    expert_axis: str = "expert",
    data_axis: str | None = None,
    top_k: int = 2,
    capacity_factor: float = 2.0,
    normalize_gates: bool = False,
    activation=_exact_gelu,
):
    """Mixture-of-experts FFN; a drop-in for a transformer MLP.

    Args:
        x: (B, S, M) tokens: the whole batch, or with ``mesh`` this rank's
            rows (tokens shard over the expert group, and the data group
            when ``data_axis`` is given).
        params: :func:`init_moe_params`'s dict. With ``mesh`` the experts'
            ``w1``/``b1``/``w2``/``b2`` may hold all E experts (this rank
            takes its E/n) or this rank's E/n only; ``gate`` is replicated.
        mesh: a ``DeviceMesh`` with an ``expert_axis`` dimension (and
            ``data_axis``): runs expert-parallel, ``E % n == 0``. None runs
            the same math on this process's tokens (inside a
            ``global_batch``, routed as the global batch).
        top_k, capacity_factor, normalize_gates, activation: as in JAX;
            capacity ``ceil(cf · T · K / E)`` with T the tokens one rank
            routes (the global batch's under ``global_batch``).

    Returns:
        (out, aux): out (B, S, M) in x's dtype; aux the f32 load-balance
        loss. Under a mesh, the experts outside this rank's shard get no
        gradient here and the router's gradient is this rank's share: sum
        them over the expert group for the mesh's total.
    """
    b, s, m = x.shape
    e = params["gate"].shape[-1]
    if top_k > e:
        raise ValueError(f"top_k={top_k} exceeds {e} experts")
    group = data_group = None
    n = 1
    if mesh is not None:
        group = mesh.get_group(expert_axis)
        n = mesh.size(mesh.mesh_dim_names.index(expert_axis))
        if data_axis:
            data_group = mesh.get_group(data_axis)
    if e % n:
        raise ValueError(f"{e} experts not divisible by {n} expert shards")
    batch = current_batch() if mesh is None else None
    t_local = b * s
    t_route = t_local * (batch.size if batch is not None else 1)
    capacity = max(1, math.ceil(capacity_factor * t_route * top_k / e))

    tokens = x.reshape(t_local, m).float()
    logits = tokens @ params["gate"].float()
    expert, gates, pos, keep, f_e, p_e = _route(
        logits, capacity, top_k, normalize_gates,
        data_group=batch.group if batch is not None else None)

    # This rank's kept picks get unique slots: their order among the kept
    # picks of their expert (equal to ``pos`` when the count is this rank's).
    # The buffer holds as many slots an expert as the busiest one fills (at
    # most the capacity): a slot no pick fills is never read back.
    flat_e, flat_keep = expert.reshape(-1), keep.reshape(-1)
    hot = (F.one_hot(flat_e, e).to(torch.int32) * flat_keep[:, None]).t().contiguous()  # (E, K·T)
    run = torch.cumsum(hot, dim=1)
    slot = (run - hot).gather(0, flat_e[None])[0]
    filled = run[:, -1].max()
    if n > 1:  # every rank's buffer has the same shape for the exchange
        filled = filled.clone()
        torch.distributed.all_reduce(filled, op=torch.distributed.ReduceOp.MAX, group=group)
    slots = max(1, int(filled))
    dst = flat_e * slots + slot  # (K·T,) row of the flat buffer
    src = torch.arange(t_local, device=x.device).repeat(top_k)
    kept = flat_keep.nonzero()[:, 0]
    xin = tokens.new_zeros((e * slots, m)).index_copy(0, dst[kept], tokens[src[kept]])

    w1, b1, w2, b2 = (params[k] for k in ("w1", "b1", "w2", "b2"))
    if n > 1:
        local = e // n
        if w1.shape[0] == e:
            r = torch.distributed.get_rank(group)
            w1, b1, w2, b2 = (p[r * local:(r + 1) * local] for p in (w1, b1, w2, b2))
        # (E, C, M) → (E/n, n·C, M): each rank receives its experts' slots
        # from every peer, in rank order.
        recv = all_to_all(xin, group).reshape(n, local, slots, m).transpose(0, 1)
        y = _expert_ffn(recv.reshape(local, n * slots, m), w1, b1, w2, b2, activation)
        y = y.reshape(local, n, slots, m).transpose(0, 1).reshape(e * slots, m)
        y = all_to_all(y, group)
    else:
        y = _expert_ffn(xin.reshape(e, slots, m), w1, b1, w2, b2, activation)
        y = y.reshape(e * slots, m)

    weight = (gates * keep).reshape(top_k, t_local)
    rows = torch.where(flat_keep, dst, 0).reshape(top_k, t_local)
    out = weight[0, :, None] * y.index_select(0, rows[0])
    for k in range(1, top_k):
        out = out + weight[k, :, None] * y.index_select(0, rows[k])

    if batch is not None:  # the global batch's fractions and probabilities
        f_e = all_reduce_sum(f_e, batch.group) / batch.size
        p_e = all_reduce_sum(p_e, batch.group) / batch.size
    aux = moe_load_balance_loss(f_e, p_e)
    if mesh is not None:
        size = n
        aux = all_reduce_sum(aux, group)
        if data_group is not None:
            aux = all_reduce_sum(aux, data_group)
            size *= mesh.size(mesh.mesh_dim_names.index(data_axis))
        aux = aux / size
    return out.reshape(b, s, m).to(x.dtype), aux
