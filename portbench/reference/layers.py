"""Layers of the plain reference, in f32 with TF32 off.

Every product goes through :class:`Numerics`, which in f32 leaves its
operands as they are. The control of ``correct`` rounds them to fp8 (e4m3,
one scale a tensor, as fp8 inference scales them) with a straight-through
gradient: the reference computed in the precision below bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["Numerics", "F32", "FP8", "kind_of", "make_weights", "linear", "layer_norm",
           "batch_norm", "attention", "no_tf32"]

LN_EPS = 1e-6  # flax's LayerNorm default
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # r ← 0.9·r + 0.1·batch statistic


def no_tf32() -> None:
    """f32 products in full f32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Numerics:
    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (q - t).detach()


F32 = Numerics()
FP8 = Numerics(fp8=True)


def kind_of(name: str, shape) -> str:
    """How a tensor of the model is drawn (:func:`make_weights`)."""
    if name.endswith("num_batches_tracked"):
        return "count"
    if name.endswith("running_mean"):
        return "mean"
    if name.endswith("running_var"):
        return "var"
    if len(shape) == 2:
        return "matrix"
    if name.endswith("adapter.scale"):
        return "scale"
    if name.endswith("weight"):
        return "gamma"
    return "bias"


def make_weights(spec: dict, seed: int, device) -> dict:
    """Seeded weights for every tensor of ``spec`` (name → shape), drawn on
    ``device`` in two calls: matrices N(0, 1/fan_in), LayerNorm and
    BatchNorm scales 1 + 0.2·N, biases and tokens 0.1·N, adapter scales
    0.5 + U, BatchNorm means 0.2·N and variances 0.5 + U. Nothing is left at
    its zero or unit initial value, which would hide a fault."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {n: int(torch.Size(s).numel()) for n, s in spec.items()}
    normal = torch.randn(sum(sizes.values()), generator=gen, device=device)
    uniform = torch.rand(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec.items():
        n, kind = sizes[name], kind_of(name, shape)
        z, u = normal[at:at + n].reshape(shape), uniform[at:at + n].reshape(shape)
        at += n
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "matrix":
            out[name] = z * shape[1] ** -0.5
        elif kind == "gamma":
            out[name] = 1.0 + 0.2 * z
        elif kind == "mean":
            out[name] = 0.2 * z
        elif kind in ("var", "scale"):
            out[name] = 0.5 + u
        else:
            out[name] = 0.1 * z
    return out


def linear(x, w: dict, name: str, num: Numerics, bias: bool = True) -> torch.Tensor:
    b = w[f"{name}.bias"] if bias else None
    return F.linear(num.cast(x), num.cast(w[f"{name}.weight"]), b)


def layer_norm(x, w: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def batch_norm(x, w: dict, name: str, train: bool, stats: dict | None = None) -> torch.Tensor:
    """BatchNorm over the last axis. At inference by the running statistics;
    in training by the batch's mean and biased variance over every leading
    axis, and, with ``stats``, the running statistics it would leave there
    (r ← 0.9·r + 0.1·stat)."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        if stats is not None:
            for key, v in (("running_mean", mean), ("running_var", var)):
                r = stats.get(f"{name}.{key}", w[f"{name}.{key}"])
                stats[f"{name}.{key}"] = BN_MOMENTUM * r + (1 - BN_MOMENTUM) * v.detach()
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * w[f"{name}.weight"]) + w[f"{name}.bias"]


def attention(x, w: dict, name: str, heads: int, num: Numerics) -> torch.Tensor:
    """Multi-head self-attention with one packed qkv product laid out
    (3, heads, head size) along its output."""
    B, S, E = x.shape
    D = E // heads
    qkv = linear(x, w, f"{name}.qkv", num).reshape(B, S, 3, heads, D).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = (num.cast(q) @ num.cast(k).transpose(-1, -2)) * D ** -0.5
    p = torch.softmax(logits, dim=-1)
    out = (num.cast(p) @ num.cast(v)).transpose(1, 2).reshape(B, S, E)
    return linear(out, w, f"{name}.proj", num)
