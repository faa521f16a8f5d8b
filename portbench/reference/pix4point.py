"""Plain reference of Pix4Point, in f32: the serving forward and the
training forward.

The model: one P3 stage (FPS to a quarter of the points, each centre's k
nearest points as [xyz ‖ xyz]; conv1: 6→256→256 (bias on the second only),
BatchNorm, ReLU; [group max ‖ rows]; conv2: 512→512→256, each BatchNorm and
ReLU; group max) → proj 256→E → tokens; a positional MLP on the centres
(3→128, exact GELU, →E); a cls token and its position prepended; ``depth``
pre-norm ViT blocks, the positions added before every block::

    x = x + pos;  x = x + attention(LN1(x));  x = x + mlp(LN2(x))

→ LayerNorm → [max over the point tokens ‖ cls token] → head (2E→256→256→
classes, BatchNorm, ReLU, dropout 0.5 after each hidden layer).

Training draws, in this order, from the one generator the step is given:
the FPS start of every cloud (uniform over its points), then each hidden
layer's dropout mask (U[0, 1) < 0.5 keeps, the kept scaled by 2). The
trunk's dropout and drop-path are 0 and draw nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import work
from portbench.reference.apf import _bn, _lin
from portbench.reference.grouping import p3_group
from portbench.reference.layers import F32, Numerics, attention, batch_norm, layer_norm, linear

__all__ = ["spec", "forward", "forward_flops", "blocks_work", "HEAD_DROPOUT"]

HEAD_DROPOUT = 0.5
TOKEN_WIDTH = 256  # the P3 stage's output width


def spec(cfg: dict) -> dict:
    E, k, C = cfg["embed_dim"], TOKEN_WIDTH, 3
    s: dict = {"model.cls_token": (1, 1, E), "model.cls_pos": (1, 1, E)}
    p = "model.patch_embed.s0"
    _lin(s, f"{p}_conv1_0", 3 + C, k, bias=False)
    _lin(s, f"{p}_conv1_1", k, k)
    _bn(s, f"{p}_conv1_bn", k)
    _lin(s, f"{p}_conv2_0", 2 * k, 2 * k, bias=False)
    _bn(s, f"{p}_conv2_bn0", 2 * k)
    _lin(s, f"{p}_conv2_1", 2 * k, k, bias=False)
    _bn(s, f"{p}_conv2_bn1", k)
    _lin(s, "model.proj", k, E)
    _lin(s, "model.pos_embed.fc1", 3, 128)
    _lin(s, "model.pos_embed.fc2", 128, E)
    for i in range(cfg["depth"]):
        b = f"model.blocks.{i}"
        s[f"{b}.norm1.weight"] = s[f"{b}.norm1.bias"] = (E,)
        _lin(s, f"{b}.attn.qkv", E, 3 * E)
        _lin(s, f"{b}.attn.proj", E, E)
        s[f"{b}.norm2.weight"] = s[f"{b}.norm2.bias"] = (E,)
        _lin(s, f"{b}.mlp.fc1", E, 4 * E)
        _lin(s, f"{b}.mlp.fc2", 4 * E, E)
    s["model.norm.weight"] = s["model.norm.bias"] = (E,)
    width = 2 * E
    for i in range(2):
        _lin(s, f"cls_head.fc{i}", width, 256)
        _bn(s, f"cls_head.bn{i}", 256)
        width = 256
    _lin(s, "cls_head.out", width, cfg["num_classes"])
    return s


def _p3(groups: torch.Tensor, w: dict, num: Numerics, train: bool, stats) -> torch.Tensor:
    p = "model.patch_embed.s0"
    bn = lambda t, n: torch.relu(batch_norm(t, w, f"{p}_{n}", train, stats))  # noqa: E731
    x = linear(linear(groups, w, f"{p}_conv1_0", num, bias=False), w, f"{p}_conv1_1", num)
    x = bn(x, "conv1_bn")
    x = torch.cat([x.amax(dim=-2, keepdim=True).expand_as(x), x], dim=-1)
    x = bn(linear(x, w, f"{p}_conv2_0", num, bias=False), "conv2_bn0")
    x = bn(linear(x, w, f"{p}_conv2_1", num, bias=False), "conv2_bn1")
    return x.amax(dim=-2)


def forward(w: dict, points: torch.Tensor, cfg: dict, num: Numerics = F32, *,
            train: bool = False, generator: torch.Generator | None = None,
            stats: dict | None = None) -> torch.Tensor:
    """(B, N, 3) clouds → (B, classes) f32 logits. ``train`` takes batch
    statistics (their running values into ``stats``) and the draws of the
    module docstring from ``generator``; grads flow unless the caller turns
    them off."""
    B, N, _ = points.shape
    E = cfg["embed_dim"]
    start = None
    if train:
        start = torch.randint(0, N, (B,), generator=generator, device=generator.device)
    centers, groups = p3_group(points, points, N // 4, cfg["k_neighbors"], start)
    x = linear(_p3(groups, w, num, train, stats), w, "model.proj", num)
    pos = linear(F.gelu(linear(centers, w, "model.pos_embed.fc1", num), approximate="none"),
                 w, "model.pos_embed.fc2", num)
    x = torch.cat([w["model.cls_token"].expand(B, 1, E), x], dim=1)
    pos = torch.cat([w["model.cls_pos"].expand(B, 1, E), pos], dim=1)
    for i in range(cfg["depth"]):
        b = f"model.blocks.{i}"
        x = x + pos
        x = x + attention(layer_norm(x, w, f"{b}.norm1"), w, f"{b}.attn", cfg["num_heads"], num)
        h = F.gelu(linear(layer_norm(x, w, f"{b}.norm2"), w, f"{b}.mlp.fc1", num),
                   approximate="none")
        x = x + linear(h, w, f"{b}.mlp.fc2", num)
    x = layer_norm(x, w, "model.norm")
    x = torch.cat([x[:, 1:].amax(dim=1), x[:, 0]], dim=-1)
    for i in range(2):
        x = torch.relu(batch_norm(linear(x, w, f"cls_head.fc{i}", num), w, f"cls_head.bn{i}",
                                  train, stats))
        if train:
            keep = 1.0 - HEAD_DROPOUT
            mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
            x = torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))
    return linear(x, w, "cls_head.out", num)


def forward_flops(cfg: dict) -> int:
    """The products of one cloud's forward (:mod:`portbench.work`)."""
    E, S = cfg["embed_dim"], cfg["points"] // 4
    return (work.p3_stage_flops(S, cfg["k_neighbors"]) + blocks_work(cfg)[0]
            + work.head_flops((2 * E, 256, 256, cfg["num_classes"])))


def blocks_work(cfg: dict) -> tuple[int, int, int]:
    """(operations a cloud, activation bytes a cloud, weight bytes a
    request) of the stage the benchmark calls ``blocks``: from the P3
    tokens to the last block (proj, the positional MLP and the blocks)."""
    E, S, T, mm = cfg["embed_dim"], cfg["points"] // 4, TOKEN_WIDTH, work.mm
    flops = (mm(S, T, E) + mm(S, 3, 128) + mm(S, 128, E)
             + cfg["depth"] * work.vit_block_flops(S + 1, E))
    acts = S * T * work.BF16 + S * 3 * 4 + (S + 1) * E * work.BF16
    weights = (T * E + 3 * 128 + 128 * E + cfg["depth"] * 12 * E * E) * work.BF16
    return flops, acts, weights
