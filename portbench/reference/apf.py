"""Plain reference of AdaptPointFormer (APF) serving, in f32.

The model (Point-Adapter-Former over a ViT-B trunk): FPS centres in Morton
order with their k nearest points → a mini-PointNet group encoder
(first: C→256→512→E with BatchNorm and ReLU, the group max g; second:
[g, rows]→H→E, the group max) → ``depth`` adapter blocks → LayerNorm → max
over tokens → head (E→512→256→classes, BatchNorm and ReLU). An adapter
block is::

    x = x + attention(LN1(x))
    a = x + scale · up(ReLU(down(LN_a(x))))
    out = mlp(LN2(x)) + a + x          (mlp: fc1 → exact GELU → fc2)

so the token stream is doubled by every block, as in the published code.
Tensor names are the flax module names the program's checkpoints use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import work
from portbench.reference.grouping import apf_group
from portbench.reference.layers import F32, Numerics, attention, batch_norm, layer_norm, linear

__all__ = ["spec", "forward", "forward_flops", "blocks_work"]


def _bn(spec: dict, name: str, n: int) -> None:
    for key in ("weight", "bias", "running_mean", "running_var"):
        spec[f"{name}.{key}"] = (n,)
    spec[f"{name}.num_batches_tracked"] = ()


def _lin(spec: dict, name: str, i: int, o: int, bias: bool = True) -> None:
    spec[f"{name}.weight"] = (o, i)
    if bias:
        spec[f"{name}.bias"] = (o,)


def spec(cfg: dict) -> dict:
    """name → shape of every tensor of the model of ``cfg``."""
    E, C = cfg["embedding_dim"], cfg["in_channels"]
    H = cfg.get("encoder_second_width") or 2 * E
    s: dict = {}
    p = "point_encoder"
    _lin(s, f"{p}.first_0", 2 * C, 256)
    _bn(s, f"{p}.first_bn0", 256)
    _lin(s, f"{p}.first_1", 256, 512)
    _bn(s, f"{p}.first_bn1", 512)
    _lin(s, f"{p}.first_2", 512, E)
    _lin(s, f"{p}.second_0_global", E, H)
    _lin(s, f"{p}.second_0_local", E, H, bias=False)
    _bn(s, f"{p}.second_bn0", H)
    _lin(s, f"{p}.second_1", H, E)
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        for ln in ("norm1", "norm2", "adapter.adapter_norm"):
            s[f"{b}.{ln}.weight"] = s[f"{b}.{ln}.bias"] = (E,)
        _lin(s, f"{b}.attention.qkv", E, 3 * E)
        _lin(s, f"{b}.attention.proj", E, E)
        _lin(s, f"{b}.mlp.fc1", E, 4 * E)
        _lin(s, f"{b}.mlp.fc2", 4 * E, E)
        s[f"{b}.adapter.scale"] = (1,)
        _lin(s, f"{b}.adapter.down_proj", E, cfg["adapter_bottleneck"])
        _lin(s, f"{b}.adapter.up_proj", cfg["adapter_bottleneck"], E)
    s["encoder_norm.weight"] = s["encoder_norm.bias"] = (E,)
    width = E
    for i, o in enumerate((512, 256)):
        _lin(s, f"head.fc{i}", width, o)
        _bn(s, f"head.bn{i}", o)
        width = o
    _lin(s, "head.out", width, cfg["num_classes"])
    return s


def _encoder(x: torch.Tensor, w: dict, num: Numerics) -> torch.Tensor:
    """(M, K, 2C) groups → (M, E) tokens (BatchNorms on running statistics)."""
    p = "point_encoder"
    x = torch.relu(batch_norm(linear(x, w, f"{p}.first_0", num), w, f"{p}.first_bn0", False))
    x = torch.relu(batch_norm(linear(x, w, f"{p}.first_1", num), w, f"{p}.first_bn1", False))
    x = linear(x, w, f"{p}.first_2", num)
    g = x.amax(dim=-2, keepdim=True)
    x = linear(g, w, f"{p}.second_0_global", num) + linear(x, w, f"{p}.second_0_local", num,
                                                            bias=False)
    x = torch.relu(batch_norm(x, w, f"{p}.second_bn0", False))
    return linear(x, w, f"{p}.second_1", num).amax(dim=-2)


def _block(x: torch.Tensor, w: dict, b: str, heads: int, num: Numerics) -> torch.Tensor:
    x = x + attention(layer_norm(x, w, f"{b}.norm1"), w, f"{b}.attention", heads, num)
    h = torch.relu(linear(layer_norm(x, w, f"{b}.adapter.adapter_norm"), w,
                          f"{b}.adapter.down_proj", num))
    adapt = linear(h, w, f"{b}.adapter.up_proj", num) * w[f"{b}.adapter.scale"] + x
    h = F.gelu(linear(layer_norm(x, w, f"{b}.norm2"), w, f"{b}.mlp.fc1", num), approximate="none")
    return linear(h, w, f"{b}.mlp.fc2", num) + adapt + x


@torch.no_grad()
def forward(w: dict, points: torch.Tensor, cfg: dict, num: Numerics = F32) -> torch.Tensor:
    """(B, N, C) clouds → (B, classes) f32 logits of the served model."""
    B = points.shape[0]
    groups = apf_group(points.float(), cfg["npoint"], cfg["nsample"])
    G, K = groups.shape[1:3]
    x = _encoder(groups.reshape(B * G, K, -1), w, num).reshape(B, G, -1)
    for i in range(cfg["depth"]):
        x = _block(x, w, f"blocks.{i}", cfg["num_heads"], num)
    x = layer_norm(x, w, "encoder_norm").amax(dim=-2)
    for i in range(2):
        x = torch.relu(batch_norm(linear(x, w, f"head.fc{i}", num), w, f"head.bn{i}", False))
    return linear(x, w, "head.out", num)


def forward_flops(cfg: dict) -> int:
    """The products of one cloud's forward (:mod:`portbench.work`)."""
    E, G = cfg["embedding_dim"], cfg["npoint"]
    H = cfg.get("encoder_second_width") or 2 * E
    return (work.encoder_flops(G, cfg["nsample"], 2 * cfg["in_channels"], E, H)
            + blocks_work(cfg)[0] + work.head_flops((E, 512, 256, cfg["num_classes"])))


def blocks_work(cfg: dict) -> tuple[int, int, int]:
    """(operations a cloud, activation bytes a cloud, weight bytes a
    request) of the stage the benchmark calls ``blocks``: the blocks."""
    E, S, b = cfg["embedding_dim"], cfg["npoint"], cfg["adapter_bottleneck"]
    flops = cfg["depth"] * work.apf_block_flops(S, E, b)
    acts = 2 * S * E * work.BF16
    weights = cfg["depth"] * (12 * E * E + 2 * E * b) * work.BF16
    return flops, acts, weights
