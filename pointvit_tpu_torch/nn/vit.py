"""Transformer blocks (the APF block, the timm pre-norm ViT block, the
torchvision block with serial adapters) and the renderer's image ViT.

Counterpart of ``pointvit_tpu/nn/vit.py``. ``APFBlock`` has the reference's
double residual (``nn/vit.py:153-226``)::

    x   = x + drop_path(attn(norm1(x)))
    out = drop_path(mlp(norm2(x))) + adapter(x) + x     # adapter(x) adds x itself

At inference the block runs :func:`~pointvit_tpu_torch.ops.block_kernel.fused_apf_block`
(the kernel chain on the card) or, with ``implementation='torch'``, its
plain version. In training it leaves the fused block, as the JAX block does
when dropout is on (``nn/vit.py:70-71``): LayerNorms and products are plain
PyTorch, the attention is ``fused_mha_qkv`` (its forward and backward
kernels on the card), and the adapter's dropout and both drop-paths draw
from the generator given. A quantized block (``quantized=True``, inference
only) runs that unfused forward too, with its qkv, proj, fc1 and fc2 as
int8 products, as the JAX block leaves its fused kernels when quantized
(``nn/vit.py:181``). So does a block whose shape lies outside the fused
gate (:func:`~pointvit_tpu_torch.ops.block_kernel.apf_block_shapes_ok`:
head dim 64, S ≤ 1024), as the JAX block leaves its fused kernel there
(``nn/vit.py:53-75``); its attention kernel takes any S. ``ViTBlock`` and
``SerialAdapterBlock`` leave their fused chains outside that gate too, for
an unfused forward through their layer modules.

Tensor parallelism (DTensor weights from
:func:`~pointvit_tpu_torch.parallel.transformer_tp_shardings`) runs the
plain path: a block with such weights takes :meth:`forward_unfused` with
``implementation='torch'`` and raises on the kernel path, whose kernels take
whole weights (as GSPMD cannot partition a Pallas call).

Each block keeps the weights its kernel chain launches with (cast to the
compute dtype, for APF also folded and transposed) and makes them anew only
when a parameter changes, as ``QuantLinear`` keeps its int8 weight: an
in-place update bumps the parameter's version, a move changes its storage.
A block that is an FSDP unit keeps nothing: FSDP gathers its weights into
the same storage before each forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointvit_tpu_torch._build import exporting
from pointvit_tpu_torch.nn.layers import (
    AdapterLayer,
    Attention,
    Dropout,
    DropPath,
    Mlp,
    SimpleAdapter,
    layer_norm,
)
from pointvit_tpu_torch.ops.block_kernel import (
    LN_EPS,
    apf_block_shapes_ok,
    apf_block_weights,
    apf_launch_weights,
    fused_apf_block,
    reference_apf_block,
)
from pointvit_tpu_torch.ops.gemm_kernel import gemm, reference_gemm
from pointvit_tpu_torch.ops.serial_block_kernel import (
    fused_serial_block,
    reference_serial_block,
    serial_block_shapes_ok,
    serial_block_weights,
)
from pointvit_tpu_torch.ops.vit_block_kernel import (
    fused_vit_block,
    reference_vit_block,
    vit_block_shapes_ok,
    vit_block_weights,
)
from pointvit_tpu_torch.parallel.mesh import DTENSOR

try:
    from torch.distributed.fsdp import FSDPModule
except ImportError:  # a build without distributed support
    FSDPModule = None

__all__ = ["APFBlock", "ViTBlock", "SerialAdapterBlock", "PatchifyDense", "ImageViT"]


class LaunchWeights:
    """A block's launch-ready weights, made by ``make`` once and kept until
    one of the block's parameters changes (its version or storage) or the
    key (dtype, device) differs. Parameters made under ``inference_mode``
    have no version to key on: then the weights are made on every call. So
    are they while ``torch.export`` traces, whose fake parameters have no
    storage (the program computes them, and the cache is left as it was),
    and for a module that is an FSDP unit, whose gathered weights come back
    into the same storage with new values after a step."""

    def __init__(self) -> None:
        self._key = None
        self._value = None

    def get(self, module: nn.Module, make, *key):
        params = tuple(module.parameters())
        if exporting() or any(p.is_inference() for p in params) \
                or (FSDPModule is not None and isinstance(module, FSDPModule)):
            return make()
        key = (key, tuple((p._version, p.data_ptr()) for p in params))
        if key != self._key:
            self._key, self._value = key, make()
        return self._value


def _unfused_for_tp(block: nn.Module, attn: nn.Module, mlp: nn.Module) -> bool:
    """True when a tensor-parallel plan sharded the block's attention or MLP
    (the pairs :func:`~pointvit_tpu_torch.parallel.transformer_tp_shardings`
    shards, whose column layer then holds a DTensor): the plain path then
    runs the block unfused; the kernel path raises."""
    if DTENSOR is None or not (isinstance(attn.qkv.weight, DTENSOR)
                               or isinstance(mlp.fc1.weight, DTENSOR)):
        return False
    if block.implementation is None:
        raise ValueError(
            f"{type(block).__name__}: tensor-parallel (DTensor) weights cannot enter the "
            "hand-written block kernels, which take whole weights; build the model with "
            "implementation='torch' for tensor parallelism")
    return True


class APFBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        adapter_bottleneck: int = 64,
        dtype: torch.dtype = torch.float32,
        implementation: str | None = None,
        drop_path_rate: float = 0.0,
        dropout_rate: float = 0.1,
        quantized: bool = False,
    ) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.implementation = implementation
        self.quantized = quantized
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = Attention(dim, num_heads, implementation=implementation,
                                   quantized=quantized)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 4 * dim, quantized, implementation)
        self.adapter = AdapterLayer(dim, adapter_bottleneck, dropout_rate)
        self.drop_path = DropPath(drop_path_rate)
        self._launch = LaunchWeights()

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, S, E) → (B, S, E) in the block's dtype."""
        x = x.to(self.dtype)
        if (train or self.quantized or not apf_block_shapes_ok(*x.shape[-2:], self.num_heads)
                or _unfused_for_tp(self, self.attention, self.mlp)):
            return self.forward_unfused(x, train=train, generator=generator)
        weights = apf_block_weights(self)
        if self.implementation == "torch":
            return reference_apf_block(x, weights, self.num_heads)
        ready = None
        if x.is_cuda:
            ready = self._launch.get(self, lambda: apf_launch_weights(weights, x.dtype, x.device),
                                     x.dtype, x.device)
        return fused_apf_block(x, weights, self.num_heads, ready)

    def forward_unfused(self, x: torch.Tensor, *, train: bool = False,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """The block through its layer modules, one plain op at a time (with
        the attention kernels on the card). Random draws, in order: the
        attention branch's drop-path, the adapter's dropout, the MLP
        branch's drop-path."""
        kw = dict(train=train, generator=generator)
        x = x + self.drop_path(self.attention(layer_norm(x, self.norm1)), **kw)
        adapt = self.adapter(x, **kw)
        return self.drop_path(self.mlp(layer_norm(x, self.norm2)), **kw) + adapt + x


class ViTBlock(nn.Module):
    """Standard pre-norm transformer block (timm layout: ``norm1``, ``attn``
    (``qkv``, ``proj``), ``norm2``, ``mlp`` (``fc1``, ``fc2``)), the
    Pix4Point trunk block (``nn/vit.py:82-150``)::

        x = x + pos;  x = x + attn(norm1(x));  out = x + mlp(norm2(x))

    At inference it runs :func:`~pointvit_tpu_torch.ops.vit_block_kernel.fused_vit_block`
    for the shapes of the blocks' gate (head dim 64, S ≤ 1024: the JAX
    package's fused gate, ``pallas_block.py:97-110``, at head dim 64): on
    the card the kernel chain, with ``implementation='torch'`` or on the CPU
    its plain version. Other shapes take :meth:`forward_unfused`, as the JAX
    block leaves its fused kernels there (``nn/vit.py:128-150``); its
    attention kernel takes any S. So does ``train=True``, as the JAX block
    leaves its fused kernels for a stochastic call (``nn/vit.py:70-71``):
    the attention is ``fused_mha_qkv`` (the forward and backward kernels on
    the card), and the dropout (``dropout_rate``, in the MLP) and drop-path
    (``drop_path_rate``, on both branches) draw from the generator given.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, implementation: str | None = None,
                 dropout_rate: float = 0.0, drop_path_rate: float = 0.0) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        if mlp_ratio != 4.0:
            raise ValueError("the ViT block kernels take the timm hidden width 4·dim only")
        self.num_heads = num_heads
        self.dtype = dtype
        self.implementation = implementation
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, implementation=implementation)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout_rate=dropout_rate)
        self.drop_path = DropPath(drop_path_rate)
        self._launch = LaunchWeights()

    def forward(self, x: torch.Tensor, *, pos: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, S, E) → (B, S, E) in the block's dtype; ``pos`` (B, S, E) or
        (1, S, E) is added first, in that dtype."""
        x = x.to(self.dtype)
        if pos is not None:
            pos = pos.to(self.dtype)
        if train or not vit_block_shapes_ok(*x.shape[-2:], self.num_heads) \
                or _unfused_for_tp(self, self.attn, self.mlp):
            return self.forward_unfused(x, pos=pos, train=train, generator=generator)
        weights = self._launch.get(self, lambda: vit_block_weights(self, self.dtype), self.dtype)
        if self.implementation == "torch":
            return reference_vit_block(x, weights, self.num_heads, pos)
        return fused_vit_block(x, weights, self.num_heads, pos)

    def forward_unfused(self, x: torch.Tensor, *, pos: torch.Tensor | None = None,
                        train: bool = False,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """The block through its layer modules, one plain op at a time (with
        the attention kernels on the card), step for step the JAX block's
        non-fused branch: ``pos`` added in x's dtype, then the two
        residual branches. Random draws, in order: the attention branch's
        drop-path, the MLP's two dropouts, the MLP branch's drop-path."""
        kw = dict(train=train, generator=generator)
        if pos is not None:
            x = x + pos.to(x.dtype)
        x = x + self.drop_path(self.attn(layer_norm(x, self.norm1)), **kw)
        return x + self.drop_path(self.mlp(layer_norm(x, self.norm2), **kw), **kw)


class SerialAdapterBlock(nn.Module):
    """Torchvision encoder block with serial adapters (``ln_1``,
    ``self_attention`` (``qkv``, ``proj``), ``adapter1``, ``ln_2``, ``mlp``
    (``fc1``, ``fc2``), ``adapter2``), the renderer's per-view block
    (``nn/vit.py:229-294``)::

        y = self_attention(ln_1(x));  x = x + adapter1(y)
        y = mlp(ln_2(x));             x = x + adapter2(y)

    (each adapter is residual itself: a(y) = y + up(gelu(down(y)))). At
    inference it runs
    :func:`~pointvit_tpu_torch.ops.serial_block_kernel.fused_serial_block`
    for the shapes of the blocks' gate (head dim 64, S ≤ 1024): on the card
    the kernel chain, with ``implementation='torch'`` or on the CPU its
    plain version. Other shapes take :meth:`forward_unfused`, as the JAX
    block leaves its fused kernels there (``nn/vit.py:275-294``). So does
    ``train=True``, as the JAX block leaves its fused kernels for a
    stochastic call (``nn/vit.py:70-71``): the attention is
    ``fused_mha_qkv`` (the forward and backward kernels on the card), and
    the dropouts (``dropout_rate``: after the attention and in the MLP) draw
    from the generator given.
    """

    def __init__(self, dim: int, num_heads: int, adapter_bottleneck: int = 64,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 implementation: str | None = None, dropout_rate: float = 0.0) -> None:
        super().__init__()
        if implementation not in (None, "torch"):
            raise ValueError(f"unknown implementation: {implementation!r}")
        if mlp_ratio != 4.0:
            raise ValueError("the serial block kernels take the torchvision hidden width 4·dim only")
        self.num_heads = num_heads
        self.dtype = dtype
        self.implementation = implementation
        self.ln_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.self_attention = Attention(dim, num_heads, implementation=implementation)
        self.dropout = Dropout(dropout_rate)
        self.adapter1 = SimpleAdapter(dim, adapter_bottleneck)
        self.ln_2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout_rate=dropout_rate)
        self.adapter2 = SimpleAdapter(dim, adapter_bottleneck)
        self._launch = LaunchWeights()

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, S, E) → (B, S, E) in the block's dtype."""
        x = x.to(self.dtype)
        if (train or not serial_block_shapes_ok(*x.shape[-2:], self.num_heads)
                or _unfused_for_tp(self, self.self_attention, self.mlp)):
            return self.forward_unfused(x, train=train, generator=generator)
        weights = self._launch.get(self, lambda: serial_block_weights(self, self.dtype), self.dtype)
        if self.implementation == "torch":
            return reference_serial_block(x, weights, self.num_heads)
        return fused_serial_block(x, weights, self.num_heads)

    def forward_unfused(self, x: torch.Tensor, *, train: bool = False,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """The block through its layer modules, one plain op at a time (with
        the attention kernels on the card), step for step the JAX block's
        non-fused branch. Random draws, in order: the dropout after the
        attention, the MLP's two dropouts."""
        kw = dict(train=train, generator=generator)
        x = x + self.adapter1(self.dropout(self.self_attention(layer_norm(x, self.ln_1)), **kw))
        return x + self.adapter2(self.mlp(layer_norm(x, self.ln_2), **kw))


class PatchifyDense(nn.Module):
    """Stride-P patch embedding as one product over flattened patches
    (``nn/vit.py:297-321``): NHWC images (B, H, W, C) → (B, patches, E),
    patches in row-major order, each flattened in (ph, pw, c) order.
    ``weight`` is (E, P·P·C) with its columns in that order: the flax conv
    kernel (P, P, C, E) reshaped to (P·P·C, E) and transposed (the weight
    bridge does this). The product is the bf16 GEMM with the bias in its
    epilogue (``csrc/gemm.cu``) on the card, its plain version with
    ``implementation='torch'`` or on the CPU. The kernel has no backward, so
    in training (``train=True``) the product is a plain ``F.linear`` in the
    compute dtype, as the JAX package leaves it to XLA: the renderer trains
    through the images, so their gradient flows back to the renderer."""

    def __init__(self, embed_dim: int, patch_size: int, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32, implementation: str | None = None) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.implementation = implementation
        self.weight = nn.Parameter(torch.empty(embed_dim, patch_size * patch_size * in_chans))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        nn.init.trunc_normal_(self.weight, std=self.weight.shape[1] ** -0.5)

    def forward(self, images: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        B, H, W, C = images.shape
        P = self.patch_size
        x = images.to(self.dtype).reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B * (H // P) * (W // P), P * P * C).contiguous()
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if train:
            out = F.linear(x, w, b)
        else:
            product = reference_gemm if self.implementation == "torch" else gemm
            out, _ = product(x, w, b, out_dtype=self.dtype)
        return out.reshape(B, (H // P) * (W // P), -1)


class ImageViT(nn.Module):
    """Torchvision-layout image ViT returning the cls-token feature, the
    renderer's trunk (``nn/vit.py:324-384``): ``conv_proj`` patchify → cls
    token (``class_token``) prepended → ``+ pos_embedding`` in the compute
    dtype → ``depth`` serial-adapter blocks (``encoder_layer.{i}``, the flax
    ``encoder_layer_{i}``) → final LayerNorm ``ln`` → the cls row. NHWC
    input, as in the JAX package. ``dropout_rate`` applies after the pos
    embedding and in every block; in training (``train=True``) it draws
    from the generator given, in that order."""

    def __init__(self, depth: int = 12, embed_dim: int = 768, num_heads: int = 12,
                 patch_size: int = 16, img_size: int = 224, adapter_bottleneck: int = 64,
                 dtype: torch.dtype = torch.float32, implementation: str | None = None,
                 dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv_proj = PatchifyDense(embed_dim, patch_size, dtype=dtype,
                                       implementation=implementation)
        self.class_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        seq = (img_size // patch_size) ** 2 + 1
        self.pos_embedding = nn.Parameter(0.02 * torch.randn(1, seq, embed_dim))
        self.dropout = Dropout(dropout_rate)
        self.encoder_layer = nn.ModuleList(
            SerialAdapterBlock(embed_dim, num_heads, adapter_bottleneck, dtype=dtype,
                               implementation=implementation, dropout_rate=dropout_rate)
            for _ in range(depth)
        )
        self.ln = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, H, W, C) → (B, E) in the compute dtype."""
        kw = dict(train=train, generator=generator)
        x = self.conv_proj(images, train=train)
        B, _, E = x.shape
        x = torch.cat([self.class_token.expand(B, 1, E).to(x.dtype), x], dim=1)
        x = self.dropout(x + self.pos_embedding.to(x.dtype), **kw)
        for block in self.encoder_layer:
            x = block(x, **kw)
        # The LayerNorm is per row, so normalising the cls rows alone gives
        # the same feature.
        return layer_norm(x[:, 0], self.ln)
