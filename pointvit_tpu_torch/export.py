"""Deployment artifacts: a model's forward exported by ``torch.export``.

Counterpart of ``pointvit_tpu/export.py``, with ``torch.export`` in place
of StableHLO. The artifact is one file (``torch.export.save``) that holds
the traced forward and its weights: ``load_exported(path)(points)`` runs it
with no model class and no checkpoint, given only the port's op library
(``import pointvit_tpu_torch.ops``, which registers the kernels' custom ops).

- **The kernels.** Every kernel wrapper calls its custom op
  (``torch.ops.pointvit_tpu_torch.*``, ``_build.kernel_op``) while
  ``torch.export`` traces, so the program holds the op wherever the eager
  forward launches the kernel, and the op runs the kernel when the program
  runs on the card. The folded encoder, the P3 stage and each block are one
  op each (the chain inside chooses its route from the real shapes, as the
  eager call does). A model exported on the card runs the hand-written
  kernels; one exported on the CPU runs their plain versions. Nothing falls
  back: a trace that fails raises.
- **Shapes.** Batch-polymorphic by default, on the card as on the CPU: one
  program serves every batch size (the batch axis is a symbolic dimension;
  the shape routes that depend on it lie inside the ops), so the serving
  ladder (``serve.py``) needs one artifact. The point count and channels
  are fixed by the example. ``batch_polymorphic=False`` fixes the batch
  too, and the program then refuses any other.
- **Weights.** The program holds what the eager forward keeps in caches,
  made once at export and stored in place of the parameters they come
  from: each fused block's launch weights (cast to the compute dtype, the
  APF block's also folded and transposed) and each quantized layer's int8
  weight and scales. A call feeds them straight to the kernels' ops, with
  no re-layout, as JAX bakes its variables into its artifact as constants
  (``pointvit_tpu/export.py:44-63``). The export traces a copy of the model
  that shares its parameters (:func:`baked_copy`); the live model and its
  caches are left as they were.

The CLI is ``python -m pointvit_tpu_torch.export --checkpoint ... --out ...``
(the counterpart of ``scripts/export_model.py``).
"""

from __future__ import annotations

import argparse
import copy
import io
import json

import numpy as np
import torch

import pointvit_tpu_torch.ops  # noqa: F401  (registers the kernels' custom ops)
from pointvit_tpu_torch._build import bake, baking

__all__ = ["baked_copy", "export_forward", "load_forward", "save_exported", "load_exported"]

MAX_BATCH = 1 << 16  # the symbolic batch's range in a batch-polymorphic program
_META = "pointvit_meta.json"


class _Forward(torch.nn.Module):
    """The inference forward, f32 logits, as the traced module."""

    def __init__(self, model: torch.nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        return self.model(points).float()


def _raw_parameters(module: torch.nn.Module) -> list[tuple[torch.nn.Module, str]]:
    """The parameters a module's baked weights stand for: every parameter
    of a block (its launch weights come from all of them), a quantized
    layer's weight (its bias stays, added by the kernel's epilogue)."""
    from pointvit_tpu_torch.nn.quant import QuantLinear

    if isinstance(module, QuantLinear):
        return [(module, "weight")]
    return [(m, n) for m in module.modules() for n, p in m._parameters.items() if p is not None]


def baked_copy(model: torch.nn.Module, example: torch.Tensor) -> torch.nn.Module:
    """A copy of ``model`` (eval mode) that shares its parameters and
    buffers, in which every module that made launch weights on one forward
    of ``example`` holds them as buffers, in place of the parameters they
    come from. The forward is eager, so it takes the routes the traced
    program will take (a block outside its fused gate bakes nothing); the
    live model is left as it was."""
    memo = {id(t): t for t in (*model.parameters(), *model.buffers())}
    copied = copy.deepcopy(model, memo)
    with torch.no_grad(), baking() as made:
        copied(example)
    for module, weights in made.items():
        bake(module, weights, _raw_parameters(module))
    return copied


def export_forward(model: torch.nn.Module, example, *, batch_polymorphic: bool = True) -> bytes:
    """Export ``model(points)`` at inference, f32 logits, to bytes.

    Args:
        model: a family's module (``models/factory.py``), on the device the
            artifact is to run on; it is put in eval mode.
        example: (B, N, C) array or tensor fixing N and C (and B when
            ``batch_polymorphic=False``).
        batch_polymorphic: export the batch axis as a symbolic dimension so
            that one program serves every batch size.

    Returns:
        The bytes of ``torch.export.save``: load them with
        :func:`load_forward`.
    """
    model.eval()
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(example, np.float32), device=device)
    if x.dim() != 3:
        raise ValueError(f"example must be (B, N, C), got {tuple(x.shape)}")
    dynamic = None
    if batch_polymorphic:
        # Traced at two clouds: torch.export specialises an axis of size 1.
        x = x[:1].expand(2, -1, -1).contiguous()
        dynamic = ({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},)
    baked = baked_copy(model, x)
    with torch.no_grad():
        program = torch.export.export(_Forward(baked), (x,), dynamic_shapes=dynamic, strict=False)
    meta = {"points": x.shape[1], "channels": x.shape[2], "device": str(device),
            "batch": None if batch_polymorphic else x.shape[0]}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


class ExportedForward:
    """A loaded artifact: ``fn(points) -> logits``, points a (B, N, C) array
    or tensor (moved to the artifact's device), logits an f32 tensor there.
    ``meta`` holds the exported points, channels, device and batch (None:
    any)."""

    def __init__(self, program, meta: dict) -> None:
        self.module = program.module()
        self.meta = meta
        self.device = torch.device(meta["device"])

    @torch.no_grad()
    def __call__(self, points) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(points, np.float32) if not torch.is_tensor(points) else points,
                            dtype=torch.float32, device=self.device)
        return self.module(x.contiguous())


def load_forward(blob: bytes) -> ExportedForward:
    """:func:`export_forward`'s bytes → the callable program."""
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return ExportedForward(program, json.loads(extra[_META]))


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported(path: str) -> ExportedForward:
    """File-path convenience over :func:`load_forward`."""
    with open(path, "rb") as f:
        return load_forward(f.read())


def main(argv=None) -> None:
    """``python -m pointvit_tpu_torch.export --checkpoint PATH --out PATH``:
    restore a checkpoint (JAX ``.msgpack`` or the port's ``.pt``, with its
    sidecar) as the serving engine does and write its forward's artifact;
    prints one JSON line."""
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--family", default=None)
    ap.add_argument("--raw-weights", action="store_true",
                    help="export the raw parameters of an EMA checkpoint, not the averaged ones")
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--static-batch", type=int, default=0,
                    help="fix the batch axis (default 0: batch-polymorphic)")
    ap.add_argument("--device", default="cuda", help="where the artifact runs (default: the card)")
    args = ap.parse_args(argv)

    from pointvit_tpu_torch.serve import InferenceSession

    sess = InferenceSession.from_checkpoint(args.checkpoint, family=args.family,
                                            use_ema=not args.raw_weights, device=args.device)
    channels = sess.in_channels
    example = np.zeros((max(args.static_batch, 1), args.points, channels), np.float32)
    blob = export_forward(sess.model, example, batch_polymorphic=args.static_batch == 0)
    save_exported(args.out, blob)
    print(json.dumps({
        "out": args.out,
        "bytes": len(blob),
        "batch": "polymorphic" if args.static_batch == 0 else args.static_batch,
        "points": args.points,
        "in_channels": channels,
        "device": str(sess.device),
    }))


if __name__ == "__main__":
    main()
