"""Weight bridge: a JAX package variable tree → the port's modules.

``load_flax_variables(model, variables)`` takes the
``{"params": ..., "batch_stats": ...}`` tree of a ``pointvit_tpu`` model as
nested dicts of numpy arrays and copies it into the matching port module:

- a Dense ``kernel`` (in, out) becomes ``Linear.weight`` = kernel.T;
- a conv ``kernel`` (kh, kw, cin, out), the renderer's patchify, becomes
  the 2-D weight kernel.reshape(kh·kw·cin, out).T, columns in the (kh, kw,
  cin) order in which the patches are flattened (a plain ``.T`` would give
  (out, cin, kw, kh): a ``Conv2d`` weight's shape with the spatial axes
  swapped);
- a LayerNorm or BatchNorm ``scale`` becomes ``weight`` (the adapter's own
  ``scale`` parameter, shape (1,), keeps its name);
- BatchNorm ``mean``/``var`` become ``running_mean``/``running_var``;
- ``blocks_{i}`` becomes ``blocks.{i}`` and ``encoder_layer_{i}``
  becomes ``encoder_layer.{i}``.

Any key missing on either side, or a shape that disagrees, raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["load_flax_variables", "flax_to_state_dict"]

_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(parts) -> str:
    return ".".join(re.sub(r"^(blocks|encoder_layer)_(\d+)$", r"\1.\2", p) for p in parts)


def flax_to_state_dict(variables, target_keys) -> dict[str, torch.Tensor]:
    """Rename and re-lay-out a flax variable tree into ``state_dict`` form.
    ``target_keys`` (the module's state_dict keys) resolves ``scale``."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {collection!r}")
        for path, value in _flatten(tree):
            mod, leaf = _module_path(path[:-1]), path[-1]
            arr = np.asarray(value, dtype=np.float32)
            if collection == "batch_stats":
                if leaf not in _STATS:
                    raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
                name = _STATS[leaf]
            elif leaf == "kernel":
                name = "weight"
                arr = arr.reshape(-1, arr.shape[-1]).T if arr.ndim == 4 else arr.T
            elif leaf == "scale":
                name = "scale" if f"{mod}.scale" in target_keys else "weight"
            else:
                name = leaf
            key = f"{mod}.{name}" if mod else name
            if key in out:
                raise KeyError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


def load_flax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Fill ``model`` from a flax variable tree; raises on any missing or
    unused key and on any shape mismatch. Returns ``model``."""
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    new = flax_to_state_dict(variables, own.keys())
    missing = sorted(set(own) - set(new))
    unused = sorted(set(new) - set(own))
    if missing or unused:
        raise KeyError(f"flax tree does not match the model: missing {missing}, unused {unused}")
    for k, v in new.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: model has {tuple(own[k].shape)}, flax tree {tuple(v.shape)}")
    model.load_state_dict(new, strict=False)
    return model
