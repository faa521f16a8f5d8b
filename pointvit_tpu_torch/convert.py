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

``state_dict_to_flax(model)`` is the inverse: the port module's weights as
the JAX package's ``{"params", "batch_stats"}`` tree of f32 numpy arrays,
so that a checkpoint in the JAX layout can be written without JAX
(``train/checkpoint.py``).

``load_optax_state(model, optimizer, opt_state)`` and its inverse
``adamw_to_optax(model, optimizer)`` do the same for the optimizer: a JAX
trainer's optax AdamW state (flax's ``to_state_dict`` layout) and the
port's :class:`~pointvit_tpu_torch.train.trainer.MaskedAdamW`. The JAX
trainers build the optimizer as (``pointvit_tpu/train/trainer.py:120-151``)

    multi_transform({True: chain([clip_by_global_norm,] adamw(schedule,
                     mask=no-decay mask)), False: set_to_zero}, trainable mask)

so the ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) sits at
``inner_states/True/inner_state/<i>/0`` with ``<i>`` 1 under clipping
(else 0), or at ``<i>/0`` without a trainable mask; beside it ``<i>/1`` is
the decay's state (``{"inner_state": {}}`` under a no-decay mask, else
``{}``) and ``<i>/2/count`` the schedule's count. ``mu`` and ``nu`` are
parameter trees whose frozen leaves are ``{}`` (optax's ``MaskedNode``).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_variables", "flax_to_state_dict", "state_dict_to_flax", "adamw_to_optax",
           "load_optax_state"]

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
                name = "scale" if (f"{mod}.scale" if mod else "scale") in target_keys else "weight"
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


def _flax_path(module_name: str) -> list[str]:
    """``blocks.3.attn`` → ["blocks_3", "attn"] (the inverse of
    :func:`_module_path`)."""
    return re.sub(r"(^|\.)(blocks|encoder_layer)\.(\d+)(?=\.|$)", r"\1\2_\3", module_name).split(".") \
        if module_name else []


def _put(tree: dict, path: list[str], value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    if path[-1] in tree:
        raise KeyError(f"two tensors map to {'/'.join(path)}")
    tree[path[-1]] = value


def state_dict_to_flax(model: torch.nn.Module) -> dict:
    """The module's parameters and BatchNorm statistics as the JAX package's
    variable tree ``{"params": ..., "batch_stats": ...}`` of f32 numpy
    arrays: a ``Linear`` weight becomes the Dense ``kernel`` = weight.T; the
    patchify's 2-D weight the conv kernel (kh, kw, cin, out), its columns
    unflattened in (kh, kw, cin) order; a LayerNorm or BatchNorm ``weight``
    becomes ``scale``; ``running_mean``/``running_var`` become
    ``mean``/``var``; ``blocks.{i}`` becomes ``blocks_{i}``. The inverse of
    :func:`flax_to_state_dict`."""
    params = _params_to_flax(model, lambda p: p)
    stats = {}
    for name, module in model.named_modules():
        path = _flax_path(name)
        for leaf, b in module.named_buffers(recurse=False):
            if leaf == "num_batches_tracked":
                continue
            if leaf not in ("running_mean", "running_var"):
                raise KeyError(f"no flax name for the buffer {name}.{leaf}")
            _put(stats, path + [leaf[len("running_"):]], b.detach().to("cpu", torch.float32).numpy().copy())
    return {"params": params, "batch_stats": stats}


def _params_to_flax(model: torch.nn.Module, value) -> dict:
    """The JAX params tree of ``value(p)`` for each parameter ``p`` of the
    module (a tensor of the parameter's shape, re-laid out as the parameter
    is), or ``{}`` where ``value`` gives None (optax's ``MaskedNode``)."""
    from pointvit_tpu_torch.nn.vit import PatchifyDense

    params = {}
    for name, module in model.named_modules():
        path = _flax_path(name)
        for leaf, p in module.named_parameters(recurse=False):
            t = value(p)
            arr = None if t is None else t.detach().to("cpu", torch.float32).numpy()
            if leaf == "weight":
                if isinstance(module, PatchifyDense):
                    P = module.patch_size
                    E, K = p.shape
                    leaf = "kernel"
                    arr = None if arr is None else arr.T.reshape(P, P, K // (P * P), E)
                elif isinstance(module, nn.Linear):
                    leaf = "kernel"
                    arr = None if arr is None else arr.T
                elif isinstance(module, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
                    leaf = "scale"
                else:
                    raise KeyError(f"no flax name for the weight of {name} ({type(module).__name__})")
            _put(params, path + [leaf], {} if arr is None else np.ascontiguousarray(arr))
    return params


def adamw_to_optax(model: torch.nn.Module, optimizer) -> dict:
    """``optimizer``'s (a ``MaskedAdamW`` over ``model``) state as the
    ``opt_state`` a JAX trainer with the same options writes (the layout in
    the module docstring; ``optimizer.masked`` says whether a trainable mask
    was given): each trainable parameter's ``exp_avg``/``exp_avg_sq`` as
    ``mu``/``nu`` in the flax layout (zeros before its first update), ``{}``
    for a frozen one, its ``step`` as the Adam ``count`` and
    ``optimizer.count`` as the schedule's. Raises when the trainable
    parameters' steps differ (optax keeps one count)."""
    state = optimizer.optimizer.state
    trainable = {id(p) for p in optimizer.params}
    steps = {int(state[p]["step"]) for p in optimizer.params if "step" in state.get(p, {})}
    if len(steps) > 1:
        raise ValueError(f"the trainable parameters' Adam steps differ ({sorted(steps)}); "
                         "an optax state holds one count")
    if not optimizer.masked and len(trainable) != len(list(model.parameters())):
        raise ValueError("an optimizer built without a trainable mask trains every parameter")

    def moment(key):
        def value(p):
            if id(p) not in trainable:
                return None
            return state[p][key] if key in state.get(p, {}) else torch.zeros_like(p)
        return _params_to_flax(model, value)

    count = lambda n: np.asarray(n, np.int32)  # noqa: E731  (optax's counts are int32)
    adamw = {
        "0": {"count": count(steps.pop() if steps else 0), "mu": moment("exp_avg"),
              "nu": moment("exp_avg_sq")},
        "1": {"inner_state": {}} if optimizer.decay_masked else {},
        "2": {"count": count(optimizer.count)},
    }
    chain = {"0": {}, "1": adamw} if optimizer.grad_clip else {"0": adamw}
    if not optimizer.masked:
        return chain
    return {"inner_states": {"False": {"inner_state": {}}, "True": {"inner_state": chain}}}


def _find_adam(tree) -> tuple[dict, object]:
    """The one ``ScaleByAdamState`` (a map holding ``count``, ``mu`` and
    ``nu``) in an optax state tree, wherever a mask or a clip put it, and
    the schedule's count beside it (None without one)."""
    found = []

    def walk(node):
        if not isinstance(node, dict):
            return
        first = node.get("0")
        if isinstance(first, dict) and {"count", "mu", "nu"} <= set(first):
            sched = node.get("2")
            found.append((first, sched.get("count") if isinstance(sched, dict) else None))
            return
        for v in node.values():
            walk(v)

    walk(tree)
    if len(found) != 1:
        raise ValueError(f"expected one AdamW state (count, mu, nu) in the opt_state, found {len(found)}")
    return found[0]


def load_optax_state(model: torch.nn.Module, optimizer, opt_state) -> None:
    """Restore ``optimizer`` (a ``MaskedAdamW`` over ``model``) from a JAX
    trainer's optax AdamW state: ``mu``/``nu`` become each trainable
    parameter's ``exp_avg``/``exp_avg_sq`` through the bridge's renaming and
    transposes, the Adam ``count`` each one's ``step``, the schedule's count
    ``optimizer.count``. A ``{}`` moment (``MaskedNode``) must belong to a
    frozen parameter and every trainable one must have both moments; any
    other tree raises."""
    adam, sched_count = _find_adam(opt_state)
    keys = model.state_dict().keys()
    own = dict(model.named_parameters())
    name_of = {id(p): n for n, p in own.items()}
    trainable = {name_of[id(p)] for p in optimizer.params}
    moments = {}
    for key, src in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        named = flax_to_state_dict({"params": adam[src]}, keys)
        extra, missing = sorted(set(named) - trainable), sorted(trainable - set(named))
        if extra or missing:
            raise KeyError(f"optax {src} does not match the trainable parameters: moments for "
                           f"frozen or unknown {extra}, none (MaskedNode) for trainable {missing}")
        for n, v in named.items():
            if tuple(v.shape) != tuple(own[n].shape):
                raise ValueError(f"optax {src} of {n}: {tuple(v.shape)}, parameter {tuple(own[n].shape)}")
        moments[key] = named
    count = int(np.asarray(adam["count"]))
    inner = optimizer.optimizer
    sd = inner.state_dict()
    state = {}
    for group, saved in zip(inner.param_groups, sd["param_groups"]):
        for p, idx in zip(group["params"], saved["params"]):
            n = name_of[id(p)]
            state[idx] = {"step": torch.tensor(float(count)),
                          "exp_avg": moments["exp_avg"][n], "exp_avg_sq": moments["exp_avg_sq"][n]}
    inner.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
    optimizer.count = int(np.asarray(sched_count)) if sched_count is not None else count
