"""The numbers that decide ``correct``: what the timed path produced against
the plain reference.

Serving (every answer of the window against the reference's logits of its
cloud), both over the spread of the reference's answers between clouds
(the RMS of each answer's distance from their mean):

- ``logit_rel_spread``: the RMS of ‖served − reference‖ over all answers;
- ``logit_worst_rel_spread``: the largest ‖served − reference‖ of one
  answer (an answer altered alone shows here).

With seeded weights most of every answer is one vector common to all
clouds, and its length moves threefold with the weights' seed while the
bf16 error does not; over the spread between clouds, the part of an answer
that tells clouds apart, the sound program reads alike from seed to seed.

Training (the first steps, which the reference follows from the same
weights, batches and draws, through the window's own call):

- ``logits_first_rel_l2``: ‖logits − reference logits‖ / ‖reference
  logits‖ of the first step's train-mode forward (its batch statistics,
  dropout masks and FPS starts); a program that returns fewer rows than
  the batch reads infinity;
- ``change_worst``: by tensor, the gap between the program's norm of its
  change after the last step and the reference's, over the larger of the
  reference's norm of that tensor and of the median tensor; the worst
  tensor. An entry whose reference gradient is under a thousandth of the
  median tensor's RMS entry moves under AdamW by rounding alone (the key's
  part of a packed qkv bias under softmax; a bias before a train-mode
  BatchNorm): the change is taken over the other entries, by this rule on
  the reference's first gradient alone;
- ``adam_state_median``: the same gap of norms, over the same entries, of
  AdamW's first and second moments after the last step; for each moment
  the median tensor's gap (the upper one of an even count), and the
  larger of the two. Not the worst
  tensor: the second moment squares a gradient's gap, and in small
  tensors (LayerNorm scales, biases) bf16 moves it by 0.15–0.35 on every
  seed, as much as one precision lower does;
- ``bn_stats_worst``: by BatchNorm running statistic, ‖program's change −
  reference's change‖ after the last step over the larger of the
  reference's change and the median statistic's; the worst statistic (a
  wrong momentum or a statistic left unmoved shows here, which the
  train-mode forwards, on batch statistics, cannot show).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["compare_serving", "compare_training", "judge", "NEGLIGIBLE_GRAD"]

NEGLIGIBLE_GRAD = 1e-3


def compare_serving(got: np.ndarray, want: np.ndarray) -> dict:
    if len(got) == 0 or got.shape != want.shape:
        return {"logit_rel_spread": math.inf, "logit_worst_rel_spread": math.inf}
    want = want.astype(np.float64)
    diff = np.linalg.norm(got - want, axis=-1)
    spread = max(float(np.sqrt(((want - want.mean(0)) ** 2).sum(-1).mean())), 1e-300)
    return {"logit_rel_spread": float(np.sqrt((diff ** 2).mean())) / spread,
            "logit_worst_rel_spread": float(diff.max()) / spread}


def _gaps(got: dict, want: dict) -> dict:
    """name → |got − want| / max(want, the median want)."""
    median = float(np.median(list(want.values()))) if want else 0.0
    return {n: abs(got.get(n, math.inf) - w) / max(w, median, 1e-300) for n, w in want.items()}


def _kept(want: dict) -> dict:
    """name → the entries of the tensor that the change is taken over."""
    rms = float(np.median([float(g.norm()) / max(g.numel(), 1) ** 0.5
                           for g in want["first_grad"].values()]))
    return {n: g.abs() >= NEGLIGIBLE_GRAD * rms for n, g in want["first_grad"].items()}


def _norm_gap(got: dict, want: dict, keep: dict) -> dict:
    """The gaps of the norms of ``got``'s and ``want``'s tensors over the
    entries ``keep`` gives."""
    norms_w, norms_g = {}, {}
    for n, k in keep.items():
        if n in want and k.any():
            norms_w[n] = float(want[n][k].norm())
            if n in got:
                norms_g[n] = float(got[n].to(k.device)[k].norm())
    return _gaps(norms_g, norms_w)


def _difference(got: dict, want: dict) -> dict:
    """By tensor, ‖got − want‖ over the larger of ‖want‖ and the median."""
    norms = {n: float(w.norm()) for n, w in want.items()}
    median = float(np.median(list(norms.values()))) if norms else 0.0
    return {n: (float((got[n].to(w.device) - w).norm()) if n in got else math.inf)
            / max(norms[n], median, 1e-300) for n, w in want.items()}


def compare_training(got: dict, want: dict) -> dict:
    """The numbers of the module docstring; ``got`` and ``want`` hold
    ``logits``, ``change``, ``stats`` and ``moments`` (name → (first,
    second)), and ``want`` the reference's ``first_grad``."""
    keep = _kept(want)
    lg, lw = got.get("logits"), want["logits"]
    logits = math.inf
    if lg is not None and lg.shape == lw.shape:
        logits = float((lg.float().to(lw.device) - lw).norm() / lw.norm().clamp_min(1e-30))
    moments = [_norm_gap({n: m[i] for n, m in got["moments"].items()},
                         {n: m[i] for n, m in want["moments"].items()}, keep) for i in (0, 1)]
    worst = lambda d: max(d.values(), default=math.inf)  # noqa: E731
    # the upper median, so that a state left unchanged reads 1 at any count
    median = lambda d: sorted(d.values())[len(d) // 2] if d else math.inf  # noqa: E731
    return {"logits_first_rel_l2": logits,
            "change_worst": worst(_norm_gap(got["change"], want["change"], keep)),
            "adam_state_median": max(median(m) for m in moments),
            "bn_stats_worst": worst(_difference(got["stats"], want["stats"]))}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, name → {value, limit}); a number without a limit, or one
    that is not finite, is not correct."""
    checks = {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}
    ok = bool(numbers) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
