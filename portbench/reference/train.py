"""Plain reference of a fine-tuning step, in f32: cross-entropy on the
logits, the gradient by autograd, clipping to a global norm, and AdamW with
decoupled weight decay (off for biases, the cls token and position and
every tensor with ``norm`` in its name) at the learning rate of a linear
warm-up then cosine schedule, constant within an epoch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["schedule", "decays", "train_steps"]


def schedule(train_cfg: dict, steps_per_epoch: int):
    """step → lr: (epoch + 1) / warmup of the base rate over the warm-up
    epochs, then a cosine from the base rate to ``min_lr`` over ``t_max``."""
    base, warm = train_cfg["learning_rate"], train_cfg.get("warmup_epochs", 10)
    t_max, low = train_cfg["t_max"], train_cfg.get("min_lr", 1e-6)

    def lr(step: int) -> float:
        epoch = float(step // steps_per_epoch)
        if epoch < warm:
            return base * (epoch + 1.0) / max(warm, 1)
        t = min(max(epoch - warm, 0.0), float(t_max))
        return low + 0.5 * (base - low) * (1 + math.cos(math.pi * t / t_max))

    return lr


def decays(name: str) -> bool:
    leaf = name.split(".")[-1]
    return not (leaf == "bias" or "cls_token" in name or "cls_pos" in name or "norm" in name)


def train_steps(forward, w0: dict, batches, train_cfg: dict, steps_per_epoch: int,
                seed: int, device, steps: int = 3, label_smoothing: float = 0.0) -> dict:
    """``steps`` updates from the weights ``w0`` on ``batches`` ((points,
    labels) pairs), with the step's draws from a generator on ``device``
    seeded with ``seed``. ``forward(w, points, train=True, generator=,
    stats=)`` gives the logits. Returns each step's loss, the first step's
    logits, each trainable tensor's first (clipped) gradient, its change
    after the last step and AdamW's two moments then, and each BatchNorm
    running statistic's change."""
    trainable = {n for n, t in w0.items() if t.is_floating_point() and "running_" not in n}
    w = {n: (t.detach().clone().requires_grad_(True) if n in trainable else t)
         for n, t in w0.items()}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lr_at = schedule(train_cfg, steps_per_epoch)
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, train_cfg["weight_decay"]
    clip = train_cfg.get("grad_norm_clip")
    m = {n: torch.zeros_like(w[n]) for n in trainable}
    v = {n: torch.zeros_like(w[n]) for n in trainable}
    losses, first = [], {}
    for t in range(1, steps + 1):
        points, labels = batches[t - 1]
        stats: dict = {}
        logits = forward(w, points, train=True, generator=gen, stats=stats).float()
        loss = F.cross_entropy(logits, labels.long(), label_smoothing=label_smoothing)
        grads = torch.autograd.grad(loss, [w[n] for n in sorted(trainable)])
        g = dict(zip(sorted(trainable), grads))
        norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
        if clip:
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            g = {n: x * scale for n, x in g.items()}
        if t == 1:
            first = {n: x.detach().clone() for n, x in g.items()}
            first_logits = logits.detach().clone()
        lr = lr_at(t - 1)
        with torch.no_grad():
            for n in sorted(trainable):
                p = w[n]
                if decays(n):
                    p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
            for n, r in stats.items():
                w[n] = r
        losses.append(float(loss.detach()))
    change = {n: w[n].detach() - w0[n] for n in trainable}
    stats = {n: w[n] - w0[n] for n in w0 if "running_" in n}
    return {"losses": losses, "first_grad": first, "change": change, "logits": first_logits,
            "stats": stats, "moments": {n: (m[n], v[n]) for n in trainable}}
