"""``train``: one training step after another through the program's
``Trainer.train_step``, with the optimizer recipe that the traffic file
names (``optimizer``: ``"package.module:function"``, called as
``function(model, train_config, steps_per_epoch)`` → (schedule,
optimizer)), on batches of ``batch`` clouds: one augmented epoch over a
seeded train set of ``train_set`` clouds, staged on the device.

Set-up builds one trainer and drives it through the first
``CHECKED_STEPS`` steps with the window's own call; the window goes on
from there with the same trainer. The reference follows those first steps
from the same weights, batches and draws
(:func:`portbench.reference.train.train_steps`), and the check compares
the first step's logits, and after the last the parameters' change, the
BatchNorms' running statistics and AdamW's moments
(:func:`portbench.check.compare_training`).
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from portbench import check, drive, generator
from portbench.harness import program_function
from portbench.reference.layers import F32, FP8
from portbench.reference.train import train_steps

__all__ = ["run", "reading", "stage_batches", "train_loop", "CHECKED_STEPS", "VARIANTS"]

CHECKED_STEPS = 3  # training steps the reference follows
VARIANTS = ("sound", "control", "half_batch")


def stage_batches(config: dict, traffic: dict, seed: int, device, steps: int) -> list:
    """The first ``steps`` batches of an epoch over the seeded train set,
    augmented, on the device: (points, labels) pairs."""
    batch = traffic["batch"]
    clouds, labels = generator.shape_clouds(traffic["train_set"], config["points"], seed, device,
                                            classes=min(15, config["model"]["num_classes"]))
    gen = torch.Generator(device=device).manual_seed(seed ^ 1)
    perm = torch.randperm(traffic["train_set"], generator=gen, device=device)
    staged = []
    for s in range(steps):
        rows = perm[s * batch:(s + 1) * batch]
        staged.append((generator.augment(clouds[rows], gen), labels[rows].clone()))
    return staged


def train_loop(trainer, batches: list, first: int, seconds: float, stretch=None,
               sync=None) -> tuple[list, object, float]:
    """Steps from ``batches[first]`` on, cycling. Returns the batch index of
    every step, the sum of their losses (a device scalar) and the window."""
    done, total = [], None
    sync = sync or (lambda: None)
    t0 = time.perf_counter()
    st = drive.Stretch(stretch, t0, seconds)
    i = first
    while time.perf_counter() < t0 + seconds:
        st.poll(time.perf_counter())
        loss, _, _ = trainer.train_step(*batches[i % len(batches)])
        total = loss.detach() if total is None else total + loss.detach()
        done.append(i)
        i += 1
    sync()
    st.close()
    end = time.perf_counter()
    return done, total, end - t0


def _steps_per_epoch(traffic: dict) -> int:
    return traffic["train_set"] // traffic["batch"]


def _reference(ctx, staged: list, num=F32) -> dict:
    """The reference's first steps from the seeded weights on ``staged``."""
    traffic = ctx.traffic
    return train_steps(lambda w, p, **kw: ctx.ref.forward(w, p, ctx.cfg, num, **kw),
                       ctx.weights(), staged, traffic["train_config"], _steps_per_epoch(traffic),
                       ctx.seeds[3], ctx.device, CHECKED_STEPS,
                       traffic.get("label_smoothing", 0.0))


def run(ctx) -> dict:
    from pointvit_tpu_torch.train.trainer import Trainer

    traffic = ctx.traffic
    ctx.build_kernels()
    stretch = ctx.stretch()
    batch, tcfg = traffic["batch"], traffic["train_config"]
    steps_per_epoch = _steps_per_epoch(traffic)
    staged = stage_batches(ctx.config, traffic, ctx.seeds[1], ctx.device, steps_per_epoch)
    model = ctx.make_model(ctx.family, ctx.model_cfg, ctx.weights(), ctx.device)
    schedule, optimizer = program_function(traffic["optimizer"])(model, tcfg, steps_per_epoch)
    out_dir = os.path.join(tempfile.gettempdir(), "portbench_trainer")
    trainer = Trainer(model, train_dataset=None, test_dataset=None, optimizer=optimizer,
                      schedule=schedule, batch_size=batch, epochs=1,
                      label_smoothing=traffic.get("label_smoothing", 0.0), output_dir=out_dir,
                      seed=ctx.seeds[3], device=ctx.device, train_loader=[], test_loader=[],
                      save_config_snapshot=False, prefetch=0)
    state = {"model": model, "trainer": trainer}
    # The first steps, through the window's own call, are what the
    # reference follows; they also warm every shape of the step.
    params = dict(model.named_parameters())
    stats = {n: b for n, b in model.named_buffers() if "running_" in n}
    init = {n: t.detach().clone() for n, t in {**params, **stats}.items()}
    seen: list = []
    hook = model.register_forward_hook(lambda _m, _a, out: seen.append(out.detach().clone()))
    for s in range(CHECKED_STEPS):
        trainer.train_step(*staged[s])
        hook.remove()
    adam = trainer.optimizer.optimizer
    got = {"logits": seen[0],
           "change": {n: p.detach() - init[n] for n, p in params.items()},
           "stats": {n: b.detach() - init[n] for n, b in stats.items()},
           "moments": {n: (adam.state[p]["exp_avg"].detach().clone(),
                           adam.state[p]["exp_avg_sq"].detach().clone())
                       for n, p in params.items() if p in adam.state}}
    del init, params, stats, seen
    marks = ctx.marks(state)
    setup_s = ctx.start_window()
    done, total, window = train_loop(trainer, staged, CHECKED_STEPS, ctx.seconds, stretch,
                                     ctx.sync)
    peak = ctx.peak()
    t = ctx.trace_of(window_s=window, setup_s=setup_s, batch=batch, steps=len(done),
                     clouds=len(done) * batch)
    if marks is not None:
        t.spans = marks.times()
        marks.remove()
    t.device = ctx.device_summary()
    finite = bool(torch.isfinite(total).item()) if total is not None else True
    ctx.free(state)
    del model, trainer, optimizer, adam
    numbers = check.compare_training(got, _reference(ctx, staged[:CHECKED_STEPS]))
    return dict(attempted=len(done), failed=0 if finite else len(done), errors=[], trace=t,
                peak=peak, numbers=numbers)


def reading(ctx, variant: str) -> dict:
    """The sound program's numbers, or those of the reference put in its
    place: in fp8 (``control``), or with half of each batch left out."""
    if variant == "sound":
        return run(ctx)["numbers"]
    staged = stage_batches(ctx.config, ctx.traffic, ctx.seeds[1], ctx.device, CHECKED_STEPS)
    want = _reference(ctx, staged)
    if variant == "control":
        got = _reference(ctx, staged, FP8)
    elif variant == "half_batch":
        got = _reference(ctx, [(p[:len(p) // 2], lbl[:len(lbl) // 2]) for p, lbl in staged])
    else:
        raise ValueError(f"no training variant {variant!r}")
    return check.compare_training(got, want)
