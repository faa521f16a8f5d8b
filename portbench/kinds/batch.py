"""``batch``: a closed loop of ``clients`` threads sharing one serving
session (``pointvit_tpu_torch.serve.InferenceSession`` over the model);
each sends requests of ``batch`` clouds, drawn in a seeded order from a
pool of ``pool`` clouds, back to back. ``warm_s`` seconds of the same loop
warm every shape before the window.

The check: every answer of the window against the reference's logits of
its cloud (:func:`portbench.check.compare_serving`), each cloud run once
through the reference after the window, in blocks of ``REFERENCE_ROWS``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, drive, faults, generator
from portbench.harness import program_model, reference_of
from portbench.reference.layers import FP8

__all__ = ["run", "reading", "serving_program", "batch_loop", "VARIANTS"]

REFERENCE_ROWS = 64  # clouds a reference forward takes at once, so that it fits
VARIANTS = ("sound", "control", "int8") + faults.FAULTS


def batch_loop(session, blocks: list, order: list, clients: int, seconds: float,
               stretch=None) -> tuple[list, float]:
    """Records (block, t_sent, t_done, logits, error) of every request."""
    def body(c, deadline, out):
        i = c
        while time.perf_counter() < deadline:
            b = order[i % len(order)]
            t = time.perf_counter()
            try:
                logits, err = session.predict_logits(blocks[b]), None
            except Exception as e:  # a failed request counts as failed
                logits, err = None, repr(e)
            out.append((b, t, time.perf_counter(), logits, err))
            i += clients

    return drive.run_clients(clients, body, seconds, stretch)


def run(ctx) -> dict:
    from pointvit_tpu_torch.serve import InferenceSession

    traffic = ctx.traffic
    ctx.build_kernels()
    stretch = ctx.stretch()
    rng = np.random.default_rng(ctx.seeds[2])
    model = ctx.make_model(ctx.family, ctx.model_cfg, ctx.weights(), ctx.device)
    session = InferenceSession(model, device=ctx.device)
    state = {"model": model, "session": session}
    clouds, _ = generator.shape_clouds(traffic["pool"], ctx.config["points"], ctx.seeds[1],
                                       ctx.device)
    pool = clouds.cpu().numpy()
    del clouds
    b = traffic["batch"]
    blocks = [pool[i:i + b] for i in range(0, len(pool) - b + 1, b)]
    order = rng.permutation(len(blocks)).tolist()
    for blk in blocks[:2] * 2:
        session.predict_logits(blk)
    batch_loop(session, blocks, order, traffic["clients"], traffic.get("warm_s", 0))
    marks = ctx.marks(state)
    setup_s = ctx.start_window()
    records, window = batch_loop(session, blocks, order, traffic["clients"], ctx.seconds, stretch)
    ctx.sync()
    peak = ctx.peak()
    good = [r for r in records if r[4] is None]
    t = ctx.trace_of(window_s=window, setup_s=setup_s, batch=b,
                     latencies_ms=[(r[2] - r[1]) * 1e3 for r in good],
                     clouds=sum(len(r[3]) for r in good))
    if marks is not None:
        t.spans = marks.times()
        marks.remove()
        fwd = [sum(v) for v in zip(*t.spans.values())]
        if fwd and good:  # the critical path's time a request outside the forward
            t.request_host_ms = [window * 1e3 / len(good) - float(np.mean(fwd))]
    t.device = ctx.device_summary()
    answers = [(r[0], r[3]) for r in good]
    errors = [r[4] for r in records if r[4] is not None][:3]
    ctx.free(state)
    del model, session
    # The reference over every cloud answered in the window, each once.
    w_ref = ctx.weights()
    need = sorted({a for a, _ in answers})
    rows = np.concatenate([blocks[k] for k in need]) if need else pool[:0]
    out = [ctx.ref.forward(w_ref, torch.from_numpy(rows[i:i + REFERENCE_ROWS]).to(ctx.device),
                           ctx.cfg).float().cpu().numpy()
           for i in range(0, len(rows), REFERENCE_ROWS)]
    out = np.concatenate(out) if out else np.zeros((0, 1), np.float32)
    del w_ref
    at = {k: j * b for j, k in enumerate(need)}
    got = np.concatenate([np.asarray(l, np.float32).reshape(b, -1) for _, l in answers]) \
        if answers else np.zeros((0, 1))
    want = np.concatenate([out[at[k]:at[k] + b] for k, _ in answers]) \
        if answers else np.zeros((0, 1))
    return dict(attempted=len(records), failed=len(records) - len(good), errors=errors, trace=t,
                peak=peak, numbers=check.compare_serving(got, want))


def serving_program(config: dict, variant: str):
    """The model a calibration run serves: the program (``sound``), its own
    int8 path (``int8``), the control (the plain reference with its products
    in fp8, put in the program's place), or the program with a fault
    planted (:mod:`portbench.faults`)."""
    def build(family, model_cfg, weights, device):
        if variant == "int8":
            return program_model(family, {**model_cfg, "quantized": True}, weights, device)
        if variant == "control":
            ref = reference_of(config.get("reference", family))
            cfg = {**model_cfg, "points": config["points"]}
            return faults.Stand_in(lambda x: ref.forward(weights, x, cfg, FP8))
        model = program_model(family, model_cfg, weights, device)
        return model if variant == "sound" else faults.planted(model, variant)

    return build


def reading(ctx, variant: str) -> dict:
    ctx.make_model = serving_program(ctx.config, variant)
    return run(ctx)["numbers"]
