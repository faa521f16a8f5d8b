"""train_clouds_per_s: clouds in the optimizer steps completed over the whole
window, AdamW and clipping included, the device drained at its end (host
clock)."""


def read(t):
    return t.clouds / t.window_s if t.kind == "train" and t.window_s > 0 else None
