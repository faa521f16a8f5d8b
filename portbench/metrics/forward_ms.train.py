"""forward_ms.train: the mean time of a training step's forward pass, from CUDA
events at the model's entry and exit and at the optimizer's step (the
configuration's marks)."""

import numpy as np


def read(t):
    ms = t.spans.get("forward") if t.kind == "train" else None
    return float(np.mean(ms)) if ms else None
