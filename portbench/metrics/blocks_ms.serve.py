"""blocks_ms.serve: the mean time of the model's ``blocks`` stage per request, from
CUDA events recorded at the stage's boundaries (the configuration's marks)."""

import numpy as np


def read(t):
    ms = t.spans.get("blocks") if t.kind == "batch" else None
    return float(np.mean(ms)) if ms else None
