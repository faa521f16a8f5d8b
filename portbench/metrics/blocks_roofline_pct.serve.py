"""blocks_roofline_pct.serve: the least time of the ``blocks`` stage (its
products at 989 TFLOP/s or its bytes at 3.35 TB/s, whichever is longer,
from the configuration's shapes: the reference's ``blocks_work``) over its
measured mean time, in percent."""

import numpy as np

from portbench import work


def read(t):
    ms = t.spans.get("blocks") if t.kind == "batch" else None
    count = getattr(t.ref, "blocks_work", None)
    if not ms or count is None:
        return None
    flops, acts, weights = count(t.cfg)
    least = work.bound_s(t.batch * flops, t.batch * acts + weights)
    return 100.0 * least * 1e3 / float(np.mean(ms))
