"""mfu.serve: the products of every forward answered in the window (the
reference's ``forward_flops`` a cloud) over the window's time at 989
TFLOP/s, in percent."""

from portbench import work


def read(t):
    count = getattr(t.ref, "forward_flops", None)
    if t.kind != "batch" or t.window_s <= 0 or count is None:
        return None
    return 100.0 * count(t.cfg) * t.clouds / (t.window_s * work.PEAK_BF16)
