"""device_idle_pct.train: the share of the traced stretch in which no kernel,
copy or fill ran on the card (``torch.profiler``, CUDA activity), in
percent."""


def read(t):
    if t.kind != "train" or not t.device or t.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t.device["busy_s"] / t.device["window_s"])
