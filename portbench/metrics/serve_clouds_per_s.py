"""serve_clouds_per_s: clouds answered over the whole window, from its start
to the last answer, host copies included (host clock)."""


def read(t):
    return t.clouds / t.window_s if t.kind == "batch" and t.window_s > 0 else None
