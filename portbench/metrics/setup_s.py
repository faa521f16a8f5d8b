"""setup_s: from process start to the first timed request or step (host clock)."""


def read(t):
    return t.setup_s
