"""request_host_ms.serve: the serving session's time a request on the
critical path outside the forward: the window over the requests answered,
less the mean forward on the card (CUDA events at the model's entry and
exit). Padding, copies and the host's gaps between forwards; the wait for
the other client's forward is not in it."""


def read(t):
    return t.request_host_ms[0] if t.kind == "batch" and t.request_host_ms else None
