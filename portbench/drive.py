"""What every loop that offers a cell's load shares (the loops themselves
are in ``kinds/<kind>.py``).

A loop runs until ``seconds`` have passed on the host's clock, lets the
work it started finish, and returns its records and the window's length
from its start to the end of the last piece of work. ``stretch`` (a
context manager factory or None) is entered once, for the middle of the
window, by the thread that owns the loop.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Stretch", "run_clients", "STRETCH"]

STRETCH = (0.3, 0.7, 3.0)  # start and end as shares of the window, at most seconds


class Stretch:
    """Enters ``factory()`` at ``STRETCH[0]`` of the window and leaves it
    after ``STRETCH[1] − STRETCH[0]`` of the window (at most ``STRETCH[2]``
    seconds) from when it was entered, from the thread that calls
    :meth:`poll`."""

    def __init__(self, factory, t0: float, seconds: float) -> None:
        a, b, most = STRETCH
        self.factory, self.ctx = factory, None
        self.start, self.length = t0 + a * seconds, min((b - a) * seconds, most)
        self.done = factory is None

    def poll(self, now: float) -> None:
        if self.done:
            return
        if self.ctx is None and now >= self.start:
            self.ctx = self.factory()
            self.ctx.__enter__()
            self.end = time.perf_counter() + self.length
        elif self.ctx is not None and now >= self.end:
            self.close()

    def close(self) -> None:
        if self.ctx is not None and not self.done:
            self.ctx.__exit__(None, None, None)
        self.done = True


def run_clients(clients: int, body, seconds: float, stretch) -> tuple[list, float]:
    """Start ``clients`` threads running ``body(c, deadline, out)``, time the
    window, and trace the stretch from this thread."""
    records = [[] for _ in range(clients)]
    go = threading.Barrier(clients + 1)
    box: dict = {}

    def run(c):
        go.wait()
        body(c, box["deadline"], records[c])

    threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    box["deadline"] = t0 + seconds
    st = Stretch(stretch, t0, seconds)
    go.wait()
    while any(t.is_alive() for t in threads):
        st.poll(time.perf_counter())
        time.sleep(0.005)
    st.close()
    for t in threads:
        t.join()
    end = max((r[-1][2] for r in records if r), default=time.perf_counter())
    return [x for r in records for x in r], end - t0
