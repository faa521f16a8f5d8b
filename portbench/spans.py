"""Spans the benchmark records around the program's own layers, and the
device trace of a traced stretch.

:class:`Marks` puts a mark at each place a list names: ``[path, "pre"]``
or ``[path, "post"]``, where ``path`` is a dotted path from one of the
run's roots (``model``, ``session``, ``trainer``). A module gets a forward
hook; any other callable (a method) is wrapped on its instance. A mark
records a CUDA event on the card (the host clock on the CPU, where the
tests run); the first mark of the list opens a new record, and every record
that reached the last mark gives the times between consecutive marks,
named by ``spans``.

:func:`device_stretch` traces a stretch with ``torch.profiler`` (CUDA
activity) and reduces it to the device's busy time, the kernels that took
most time, and the idle gaps by what the host was doing in them (the CUDA
runtime call it was in, else Python).
"""

from __future__ import annotations

import threading
import time

import torch

__all__ = ["Marks", "resolve", "device_stretch", "warm_profiler"]


def resolve(roots: dict, path: str):
    """(owner, attribute name, object) of a dotted ``path``; a digit steps
    into a module list by its index."""
    head, *rest = path.split(".")
    owner, name, obj = None, head, roots[head]
    for part in rest:
        owner, name, obj = obj, part, getattr(obj, part)
    return owner, name, obj


class _HostEvent:
    def __init__(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other: "_HostEvent") -> float:
        return (other.t - self.t) * 1e3


class Marks:
    def __init__(self, roots: dict, marks, spans, cuda: bool) -> None:
        self.spans = list(spans)
        self.records: list[list] = []
        self._cuda = cuda
        self._lock = threading.Lock()
        self._undo = []
        self._n = len(marks)
        for i, (path, when) in enumerate(marks):
            self._install(roots, path, when, i)

    def _event(self):
        if not self._cuda:
            return _HostEvent()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _mark(self, i: int) -> None:
        ev = self._event()
        with self._lock:
            if i == 0:
                self.records.append([ev])
            elif self.records and len(self.records[-1]) == i:
                self.records[-1].append(ev)

    def _install(self, roots, path: str, when: str, i: int) -> None:
        owner, name, obj = resolve(roots, path)
        if isinstance(obj, torch.nn.Module):
            hook = (obj.register_forward_pre_hook if when == "pre" else obj.register_forward_hook)
            handle = hook(lambda *_: self._mark(i))
            self._undo.append(handle.remove)
            return
        inner = obj

        def wrapped(*args, **kwargs):
            if when == "pre":
                self._mark(i)
            out = inner(*args, **kwargs)
            if when == "post":
                self._mark(i)
            return out

        own = name in vars(owner)
        setattr(owner, name, wrapped)
        self._undo.append(lambda: setattr(owner, name, inner) if own else delattr(owner, name))

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def times(self) -> dict[str, list[float]]:
        """span name → ms of each complete record (after a synchronise)."""
        if self._cuda:
            torch.cuda.synchronize()
        out = {n: [] for n in self.spans}
        for rec in self.records:
            if len(rec) == self._n:
                for j, name in enumerate(self.spans):
                    out[name].append(rec[j].elapsed_time(rec[j + 1]))
        return out


def warm_profiler() -> None:
    """Start and stop the profiler once, so that a traced stretch in the
    window does not pay its first start (seconds on the card)."""
    with device_stretch():
        torch.cuda.synchronize()


class device_stretch:
    """``with device_stretch() as s: ...`` traces the device; afterwards
    ``s.summary()`` gives busy_s, window_s, device_ops and idle_gaps."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self.t0
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)

    def summary(self, top: int = 10) -> dict:
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self._prof.events():
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                device.append((span, e.name))
            elif e.name.startswith("cuda"):
                host.append((span, e.name))
        by_op: dict[str, float] = {}
        for (a, b), name in device:
            by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
        device.sort()
        busy, gaps, end = 0.0, [], None
        for (a, b), _ in device:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        host.sort()
        by_gap: dict[str, float] = {}
        j = 0
        for a, b in gaps:
            while j < len(host) and host[j][0][1] < a:
                j += 1
            best, where = 0.0, "python (no CUDA call)"
            for (ha, hb), name in host[j:]:
                if ha > b:
                    break
                overlap = min(hb, b) - max(ha, a)
                if overlap > best:
                    best, where = overlap, name
            by_gap[where] = by_gap.get(where, 0.0) + (b - a) / 1e6
        rank = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"busy_s": busy / 1e6, "window_s": self.window_s, "kernels": len(device),
                "device_ops": rank(by_op), "idle_gaps": rank(by_gap)}
