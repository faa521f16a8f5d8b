"""Host → device batch feeding with pinned memory.

Counterpart of ``pointvit_tpu/data/loader.py::Prefetcher``
(``loader.py:127-189``). The batchers themselves (``Loader``,
``FastLoader``) are the JAX package's numpy classes, used as they are; this
module adds the device end: each numpy array of a batch is copied into
page-locked host memory and sent to the card with a ``non_blocking`` copy,
on a background thread that keeps up to ``depth`` batches ready, so host
batch preparation overlaps the card's step. The copies are ordered on the
default stream, behind the step it runs.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

__all__ = ["Prefetcher", "to_device", "transfer"]


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: pinned and copied without
    blocking when the device is a card, a plain copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def transfer(batch, device: torch.device, prepare=None) -> tuple:
    """``prepare(*batch)`` (if given) on the host, then every numpy array of
    the batch to ``device``; other items pass through."""
    if prepare is not None:
        batch = prepare(*batch)
    return tuple(to_device(a, device) if isinstance(a, np.ndarray) else a for a in batch)


class Prefetcher:
    """Iterate ``transfer(batch, device, prepare)`` over the batches of
    ``iterable``, with up to ``depth`` of them prepared ahead on a background
    thread; an exception there re-raises in the consuming loop, and a loop
    that stops early stops the thread."""

    def __init__(self, iterable, device, prepare=None, depth: int = 2) -> None:
        self._iterable = iterable
        self._device = torch.device(device)
        self._prepare = prepare
        self._depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._iterable:
                    if not put(transfer(batch, self._device, self._prepare)):
                        return
                put(end)
            except BaseException as e:  # re-raised in the consumer
                put(e)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
