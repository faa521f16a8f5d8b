"""Serving: a model behind a ladder of batch buckets, restored from a
checkpoint or an exported artifact, and a micro-batcher that coalesces
single-cloud requests.

Counterpart of ``pointvit_tpu/serve.py``. A request of n clouds is padded up
to the smallest bucket that holds it by repeating its last cloud, a request
larger than the top bucket runs in top-bucket chunks, and the logits are
sliced back to n. Serving a few fixed batch shapes keeps the kernels' launch
shapes, and the memory they take, to a known set.

- :meth:`InferenceSession.from_checkpoint` restores a JAX trainer's msgpack
  checkpoint or one of the port's trainers' ``.pt`` files and rebuilds the
  model from the ``model_config`` of the sidecar JSON through
  :func:`~pointvit_tpu_torch.models.factory.build_model`: one file path is
  the whole serving contract. It serves the EMA weights by default.
- :meth:`InferenceSession.from_exported` serves a ``torch.export`` artifact
  (:mod:`pointvit_tpu_torch.export`) with no model code.
- :class:`MicroBatcher` lets concurrent callers submit one cloud each; a
  thread drains the queue into one padded :meth:`~InferenceSession.predict_logits`
  call per tick.

A session runs one forward at a time (a lock): the micro-batcher's thread
and a caller of :meth:`~InferenceSession.predict_logits` (the HTTP batch
endpoint) may share it, and the blocks' kept launch weights and a quantized
layer's int8 weights are caches that one forward fills.

With ``mesh`` (a ``DeviceMesh`` with a ``data`` dimension,
:func:`~pointvit_tpu_torch.parallel.make_mesh`) a session is data-parallel
as the JAX one is (``serve.py:85-97``): the buckets round up to multiples of
the rank count, every rank runs its contiguous rows of each padded batch
with the model's kernels, and the logits are gathered. Every rank calls the
session with the same clouds, as the processes of a ``torchrun`` program do.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

__all__ = ["InferenceSession", "MicroBatcher"]

_DEFAULT_BUCKETS = (8, 32, 128, 256)


def _restore(model: torch.nn.Module, raw: dict, use_ema: bool) -> None:
    """Fill ``model`` from a restored checkpoint: a JAX tree (``params``,
    ``batch_stats`` and ``ema_params``/``ema_batch_stats``,
    ``pointvit_tpu/serve.py:124-141``) or a port trainer's payload
    (``model``, and ``ema``: the trainable parameters' and BatchNorm
    statistics' averages, laid over it)."""
    if "model" in raw:
        state = dict(raw["model"])
        if use_ema and raw.get("ema"):
            state.update(raw["ema"])
        model.load_state_dict(state)
        return
    from pointvit_tpu_torch.convert import load_flax_variables

    ema = use_ema and "ema_params" in raw
    variables = {"params": raw["ema_params"] if ema else raw["params"]}
    stats = (raw.get("ema_batch_stats") if ema else None) or raw.get("batch_stats")
    if stats:
        variables["batch_stats"] = stats
    load_flax_variables(model, variables)


class InferenceSession:
    """A model in inference mode on ``device`` behind a bucket ladder.

    Args:
        model: an ``AdaptPointFormer``, ``Pix4Point`` or
            ``PointCloudRendererClassifier`` (any module mapping (B, N, C)
            float32 points to (B, classes) logits).
        buckets: batch sizes to serve; requests pad to the smallest that fits.
        device: where the model and the requests run: the card unless the
            caller asks for another device (the CPU tests pass ``"cpu"``).
        mesh: a ``DeviceMesh`` with a ``data`` dimension for data-parallel
            serving (every rank calls with the same clouds), or None.
    """

    def __init__(self, model: torch.nn.Module, buckets=_DEFAULT_BUCKETS, device="cuda", *,
                 mesh=None) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None and mesh is not None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model.eval().to(self.device)
        self._configure(self.model, buckets, getattr(model, "in_channels", 3), None, mesh)

    def _configure(self, run, buckets, channels: int, points: int | None, mesh=None) -> None:
        self.mesh = mesh
        self._group = None
        n = 1
        if mesh is not None:
            from pointvit_tpu_torch.parallel.comm import group_size

            self._group = mesh.get_group("data")
            n = group_size(self._group)
        if any(int(b) < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.buckets = tuple(sorted({-(-int(b) // n) * n for b in buckets}))
        if not self.buckets:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.in_channels = channels
        self.points = points  # fixed by an exported program; None: any
        self._run = run
        self._lock = threading.Lock()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        *,
        family: str | None = None,
        model: torch.nn.Module | None = None,
        model_config: dict | None = None,
        buckets=_DEFAULT_BUCKETS,
        use_ema: bool = True,
        device="cuda",
        implementation: str | None = None,
        mesh=None,
    ) -> "InferenceSession":
        """Restore a trainer checkpoint: a JAX ``*.msgpack`` or the port's
        ``*.pt``, each with its sidecar ``<path>.json``.

        The sidecar's ``model_config`` rebuilds the architecture (with
        ``implementation``, the port's switch: None for the kernels, 'torch'
        for the plain versions) unless ``model`` or ``model_config`` is
        given; without any of the three, :class:`FileNotFoundError`. A
        checkpoint of an EMA trainer serves its averaged weights and
        statistics unless ``use_ema=False``. ``mesh`` serves it
        data-parallel.
        """
        from pointvit_tpu_torch.train.checkpoint import load_checkpoint

        raw = load_checkpoint(path, map_location="cpu")
        if model is None:
            if model_config is None:
                if "meta" not in raw:
                    raise FileNotFoundError(f"{path}.json missing: pass model= or model_config= "
                                            "to rebuild the architecture")
                model_config = raw["meta"]["model_config"]
            from pointvit_tpu_torch.models.factory import build_model

            model = build_model(model_config, family=family, implementation=implementation)
        _restore(model, raw, use_ema)
        return cls(model, buckets, device, mesh=mesh)

    @classmethod
    def from_exported(cls, path: str, *, buckets=_DEFAULT_BUCKETS, mesh=None) -> "InferenceSession":
        """Serve a ``torch.export`` artifact (``python -m
        pointvit_tpu_torch.export``) behind the same bucket ladder and
        micro-batching: no model class and no checkpoint, the device is the
        one it was exported on. A program exported with a fixed batch takes
        only buckets of that size. ``mesh`` serves it data-parallel."""
        from pointvit_tpu_torch.export import load_exported

        fn = load_exported(path)
        static = fn.meta["batch"]
        if static is not None and any(int(b) != static for b in buckets):
            raise ValueError(f"{path} was exported for batch {static} only; buckets {tuple(buckets)}")
        self = cls.__new__(cls)
        self.model = None
        self.device = fn.device
        self._configure(fn, buckets, fn.meta["channels"], fn.meta["points"], mesh)
        return self

    # -- inference ----------------------------------------------------------

    def check_cloud_shape(self, shape) -> None:
        """Raise ``ValueError`` unless a cloud of ``shape`` (N, C) is one the
        model takes: C of its input channels (and N of an exported
        program's points)."""
        n, c = shape
        if c != self.in_channels:
            raise ValueError(f"the model takes clouds of {self.in_channels} channels, got {c}")
        if self.points is not None and n != self.points:
            raise ValueError(f"the exported program takes clouds of {self.points} points, got {n}")

    @torch.inference_mode()
    def _forward(self, batch: np.ndarray) -> np.ndarray:
        if self._group is not None:  # this rank's rows; the ranks' logits gathered
            from pointvit_tpu_torch.parallel.comm import all_gather, group_rank, group_size

            per = len(batch) // group_size(self._group)
            r = group_rank(self._group)
            x = torch.from_numpy(np.ascontiguousarray(batch[r * per:(r + 1) * per],
                                                      dtype=np.float32)).to(self.device)
            with self._lock:
                return all_gather(self._run(x).float(), self._group).cpu().numpy()
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).to(self.device)
        with self._lock:
            return self._run(x).float().cpu().numpy()

    def warmup(self, example: np.ndarray) -> None:
        """Run every bucket once; ``example`` is one (N, C) cloud. This also
        fills the model's per-device caches (a quantized model's int8
        weights), so the first request served does not build them."""
        for b in self.buckets:
            self._forward(np.broadcast_to(example, (b,) + tuple(example.shape)))

    def predict_logits(self, points: np.ndarray) -> np.ndarray:
        """(n, N, C) clouds → (n, classes) float32 logits, any n ≥ 1."""
        points = np.asarray(points, dtype=np.float32)
        n = points.shape[0]
        if n < 1:
            raise ValueError("a request needs at least one cloud")
        cap = self.buckets[-1]
        if n > cap:
            return np.concatenate(
                [self.predict_logits(points[i : i + cap]) for i in range(0, n, cap)], axis=0
            )
        bucket = next(b for b in self.buckets if b >= n)
        if n < bucket:
            pad = np.broadcast_to(points[-1:], (bucket - n,) + points.shape[1:])
            points = np.concatenate([points, pad], axis=0)
        return self._forward(points)[:n]

    def predict(self, points: np.ndarray) -> np.ndarray:
        """(n, N, C) clouds → (n,) class ids."""
        return np.argmax(self.predict_logits(points), axis=-1)


class MicroBatcher:
    """Coalesce concurrent single-cloud requests into padded batches.

    Callers block in :meth:`submit`; a daemon thread drains the queue every
    ``max_delay_ms`` (or as soon as ``max_batch`` requests are pending) into
    one :meth:`InferenceSession.predict_logits` call per cloud shape.
    Throughput grows with concurrency while each caller waits at most one
    tick more. An error in one shape's call goes to that group's callers
    only.
    """

    def __init__(self, session: InferenceSession, *, max_batch: int = 256,
                 max_delay_ms: float = 5.0) -> None:
        self.session = session
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, cloud: np.ndarray) -> np.ndarray:
        """One (N, C) cloud → its (classes,) logits. Blocks; thread-safe."""
        if self._closed.is_set():
            raise RuntimeError("MicroBatcher is closed")
        done = threading.Event()
        slot: list = [None, None]  # result, exception
        self._queue.put((np.asarray(cloud), done, slot))
        done.wait()
        if slot[1] is not None:
            raise slot[1]
        return slot[0]

    def close(self) -> None:
        self._closed.set()
        self._queue.put(None)  # wake the drain loop
        self._thread.join()
        # A submit that passed the closed check before close set it can still
        # enqueue after the drain loop exited: fail it rather than leave its
        # caller blocked.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                _, done, slot = item
                slot[1] = RuntimeError("MicroBatcher is closed")
                done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                if self._closed.is_set():
                    return
                continue
            pending = [item]
            deadline = time.monotonic() + self.max_delay
            while len(pending) < self.max_batch:
                try:
                    nxt = self._queue.get(timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is None:
                    if self._closed.is_set():
                        self._flush(pending)
                        return
                    continue
                pending.append(nxt)
            self._flush(pending)

    def _flush(self, pending) -> None:
        # One call per cloud shape: callers may send different point counts,
        # and one odd shape must not fail every caller of the tick.
        groups: dict[tuple, list] = {}
        for item in pending:
            groups.setdefault(tuple(np.shape(item[0])), []).append(item)
        for group in groups.values():
            try:
                logits = self.session.predict_logits(np.stack([c for c, _, _ in group]))
            except Exception as e:  # to this group's callers only
                for _, done, slot in group:
                    slot[1] = e
                    done.set()
                continue
            for i, (_, done, slot) in enumerate(group):
                slot[0] = logits[i]
                done.set()
