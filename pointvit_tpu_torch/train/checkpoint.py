"""Trainer checkpoints with ``torch.save``, under the JAX trainer's names.

Counterpart of ``pointvit_tpu/train/checkpoint.py``. A checkpoint holds
what the JAX one holds (``checkpoint.py:105-116``): the epoch, the model's
``state_dict`` (parameters and BatchNorm statistics), the optimizer state,
the update count, the EMA tensors when the trainer keeps them, and the test
accuracy; a JSON sidecar ``<file>.json`` carries the epoch, accuracy and the
model and dataset configs. File names follow the JAX trainer's, with the
``.pt`` suffix of a torch file in place of ``.msgpack``: ``model_best.pt``
on a new best test accuracy, ``model_epoch_<N>.pt`` every ``save_interval``
epochs. Both files are written to a temporary name and renamed, so a reader
never sees half a file.

Writes can leave the training loop, as in the JAX package
(``pointvit_tpu/train/checkpoint.py:34-84,140-175``): one writer thread
drains a FIFO queue, so saves to one file name land in the order they were
made. ``save_checkpoint(..., async_write=True)`` serializes the state at
once and writes the bytes on that thread; :func:`save_checkpoint_deferred`
moves the fetch to the host and the serialization there too, given a
``fetch`` that reads copies the next step cannot touch (the trainer makes
them). :func:`wait_for_pending_writes` blocks until every queued write is
on disk, and raises the first write that failed since the last wait;
:func:`load_checkpoint` waits first.

The JAX trainer's checkpoints (flax msgpack,
``pointvit_tpu/train/checkpoint.py:84-137``) are
read too: :func:`load_checkpoint` tells the two formats apart by their first
bytes (a torch file is a zip archive) and gives a msgpack file's tree as
nested dicts of numpy arrays (:mod:`~pointvit_tpu_torch.train.flax_msgpack`).
:func:`save_checkpoint` writes that format for a file name ending in
``.msgpack``, given the JAX payload's tree (``params``, ``batch_stats``,
``opt_state``, ``step`` and the EMA trees, as
:func:`~pointvit_tpu_torch.convert.state_dict_to_flax` lays out weights).
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading

import torch

from pointvit_tpu_torch.train import flax_msgpack

__all__ = ["SUFFIX", "save_checkpoint", "save_checkpoint_deferred", "load_checkpoint",
           "wait_for_pending_writes"]

SUFFIX = ".pt"
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's archive


_queue: "queue.Queue" = queue.Queue()
_writer: threading.Thread | None = None
_writer_lock = threading.Lock()
_failed: list[BaseException] = []  # writes that raised on the thread, for the next wait


def _writer_loop() -> None:
    while True:
        job = _queue.get()
        try:
            job()
        except BaseException as e:  # kept for wait_for_pending_writes, not lost on the thread
            with _writer_lock:
                _failed.append(e)
        finally:
            _queue.task_done()


def _submit(job) -> None:
    global _writer
    with _writer_lock:
        if _writer is None or not _writer.is_alive():
            _writer = threading.Thread(target=_writer_loop, name="checkpoint-writer", daemon=True)
            _writer.start()
    _queue.put(job)


def wait_for_pending_writes() -> None:
    """Block until every queued checkpoint write is on disk; raise the first
    write that failed since the last wait (the rest are chained to it)."""
    _queue.join()
    with _writer_lock:
        failed, _failed[:] = list(_failed), []
    if failed:
        raise RuntimeError(f"{len(failed)} checkpoint write(s) failed") from failed[0]


def _serialize(filename: str, payload: dict) -> bytes:
    if filename.endswith(".msgpack"):
        return flax_msgpack.dumps(payload)
    buf = io.BytesIO()
    torch.save(payload, buf)
    return buf.getvalue()


def _meta(epoch: int, accuracy: float, model_config: dict, dataset_config: dict) -> str:
    return json.dumps({"epoch": int(epoch), "accuracy": float(accuracy),
                       "model_config": model_config, "dataset_config": dataset_config},
                      indent=2, default=str)


def _write_files(path: str, blob: bytes, meta: str) -> None:
    """Both files through a temporary name and a rename: a reader never sees
    half a checkpoint, nor a sidecar beside a missing one."""
    with open(path + ".tmp", "wb") as f:
        f.write(blob)
    os.replace(path + ".tmp", path)
    with open(path + ".json.tmp", "w") as f:
        f.write(meta)
    os.replace(path + ".json.tmp", path + ".json")


def save_checkpoint(
    output_dir: str,
    filename: str,
    *,
    epoch: int,
    accuracy: float,
    state: dict,
    model_config: dict,
    dataset_config: dict,
    async_write: bool = False,
) -> str:
    """Write ``state`` (a dict of tensors, state dicts and ints) with the
    epoch and accuracy to ``output_dir/filename``; returns the path. A
    ``filename`` ending in ``.msgpack`` is written in flax's format, and
    ``state`` is then the JAX payload's tree of numpy arrays and Python
    scalars. The state is serialized before the call returns; with
    ``async_write`` the bytes reach the disk on the writer thread
    (:func:`wait_for_pending_writes`), else before the call returns."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    blob = _serialize(filename, {"epoch": int(epoch), "accuracy": float(accuracy), **state})
    meta = _meta(epoch, accuracy, model_config, dataset_config)
    if async_write:
        _submit(lambda: _write_files(path, blob, meta))
    else:
        _write_files(path, blob, meta)
    return path


def save_checkpoint_deferred(
    output_dir: str,
    filename: str,
    *,
    epoch: int,
    accuracy: float,
    model_config: dict,
    dataset_config: dict,
    fetch,
) -> str:
    """Queue a checkpoint whose state is ``fetch()`` (called on the writer
    thread: it returns what :func:`save_checkpoint` takes as ``state``), and
    return its path at once. ``fetch`` must read copies that the training
    loop does not change afterwards (``Trainer`` snapshots them on the card
    first); the move to the host, the serialization and the write all run on
    the thread."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    meta = _meta(epoch, accuracy, model_config, dataset_config)

    def job() -> None:
        state = fetch()
        blob = _serialize(filename, {"epoch": int(epoch), "accuracy": float(accuracy), **state})
        _write_files(path, blob, meta)

    _submit(job)
    return path


def load_checkpoint(path: str, map_location=None) -> dict:
    """The dict :func:`save_checkpoint` wrote, or a JAX trainer's msgpack
    checkpoint as nested dicts of numpy arrays (``map_location`` applies to
    a torch file only), with the sidecar under ``"meta"`` when it exists.
    Queued writes finish first (:func:`wait_for_pending_writes`)."""
    wait_for_pending_writes()
    with open(path, "rb") as f:
        is_torch = f.read(len(_ZIP_MAGIC)) == _ZIP_MAGIC
    if is_torch:
        payload = torch.load(path, map_location=map_location, weights_only=True)
    else:
        with open(path, "rb") as f:
            payload = flax_msgpack.loads(f.read())
        if not isinstance(payload, dict):
            raise ValueError(f"{path}: a checkpoint holds a map, got {type(payload).__name__}")
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            payload["meta"] = json.load(f)
    return payload
