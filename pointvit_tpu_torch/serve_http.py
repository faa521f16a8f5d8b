"""HTTP front door for the serving engine, on the standard library alone.

Counterpart of ``pointvit_tpu/serve_http.py``: an HTTP/1.1 API in front of
:class:`~pointvit_tpu_torch.serve.InferenceSession` (the bucket ladder) and
:class:`~pointvit_tpu_torch.serve.MicroBatcher` (request coalescing), so
that clients in any language classify point clouds on the card without the
model's code. ``ThreadingHTTPServer`` gives every request its own thread;
each single-cloud request blocks in ``MicroBatcher.submit``, so concurrent
callers coalesce into one padded forward per batcher tick.

Endpoints
---------
- ``GET  /v1/health`` → ``{"status": "ok", "buckets": [...], "mesh": null,
  "model": ..., "device": ...}``.
- ``POST /v1/classify``: one cloud, shape (N, C). Body: JSON ``{"points":
  [[x, y, z], ...]}`` or a little-endian ``.npy`` array (``Content-Type:
  application/x-npy`` or ``application/octet-stream``). → ``{"class_id": k,
  "logits": [...]}``. Rides the micro-batcher.
- ``POST /v1/classify_batch``: n clouds, shape (n, N, C), the same two
  encodings. → ``{"class_ids": [...], "logits": [[...], ...]}``. Goes
  straight to the session's bucket ladder (it is a batch already).

Both POST endpoints answer with a float32 ``.npy`` array of the logits
instead of JSON when the ``Accept`` header prefers ``application/x-npy`` or
``application/octet-stream`` to ``application/json`` (media types with
``q`` values; ``/v1/classify`` adds an ``X-Class-Id`` header): JSON text of
the logits costs a batch client more than the forward.

A malformed body gets ``400 {"error": ...}``, and so does a cloud whose
channel count the model does not take (or whose point count an exported
program does not): the session checks it before the batcher sees it. An
unknown route gets 404, a body above the cap 413 (and the connection
closes: the body is never read), a fault inside the server 500. The listen
backlog is at least ``max_batch``, so a full tick of clients can connect at
once.

``python -m pointvit_tpu_torch.serve_http --checkpoint PATH | --exported
PATH`` serves a checkpoint or an exported artifact (the counterpart of
``scripts/serve_http.py``) without a mesh: one HTTP process cannot hand
its requests to other ranks. A session given a mesh by a program reports
the mesh's shape under ``"mesh"``.
"""

from __future__ import annotations

import argparse
import io
import json
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from pointvit_tpu_torch.serve import InferenceSession, MicroBatcher

__all__ = ["ServingServer", "make_server", "main"]

NPY_TYPES = ("application/x-npy", "application/octet-stream")


class _BadRequest(ValueError):
    """Client error → HTTP 400 with the message in the JSON body."""


class _PayloadTooLarge(ValueError):
    """Body above the cap → HTTP 413, connection closed."""


def _media_type(header: str) -> str:
    return header.split(";", 1)[0].strip().lower()


def _accept_quality(accept: str, media: str) -> float:
    """The ``q`` an ``Accept`` header gives ``media``: its own entry, else
    its type's ``type/*``, else ``*/*``; 0 when none is listed."""
    prefs: dict[str, float] = {}
    for part in accept.split(","):
        fields = [f.strip() for f in part.split(";")]
        if not fields[0]:
            continue
        q = 1.0
        for f in fields[1:]:
            key, _, value = f.partition("=")
            if key.strip().lower() == "q":
                try:
                    q = float(value)
                except ValueError:
                    q = 0.0
        prefs[fields[0].lower()] = q
    for key in (media, media.split("/")[0] + "/*", "*/*"):
        if key in prefs:
            return prefs[key]
    return 0.0


def wants_npy(accept: str) -> bool:
    """Whether an ``Accept`` header prefers a ``.npy`` answer to JSON."""
    npy = max(_accept_quality(accept, m) for m in NPY_TYPES)
    return npy > 0 and npy > _accept_quality(accept, "application/json")


def _decode_clouds(body: bytes, content_type: str, *, ndim: int) -> np.ndarray:
    """Request body → float32 array of exactly ``ndim`` dimensions."""
    if not body:
        raise _BadRequest("empty request body")
    if _media_type(content_type) in NPY_TYPES:
        try:
            arr = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:
            raise _BadRequest(f"invalid .npy body: {e}") from None
    else:
        try:
            obj = json.loads(body)
        except json.JSONDecodeError as e:
            raise _BadRequest(f"invalid JSON body: {e}") from None
        if not isinstance(obj, dict) or "points" not in obj:
            raise _BadRequest('JSON body must be an object with a "points" key')
        try:
            arr = np.asarray(obj["points"], dtype=np.float32)
        except (ValueError, TypeError) as e:
            raise _BadRequest(f'"points" is not a numeric array: {e}') from None
    if arr.ndim != ndim:
        raise _BadRequest(
            f"expected a {ndim}-d array ({'(N, C) one cloud' if ndim == 2 else '(n, N, C) clouds'}), "
            f"got shape {tuple(arr.shape)}"
        )
    if arr.size == 0:
        raise _BadRequest("empty point array")
    return np.ascontiguousarray(arr, dtype=np.float32)


class _Handler(BaseHTTPRequestHandler):
    server_version = "pointvit-tpu-torch"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet unless the server is verbose
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, content_type: str, headers: dict, close: bool = False) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        if close:
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict, *, close: bool = False) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json", {}, close)

    def _send_logits(self, logits: np.ndarray, obj: dict, headers: dict) -> None:
        if wants_npy(self.headers.get("Accept", "")):
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(logits, dtype=np.float32))
            self._send(200, buf.getvalue(), "application/x-npy", headers)
        else:
            self._send_json(200, obj)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        if length > self.server.max_body_bytes:
            raise _PayloadTooLarge(
                f"request body {length} bytes exceeds the {self.server.max_body_bytes}-byte cap")
        return self.rfile.read(length) if length > 0 else b""

    def _clouds(self, body: bytes, ndim: int) -> np.ndarray:
        clouds = _decode_clouds(body, self.headers.get("Content-Type", ""), ndim=ndim)
        try:
            self.server.session.check_cloud_shape(clouds.shape[-2:])
        except ValueError as e:
            raise _BadRequest(str(e)) from None
        return clouds

    def do_GET(self) -> None:  # noqa: N802 (http.server's name)
        if self.path == "/v1/health":
            s: InferenceSession = self.server.session
            self._send_json(200, {
                "status": "ok",
                "buckets": list(s.buckets),
                "mesh": list(s.mesh.mesh.shape) if s.mesh is not None else None,
                "model": type(s.model).__name__ if s.model is not None else "exported",
                "device": str(s.device),
            })
        else:
            self._send_json(404, {"error": f"unknown route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 (http.server's name)
        try:
            # Read the body whatever the route: on a keep-alive connection
            # unread bytes would be parsed as the next request.
            body = self._read_body()
            if self.path == "/v1/classify":
                logits = np.asarray(self.server.batcher.submit(self._clouds(body, 2)))
                k = int(np.argmax(logits))
                self._send_logits(logits, {"class_id": k, "logits": logits.astype(np.float64).tolist()},
                                  {"X-Class-Id": str(k)})
            elif self.path == "/v1/classify_batch":
                logits = np.asarray(self.server.session.predict_logits(self._clouds(body, 3)))
                self._send_logits(logits, {
                    "class_ids": np.argmax(logits, axis=-1).astype(int).tolist(),
                    "logits": logits.astype(np.float64).tolist(),
                }, {})
            else:
                self._send_json(404, {"error": f"unknown route {self.path}"})
        except _PayloadTooLarge as e:
            self._send_json(413, {"error": str(e)}, close=True)
        except _BadRequest as e:
            self._send_json(400, {"error": str(e)})
        except Exception as e:  # a fault of the server, not of the request
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


class ServingServer(ThreadingHTTPServer):
    """A ``ThreadingHTTPServer`` owning one session and one micro-batcher;
    ``server_close`` closes the batcher, so shutting down leaves no caller
    blocked on its queue. Its listen backlog (``request_queue_size``) is at
    least ``max_batch``."""

    daemon_threads = True

    def __init__(self, addr: tuple[str, int], session: InferenceSession, *, max_batch: int = 256,
                 max_delay_ms: float = 5.0, max_body_bytes: int = 64 * 1024 * 1024,
                 verbose: bool = False) -> None:
        self.session = session
        self.max_body_bytes = int(max_body_bytes)
        self.verbose = verbose
        self.request_queue_size = max(int(max_batch), socket.SOMAXCONN)  # listen() reads it
        self.batcher = MicroBatcher(session, max_batch=max_batch, max_delay_ms=max_delay_ms)
        try:
            super().__init__(addr, _Handler)
        except BaseException:
            self.batcher.close()
            raise

    def server_close(self) -> None:
        super().server_close()
        self.batcher.close()


def make_server(session: InferenceSession, *, host: str = "127.0.0.1", port: int = 8000,
                max_batch: int = 256, max_delay_ms: float = 5.0,
                max_body_bytes: int = 64 * 1024 * 1024, verbose: bool = False) -> ServingServer:
    """Bind a :class:`ServingServer`; ``port=0`` picks a free port (read it
    back from ``server.server_address[1]``). Call ``serve_forever()`` to run
    it and ``shutdown()`` + ``server_close()`` to stop it. A body above
    ``max_body_bytes`` is refused with 413 before it is read."""
    return ServingServer((host, port), session, max_batch=max_batch, max_delay_ms=max_delay_ms,
                         max_body_bytes=max_body_bytes, verbose=verbose)


def main(argv=None) -> None:
    """Serve a checkpoint or an exported artifact over HTTP until stopped."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="a trainer's .msgpack or .pt (with its sidecar .json)")
    src.add_argument("--exported", help="an artifact of python -m pointvit_tpu_torch.export")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--buckets", default="8,32,128,256", help="comma-separated batch buckets")
    ap.add_argument("--max-batch", type=int, default=256, help="micro-batcher flush size")
    ap.add_argument("--max-delay-ms", type=float, default=5.0, help="micro-batcher latency bound")
    ap.add_argument("--max-body-mb", type=float, default=64.0,
                    help="refuse request bodies above this size with 413")
    ap.add_argument("--raw-weights", action="store_true",
                    help="serve the raw (not the EMA) weights of an EMA checkpoint")
    ap.add_argument("--device", default="cuda", help="where a checkpoint is served (default: the card)")
    ap.add_argument("--warmup-points", type=int, default=0,
                    help="if > 0, run every bucket once with clouds of this many points first")
    ap.add_argument("--verbose", action="store_true", help="log requests")
    args = ap.parse_args(argv)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.exported:
        session = InferenceSession.from_exported(args.exported, buckets=buckets)
    else:
        session = InferenceSession.from_checkpoint(args.checkpoint, buckets=buckets,
                                                   use_ema=not args.raw_weights, device=args.device)
    if args.warmup_points > 0:
        print(f"warming {len(session.buckets)} buckets ...", flush=True)
        session.warmup(np.zeros((args.warmup_points, session.in_channels), np.float32))
    server = make_server(session, host=args.host, port=args.port, max_batch=args.max_batch,
                         max_delay_ms=args.max_delay_ms,
                         max_body_bytes=int(args.max_body_mb * 1024 * 1024), verbose=args.verbose)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} buckets={list(session.buckets)}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
