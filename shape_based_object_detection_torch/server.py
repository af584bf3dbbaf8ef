"""HTTP detection server with dynamic batching (port of the JAX package's
``server.py``): the standard library's ``ThreadingHTTPServer`` over a
``serving.Predictor``.

- Dynamic batching: the first request of a batch opens a short window
  (``batch_window_ms``); whatever arrives before it closes, up to
  ``batch_size``, rides the same batch, padded to its bucket. A lone request
  waits at most the window; a loaded server fills whole batches.
- Each request thread decodes and resizes its own image
  (``load_resized_image_host``), so an undecodable upload fails alone with
  400 and host work spreads over the request threads. One device thread
  does every ``submit``/``poll``, double-buffered: batch i+1 is launched
  before batch i is read back.

Endpoints:
  GET  /healthz               -> 200 "ok"
  GET  /stats                 -> JSON counters and mean batch occupancy
  POST /detect?min_score=0.3  -> body: encoded image bytes -> JSON
       {"detections": [{"box": [x0, y0, x1, y1] px, "score": s,
       "label": l}, ...], "width": w, "height": h}

Start it with ``cli/serve_cli.py`` or embed :class:`DetectionServer`.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from shape_based_object_detection_torch.utils.image import load_resized_image_host

# larger uploads are refused before they are read (an encoded image is a
# few MB at most)
MAX_BODY_BYTES = 32 * 1024 * 1024


class _Request:
    __slots__ = ("payload", "event", "result", "error")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class _Batcher:
    """Coalesces concurrent requests into Predictor batches on one device
    thread: the first request of a batch opens a ``window_s`` collection
    window, and the batch launches when full or when the window closes."""

    def __init__(self, predictor, window_s: float = 0.005):
        self._pred = predictor
        self._window_s = window_s
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        # written by the loop thread only; readers take a snapshot
        self.stats = {"requests": 0, "batches": 0, "batch_errors": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, payload) -> _Request:
        req = _Request(payload)
        self._q.put(req)
        return req

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _gather(self, block_s: float):
        """One batch of requests: the first (waited for up to ``block_s``)
        opens the window."""
        try:
            first = self._q.get(timeout=block_s)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self._window_s
        while len(items) < self._pred.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    @staticmethod
    def _resolve(items, dets) -> None:
        for r, det in zip(items, dets):
            r.result = det
            r.event.set()

    @staticmethod
    def _fail(items, e: Exception) -> None:
        for r in items:
            r.error = f"{type(e).__name__}: {e}"
            r.event.set()

    def _poll_into(self, items) -> None:
        try:
            self._resolve(items, self._pred.poll())
        except Exception as e:
            self._fail(items, e)

    def _loop(self) -> None:
        pending = None  # the requests of the batch on the device
        while not self._stop.is_set():
            # with a batch in flight, only look briefly for the next one
            items = self._gather(0.002 if pending else 0.05)
            if items:
                self.stats["requests"] += len(items)
                self.stats["batches"] += 1
                try:
                    self._pred.submit([r.payload for r in items])
                except Exception as e:
                    self.stats["batch_errors"] += 1
                    self._fail(items, e)
                    items = []
            if pending is not None:
                self._poll_into(pending)
            pending = items or None
        if pending is not None:  # the batch in flight at shutdown
            self._poll_into(pending)
        # fail whatever is still queued, so no handler waits out its timeout
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = "server shutting down"
            req.event.set()


class DetectionServer:
    """ThreadingHTTPServer over one Predictor, with dynamic batching."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8000,
                 batch_window_ms: float = 5.0, request_timeout_s: float = 60.0,
                 class_names=None):
        self.predictor = predictor
        self.verbose = False
        self.batcher = _Batcher(predictor, window_s=batch_window_ms / 1e3)
        server = self
        batcher = self.batcher
        names = list(class_names) if class_names else None

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # access logs with verbose only
                if server.verbose:
                    BaseHTTPRequestHandler.log_message(self, fmt, *args)

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._send(200, b"ok", "text/plain")
                elif path == "/stats":
                    s = dict(batcher.stats)
                    s["mean_batch_occupancy"] = round(
                        s["requests"] / max(s["batches"], 1), 2)
                    s["batch_size"] = predictor.batch_size
                    s["bucket_sizes"] = predictor.bucket_sizes
                    self._send(200, json.dumps(s).encode())
                else:
                    self._send(404, b'{"error": "unknown path"}')

            def do_POST(self):
                parsed = urlparse(self.path)
                if parsed.path != "/detect":
                    self._send(404, b'{"error": "unknown path"}')
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    n = 0
                if n <= 0:
                    self._send(400, b'{"error": "empty body"}')
                    return
                if n > MAX_BODY_BYTES:
                    self._send(413, json.dumps({
                        "error": f"body too large ({n} bytes; max "
                                 f"{MAX_BODY_BYTES})"}).encode())
                    return
                body = self.rfile.read(n)
                try:
                    min_score = float(parse_qs(parsed.query).get("min_score", ["0.0"])[0])
                except ValueError:
                    self._send(400, b'{"error": "bad min_score"}')
                    return
                try:
                    resized, h, w = load_resized_image_host(
                        body, predictor.size, predictor.letterbox,
                        backend=predictor.decode_backend)
                except Exception as e:
                    self._send(400, json.dumps(
                        {"error": f"undecodable image: {e}"}).encode())
                    return
                req = batcher.submit((resized, (h, w)))
                if not req.event.wait(timeout=request_timeout_s):
                    self._send(504, b'{"error": "detection timed out"}')
                    return
                if req.error is not None:
                    self._send(400, json.dumps({"error": req.error}).encode())
                    return
                det = req.result
                keep = det.scores >= min_score
                dets = [{
                    "box": [round(float(v), 2) for v in box],
                    "score": round(float(s), 5),
                    "label": (names[int(l)] if names and int(l) < len(names)
                              else int(l)),
                } for box, s, l in zip(det.boxes[keep], det.scores[keep],
                                       det.labels[keep])]
                self._send(200, json.dumps({
                    "detections": dets, "width": int(w), "height": int(h),
                }).encode())

        class _Server(ThreadingHTTPServer):
            # the default backlog (5) drops connections under concurrent load
            request_queue_size = 128
            daemon_threads = True

        self._httpd = _Server((host, port), Handler)
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        """Serve on a background thread (embedding, tests)."""
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._serve_thread.start()

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI)."""
        self._httpd.serve_forever()

    def close(self) -> None:
        """Stop serving: the batch in flight is answered, queued requests
        fail at once."""
        if self._serve_thread is not None:
            self._httpd.shutdown()
            self._serve_thread.join(timeout=5)
        self._httpd.server_close()
        self.batcher.close()
