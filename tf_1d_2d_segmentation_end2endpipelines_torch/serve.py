"""HTTP inference server of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/serve.py).

- :class:`Predictor` — padded fixed-size batches around one model: a
  request of any size runs in chunks of ``max_batch``.
- :class:`DynamicBatcher` — concurrent requests coalesce into one device
  batch.
- :func:`make_server` / :func:`serve` — stdlib ``ThreadingHTTPServer``:
  POST an image, get a PNG mask back; ``/healthz``, ``/info`` and a
  Prometheus ``/metrics``.

The HTTP skeleton, batcher and metrics have no framework in them and are
carried over as they are; the JAX package cannot be imported here, since
its ``__init__`` imports jax.  AOT export, the 1D server and int8 are not
ported yet.
"""
from __future__ import annotations

import http.server
import io
import json
import os
import typing as tp

import numpy as np
import torch

__all__ = ["Predictor", "DynamicBatcher", "serve", "make_server"]


# ---------------------------------------------------------------------------
# Padded micro-batching predictor
# ---------------------------------------------------------------------------

class Predictor:
    """Batched inference: requests of any size are padded to a fixed
    ``max_batch`` and run in chunks, so the device always sees one batch
    shape.  ``model`` is an eval-mode module on its device whose forward
    takes NHWC and returns ``{"out": NHWC}``.  ``tta`` names views
    (``eval.tta.TTA_2D``) averaged per prediction (JAX serve.py:118-154):
    every view of a padded batch goes through the same one forward, of
    ``max_batch * (1 + len(tta))`` images."""

    def __init__(self, model: torch.nn.Module,
                 input_size: tp.Tuple[int, ...], max_batch: int = 8,
                 tta: tp.Sequence[str] = ()):
        from .eval.tta import make_tta_fn

        self.model = model
        self.max_batch = int(max_batch)
        self.input_size = tuple(input_size)
        self.tta = tuple(tta)
        self.device = next(model.parameters()).device
        self._fn = make_tta_fn(model, self.tta)
        # warm up once on zeros, views included: builds the kernels and
        # picks conv algorithms before the first request
        warm = torch.zeros((self.max_batch, *self.input_size),
                           device=self.device)
        self.output_shape = tuple(self.forward(warm).shape[1:])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One padded batch already on the device -> ``out`` on the device.
        Runs under ``inference_mode`` in the calling thread (grad mode is
        per thread)."""
        with torch.inference_mode():
            return self._fn(x)["out"]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.shape[1:] != self.input_size:
            raise ValueError(f"expected inputs of shape "
                             f"(N, {', '.join(map(str, self.input_size))}),"
                             f" got {tuple(x.shape)}")
        n = x.shape[0]
        outs = []
        for start in range(0, n, self.max_batch):
            chunk = x[start:start + self.max_batch]
            pad = self.max_batch - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, *self.input_size), np.float32)])
            out = self.forward(torch.from_numpy(chunk).to(self.device))
            outs.append(out[:self.max_batch - pad].float().cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros(
            (0, *self.output_shape), np.float32)


class DynamicBatcher:
    """Cross-request dynamic batching: concurrent requests are coalesced
    into one device batch (up to ``Predictor.max_batch``), waiting at most
    ``window_ms`` for co-travellers."""

    def __init__(self, predictor: Predictor, window_ms: float = 5.0):
        import queue
        import threading

        self.predictor = predictor
        self.window_s = window_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _loop(self):
        import queue
        import time as _time

        closing = False
        while not (self._stop.is_set() or closing):
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            pending = [] if first[2].get("cancelled") else [first]
            deadline = _time.monotonic() + self.window_s
            while len(pending) < self.predictor.max_batch:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    # close() mid-collection: run what we have, then exit
                    closing = True
                    break
                if not item[2].get("cancelled"):  # timed-out waiter: skip
                    pending.append(item)          # (don't waste the slot)
            if not pending:
                continue
            try:  # np.stack inside: a shape-mismatched request must fail
                # its waiters, never kill the worker thread
                preds = self.predictor(np.stack([x for x, _, _ in pending]))
                for i, (_, ev, box) in enumerate(pending):
                    box["result"] = preds[i]
                    ev.set()
            except Exception as e:  # noqa: BLE001 — fail the waiters, not
                for _, ev, box in pending:  # the worker
                    box["error"] = e
                    ev.set()
        # drain: requests enqueued around close() must not hang their
        # callers for the full predict timeout
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[2]["error"] = RuntimeError("DynamicBatcher closed")
                item[1].set()

    def predict(self, x: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        """Submit ONE example (H, W, C); blocks until its batch runs."""
        import threading

        if self._stop.is_set():
            raise RuntimeError("DynamicBatcher closed")
        ev = threading.Event()
        box: tp.Dict[str, tp.Any] = {}
        x = np.asarray(x, np.float32)
        expect = getattr(self.predictor, "input_size", None)
        if expect is not None and tuple(x.shape) != tuple(expect):
            # reject up front so one bad request can't fail co-batched ones
            raise ValueError(f"expected input of shape {tuple(expect)}, "
                             f"got {tuple(x.shape)}")
        self._q.put((x, ev, box))
        if not ev.wait(timeout):
            # flag it so the worker skips this entry instead of burning a
            # device batch slot on an abandoned waiter
            box["cancelled"] = True
            raise TimeoutError("dynamic batcher timed out")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

def _mask_to_png(label: np.ndarray, n_classes: int) -> bytes:
    from PIL import Image

    scale = 255 // max(n_classes - 1, 1)
    buf = io.BytesIO()
    Image.fromarray((label * scale).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _decode_request(body: bytes, size: tp.Tuple[int, int], color_mode: str,
                    nf: float) -> np.ndarray:
    # the JAX package's PIL path (serve.py:307-315): decode, convert,
    # Lanczos-resize to the model size, normalize
    from PIL import Image

    img = Image.open(io.BytesIO(body))
    img = img.convert("L" if color_mode == "grayscale" else "RGB")
    if img.size != (size[1], size[0]):
        img = img.resize((size[1], size[0]), Image.LANCZOS)
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr / nf


class _ServerMetrics:
    """Thread-safe request counters + a latency ring for /metrics
    (Prometheus text exposition)."""

    def __init__(self, window: int = 1024):
        import collections
        import threading
        self._lock = threading.Lock()
        self.requests = {"200": 0, "400": 0, "404": 0, "413": 0, "500": 0}
        self._lat = collections.deque(maxlen=window)  # quantiles only
        self._lat_count = 0   # cumulative (summary _count must be
        self._lat_sum = 0.0   # monotonic, not the window length)

    def record_code(self, code: int) -> None:
        """Count EVERY response (predict or not) by status code."""
        with self._lock:
            key = str(code)
            self.requests[key] = self.requests.get(key, 0) + 1

    def record_latency(self, latency_s: float) -> None:
        with self._lock:
            self._lat.append(latency_s)
            self._lat_count += 1
            self._lat_sum += latency_s

    def render(self) -> bytes:
        with self._lock:
            lines = ["# TYPE tpuseg_requests_total counter"]
            for code, n in sorted(self.requests.items()):
                lines.append(
                    f'tpuseg_requests_total{{code="{code}"}} {n}')
            lat = sorted(self._lat)
            lines.append("# TYPE tpuseg_request_latency_seconds summary")
            for q in (0.5, 0.9, 0.99):
                # quantiles over the sliding window (recent behavior)...
                v = lat[min(int(q * len(lat)), len(lat) - 1)] if lat \
                    else float("nan")
                lines.append(
                    f'tpuseg_request_latency_seconds{{quantile="{q}"}} '
                    f"{v:.6f}")
            # ...but _sum/_count are CUMULATIVE (rate() needs monotonic)
            lines.append(
                f"tpuseg_request_latency_seconds_sum {self._lat_sum:.6f}")
            lines.append(
                f"tpuseg_request_latency_seconds_count {self._lat_count}")
        return ("\n".join(lines) + "\n").encode()


class _DrainingHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer whose ``server_close()`` joins in-flight
    handler threads (non-daemon handlers), so a drain answers every
    accepted request before the DynamicBatcher is closed.
    ``request_queue_size`` is the TCP listen backlog: the stock 5
    overflowed under a 64-client burst in the JAX package's soak test."""

    daemon_threads = False
    request_queue_size = 128


def _make_handler(info: tp.Dict[str, tp.Any],
                  decode: tp.Callable[[bytes, tp.Mapping], np.ndarray],
                  predict_one: tp.Callable[[np.ndarray], np.ndarray],
                  respond: tp.Callable[[np.ndarray],
                                       tp.Tuple[bytes, str]]):
    """The HTTP skeleton: /healthz, /info, /metrics, and a POST /predict
    that maps client decode errors to 400 and server-side faults to 500.
    ``decode(body, headers) -> example``; ``respond(pred) -> (body,
    content_type)``."""
    import time as _time

    metrics = _ServerMetrics()

    class Handler(http.server.BaseHTTPRequestHandler):
        server_metrics = metrics  # exposed for the owning server/tests

        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            # count at send time: every response (incl. 404s) appears in
            # /metrics exactly ONCE, even if the client hung up and the
            # socket write below fails
            metrics.record_code(code)
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                pass  # client gone; the response is already counted

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/info":
                self._send(200, json.dumps(info).encode(),
                           "application/json")
            elif self.path == "/metrics":
                self._send(200, metrics.render(),
                           "text/plain; version=0.0.4")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if not self.path.startswith("/predict"):
                self._send(404, b"not found", "text/plain")
                return
            t0 = _time.perf_counter()
            try:  # client errors (undecodable payload) -> 400
                length = int(self.headers.get("Content-Length", "0"))
                if length > 256 * 1024 * 1024:  # bound host memory per
                    # request; megapixel PNGs are far below this
                    self._send(413, b"error: request too large",
                               "text/plain")
                    return
                body = self.rfile.read(length)
                x = decode(body, self.headers)
            except Exception as e:  # noqa: BLE001 — serving must not die
                self._send(400, f"error: {e}".encode(), "text/plain")
                return
            try:  # server-side faults (predict/encode) -> 500
                out_body, ctype = respond(predict_one(x))
            except Exception as e:  # noqa: BLE001
                self._send(500, f"error: {e}".encode(), "text/plain")
                return
            metrics.record_latency(_time.perf_counter() - t0)
            self._send(200, out_body, ctype)

    return Handler


def make_server(train_cfg, ckpt_dir: str, host: str = "127.0.0.1",
                port: int = 8000, max_batch: int = 1, threshold: float = 0.5,
                dtype: tp.Optional[torch.dtype] = None,
                device: tp.Union[str, torch.device] = "cuda",
                seed: tp.Optional[int] = None, int8: bool = False):
    """Build (but do not start) the HTTP server.  Returns the
    ``ThreadingHTTPServer`` — call ``serve_forever()`` on it.  The model
    runs on ``device``; a CUDA device this host lacks raises.

    Routes:
      - ``GET  /healthz``  -> 200 ``ok``
      - ``GET  /info``     -> model/config JSON
      - ``GET  /metrics``  -> Prometheus text
      - ``POST /predict``  -> request body = encoded image (PNG/JPEG/...),
        response = PNG label mask (binary: thresholded; multiclass: the
        reference's sum-of-binarized ordinal rule, Test.py:169-175)
    """
    from .drivers import _resolve_dtype, _restore_model
    from .eval import label_from_pred

    if int8:
        raise NotImplementedError("int8 serving is not ported yet")
    dtype = _resolve_dtype(train_cfg, dtype)
    model = _restore_model(train_cfg, ckpt_dir, "serving", device,
                           dtype=dtype, seed=seed)
    size = (train_cfg.imlength, train_cfg.imwidth)
    predictor = Predictor(model, (*size, train_cfg.num_channels),
                          max_batch=max_batch)
    # max_batch > 1: coalesce concurrent requests into one device batch
    batcher = DynamicBatcher(predictor) if max_batch > 1 else None
    n_fg = max(train_cfg.class_number, 1)
    info = {
        "model": f"{train_cfg.encoder_name}_{train_cfg.decoder_name}",
        "input_size": [*size, train_cfg.num_channels],
        "class_number": train_cfg.class_number,
        "threshold": threshold,
        "max_batch": max_batch,
        "int8": False,
        "device": str(predictor.device),
        "dtype": str(dtype).replace("torch.", ""),
    }

    def _respond(pred):
        label = label_from_pred(pred, train_cfg.class_number, threshold)
        return _mask_to_png(label, n_fg + 1), "image/png"

    Handler = _make_handler(
        info,
        decode=lambda body, headers: _decode_request(
            body, size, train_cfg.image_color_mode,
            train_cfg.normalizing_factor_img),
        predict_one=(batcher.predict if batcher is not None
                     else lambda x: predictor(x[None])[0]),
        respond=_respond)
    server = _DrainingHTTPServer((host, port), Handler)
    server.batcher = batcher  # close() on teardown if you own the server
    server.predictor = predictor
    return server


def _serve_until_stopped(server) -> None:
    """serve_forever with graceful teardown: SIGTERM and Ctrl-C both drain
    in-flight requests, stop the dynamic batcher's worker, and close the
    socket instead of dying mid-response."""
    import signal
    import threading

    def _stop(*_):
        # shutdown() must not run on the serve_forever thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        prev = signal.signal(signal.SIGTERM, _stop)
    except ValueError:  # not the main thread (embedded/test use)
        prev = None
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        # order matters: server_close() joins in-flight handler threads so
        # batched requests already in predict finish before the batcher
        # worker is torn down
        server.server_close()
        if getattr(server, "batcher", None) is not None:
            server.batcher.close()
        print("tpuseg server stopped", flush=True)


def serve(config_path: str = "Train_Configs.ini", host: str = "127.0.0.1",
          port: int = 8000, fold: int = 1, max_batch: int = 1,
          threshold: float = 0.5, int8: bool = False,
          device: str = "cuda", seed: tp.Optional[int] = None) -> None:
    """CLI entry: load the persisted train config + the fold's
    ``best.pt`` and serve forever."""
    from .utils.config import load_train_config

    cfg = load_train_config(config_path)
    ckpt_dir = os.path.join(cfg.save_dir or "", f"Fold_{fold}")
    server = make_server(cfg, ckpt_dir, host=host, port=port,
                         max_batch=max_batch, threshold=threshold,
                         device=device, seed=seed, int8=int8)
    print(f"tpuseg serving {cfg.encoder_name}_{cfg.decoder_name} on "
          f"http://{host}:{server.server_address[1]}  (POST /predict) "
          f"on {server.predictor.device}", flush=True)
    _serve_until_stopped(server)
