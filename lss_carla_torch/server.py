"""Minimal HTTP inference server over a serving artifact.

Counterpart of ``lss_carla_tpu/server.py``, over the port's
``serving.load_predict``.

Protocol (stdlib-only on both sides):

* ``POST /predict``: the request body is an ``.npz`` archive holding the
  six forward inputs (``imgs, rots, trans, intrins, post_rots,
  post_trans``) with exactly the artifact's shapes and dtypes; the response
  is an ``.npz`` with ``logits`` (B, outC, X, Y). 400 on a shape or dtype
  mismatch (the expected signature is in the error).
* ``GET /healthz``: 200 once the artifact is loaded and warmed; 503 before.
  An un-warmed server's first successful request pins the signature.
* ``GET /stats``: JSON request count + latency percentiles (ms).

Two serving modes:

* default: single-threaded; one in-flight batch, requests queue in the
  listen backlog; each request must match the artifact's exact signature.
* ``--coalesce``: micro-batching. Concurrent requests carrying 1..B
  samples each are coalesced into one padded device batch of the
  artifact's batch size B, with a ``--flush_ms`` latency budget for lone
  requests. Handler threads only validate and enqueue numpy arrays; a
  single batcher thread owns every device call.

    python -m lss_carla_torch.server --artifact /models/lss.pt --port 8471
"""

from __future__ import annotations

import collections
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

import numpy as np
import torch

from lss_carla_torch.serving import INPUT_NAMES, load_predict


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class PredictService:
    """Wraps a loaded artifact; validates payloads and tracks latency."""

    def __init__(self, artifact_path: str, device="cuda"):
        self._predict = load_predict(artifact_path, device=device)
        self.signature = None     # filled on first (warmup) call
        self.latencies_ms = []
        self.requests = 0

    def warmup(self, example_args):
        """Run once on example inputs; pins the accepted signature."""
        self.signature = [(tuple(a.shape), str(a.dtype))
                          for a in example_args]
        return _numpy(self._predict(*example_args))

    def predict(self, arrays):
        missing = [n for n in INPUT_NAMES if n not in arrays]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        args = [np.asarray(arrays[n]) for n in INPUT_NAMES]
        if self.signature is not None:
            got = [(tuple(a.shape), str(a.dtype)) for a in args]
            if got != self.signature:
                raise ValueError(
                    f"signature mismatch: got {got}, expected "
                    f"{self.signature} (the artifact has static shapes)")
        t0 = time.perf_counter()
        out = _numpy(self._predict(*args))
        ms = (time.perf_counter() - t0) * 1000.0
        if self.signature is None:
            # un-warmed server: the first successful request pins the
            # signature, so /healthz flips to 200 and later requests are
            # shape-validated
            self.signature = [(tuple(a.shape), str(a.dtype)) for a in args]
        self.requests += 1
        self.latencies_ms.append(ms)
        if len(self.latencies_ms) > 10000:
            self.latencies_ms = self.latencies_ms[-5000:]
        return out

    def stats(self) -> dict:
        lat = sorted(self.latencies_ms)
        pct = (lambda p: round(lat[min(int(p * len(lat)), len(lat) - 1)], 3)
               if lat else None)
        return {"requests": self.requests,
                "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                               "p99": pct(0.99)}}


class _Pending:
    __slots__ = ("args", "n", "event", "result", "error", "t0")

    def __init__(self, args, n):
        self.args = args
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t0 = time.perf_counter()


class BatchingPredictService(PredictService):
    """Coalesces concurrent ``/predict`` requests into one device batch.

    The artifact has static shapes at batch size ``max_batch``. Requests
    carry 1..max_batch samples; queued requests are packed greedily up to
    max_batch samples, the remainder is padded by repeating the last sample
    (discarded on split), and each caller gets back exactly its own rows of
    the logits. A request that arrives alone still flushes after
    ``flush_ms``, bounding added latency.

    Thread contract: ``predict`` (handler threads) does numpy + queueing
    only and blocks on a per-request event; ``_loop`` (the one batcher
    thread) is the only code that touches the device.
    """

    def __init__(self, artifact_path: str, max_batch: int,
                 flush_ms: float = 3.0, device="cuda"):
        super().__init__(artifact_path, device=device)
        self.max_batch = int(max_batch)
        self._flush_s = float(flush_ms) / 1000.0
        self.batches = 0
        self.batched_samples = 0
        self._stats_lock = threading.Lock()
        self._q = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="predict-batcher")
        self._thread.start()

    # -- request side (handler threads) --

    def _submit(self, args, n) -> _Pending:
        """Queue one request for the batcher thread and wait for it."""
        req = _Pending(args, n)
        with self._cv:
            if self._stop:
                raise RuntimeError("service closed")
            self._q.append(req)
            self._cv.notify_all()
        if not req.event.wait(timeout=300.0):
            raise RuntimeError("batched predict timed out")
        if req.error is not None:
            raise req.error
        return req

    def warmup(self, example_args):
        """Run the example batch on the batcher thread (which owns the
        device); pins the accepted signature."""
        args = [np.asarray(a) for a in example_args]
        self.signature = [(tuple(a.shape), str(a.dtype)) for a in args]
        out = self._submit(args, args[0].shape[0]).result
        self.batches = self.batched_samples = 0  # warmup is not traffic
        return out

    def predict(self, arrays):
        missing = [n for n in INPUT_NAMES if n not in arrays]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        args = [np.asarray(arrays[n]) for n in INPUT_NAMES]
        b = args[0].shape[0] if args[0].ndim else 0
        if self.signature is not None:
            # per-sample validation: trailing dims + dtype must match the
            # artifact; the batch dim may be anything in 1..max_batch
            got = [(tuple(a.shape), str(a.dtype)) for a in args]
            ok = (1 <= b <= self.max_batch) and all(
                g[0][1:] == s[0][1:] and g[0][0] == b and g[1] == s[1]
                for g, s in zip(got, self.signature))
            if not ok:
                per_sample = [((f"1..{self.max_batch}",) + s[0][1:], s[1])
                              for s in self.signature]
                raise ValueError(
                    f"signature mismatch: got {got}, expected per-sample "
                    f"{per_sample} (coalescing server, artifact batch "
                    f"{self.max_batch})")
        req = self._submit(args, b)
        ms = (time.perf_counter() - req.t0) * 1000.0
        with self._stats_lock:  # handler threads update these concurrently
            self.requests += 1
            self.latencies_ms.append(ms)
            if len(self.latencies_ms) > 10000:
                self.latencies_ms = self.latencies_ms[-5000:]
        return req.result

    def stats(self) -> dict:
        with self._stats_lock:
            s = super().stats()
        s["batches"] = self.batches
        s["mean_batch_occupancy"] = (
            round(self.batched_samples / self.batches, 2)
            if self.batches else None)
        return s

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)

    # -- device side (the one batcher thread) --

    def _take_batch(self):
        """Block for the first request, then fill up to max_batch samples
        or until flush_ms elapses. Returns [] when closing."""
        with self._cv:
            while not self._q and not self._stop:
                self._cv.wait()
            if self._stop and not self._q:
                return []
            batch = [self._q.popleft()]
        total = batch[0].n
        deadline = time.perf_counter() + self._flush_s
        while total < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            with self._cv:
                if not self._q:
                    self._cv.wait(remaining)
                if self._q:
                    if self._q[0].n + total <= self.max_batch:
                        r = self._q.popleft()
                        batch.append(r)
                        total += r.n
                    else:
                        break  # head doesn't fit this batch
        return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            try:
                total = sum(r.n for r in batch)
                cols = [np.concatenate([r.args[i] for r in batch], axis=0)
                        for i in range(len(INPUT_NAMES))]
                pad = self.max_batch - total
                if pad:
                    cols = [np.concatenate(
                        [c, np.repeat(c[-1:], pad, axis=0)], axis=0)
                        for c in cols]
                logits = _numpy(self._predict(*cols))
                off = 0
                for r in batch:
                    r.result = logits[off:off + r.n]
                    off += r.n
                self.batches += 1
                self.batched_samples += total
            except Exception as e:     # surface to every waiting caller
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.event.set()


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_handler(service: PredictService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):    # quiet: latency lives in /stats
            pass

        def _send(self, code, body: bytes, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                if service.signature is None:
                    self._send(503, b"loading: not warmed", "text/plain")
                else:
                    self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(service.stats()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._send(400, b"bad Content-Length header", "text/plain")
                return
            try:
                arrays = dict(np.load(io.BytesIO(self.rfile.read(n)),
                                      allow_pickle=False))
            except Exception as e:   # truncated/corrupt npz -> BadZipFile
                self._send(400, f"unreadable npz payload: {e}".encode(),
                           "text/plain")
                return
            try:
                logits = service.predict(arrays)
            except ValueError as e:
                self._send(400, str(e).encode(), "text/plain")
                return
            except Exception as e:   # device/runtime failure: report, don't
                self._send(500, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")          # drop the connection
                return
            self._send(200, _npz_bytes(logits=logits))

    return Handler


class _Server(HTTPServer):
    # socketserver's default listen backlog (5) resets bursts of
    # simultaneous connections -- exactly the coalescing workload
    request_queue_size = 128


class _ThreadingServer(ThreadingHTTPServer):
    request_queue_size = 128
    daemon_threads = True


def serve(artifact: str, port: int = 8471, host: str = "127.0.0.1",
          warmup_args=None, coalesce: bool = False, flush_ms: float = 3.0,
          device="cuda") -> HTTPServer:
    """Build the server (the caller runs ``serve_forever``). ``coalesce=True``
    enables request micro-batching and requires ``warmup_args``, whose batch
    dim is the coalescing target."""
    if coalesce:
        if warmup_args is None:
            raise ValueError("coalesce=True requires warmup_args (the "
                             "artifact batch size comes from their shapes)")
        service = BatchingPredictService(
            artifact, max_batch=int(np.asarray(warmup_args[0]).shape[0]),
            flush_ms=flush_ms, device=device)
        service.warmup(warmup_args)
        # handler threads only parse/validate/enqueue; the batcher thread
        # owns the device, so threading the HTTP layer is safe
        httpd = _ThreadingServer((host, port), make_handler(service))
    else:
        service = PredictService(artifact, device=device)
        if warmup_args is not None:
            service.warmup(warmup_args)
        httpd = _Server((host, port), make_handler(service))
    httpd.service = service
    return httpd


def _main():
    import argparse

    from lss_carla_torch.serving import example_args, read_signature

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", required=True)
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda")
    p.add_argument("--coalesce", action="store_true",
                   help="micro-batch concurrent requests up to the "
                        "artifact's batch size per device call")
    p.add_argument("--flush_ms", type=float, default=3.0,
                   help="max extra latency a lone request waits for "
                        "coalescing partners")
    args = p.parse_args()

    warm = example_args(read_signature(args.artifact))
    httpd = serve(args.artifact, args.port, args.host, warmup_args=warm,
                  coalesce=args.coalesce, flush_ms=args.flush_ms,
                  device=args.device)
    bsz = warm[0].shape[0]
    mode = (f"coalescing up to bsz {bsz}, flush {args.flush_ms} ms"
            if args.coalesce else "single-threaded")
    print(f"serving {args.artifact} on {args.host}:{args.port} [{mode}] "
          f"(signature {httpd.service.signature})", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    _main()
