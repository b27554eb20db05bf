"""The open-loop client of the serving cells, run as a child process:

    python3 benchmark/openloop.py '<json arguments>'

It imports numpy and the standard library only. It builds the request
bodies from the seed, warms the HTTP path, prints ``READY`` and waits for a
``GO`` line on its standard input; from that moment it posts the schedule:
``rate * seconds`` requests due at the sorted points of a uniform draw over
the window (a Poisson process given its count, so every seed sends the
same number), and ``rate * extra_s`` more after it (a traced run's traced
part), each a body chosen in seeded order. A pool of
``workers`` threads sends them; a request whose worker is busy waits, and
its latency counts the wait, since every latency is taken from the moment
the schedule made the request due to the moment its response was read.
The client never gives up on a request: it waits for every answer (for at
most ``patience_s`` past the window) and writes, to ``out`` (npz): each
request's due time, send time and end time (seconds from ``GO``), its HTTP
status (0 where the connection failed), and the logits of a seeded sample
of the answers with their body ids.
"""

from __future__ import annotations

import http.client
import io
import json
import queue
import sys
import threading
import time

import numpy as np

TIMEOUT_MS = 5000.0   # a failed or later answer counts as this in the tail


def schedule(seed: int, rate: float, seconds: float, bodies: int, extra_s: float = 0.0):
    """(due seconds, body index) of every request of one run: the window's
    ``rate * seconds`` requests, then ``rate * extra_s`` more after it (a
    traced run's traced part)."""
    rng = np.random.default_rng([seed, 1])
    parts = [rng.uniform(a, a + n, size=int(round(rate * n)))
             for a, n in ((0.0, seconds), (seconds, extra_s))]
    due = np.concatenate([np.sort(p) for p in parts])
    return due, rng.integers(0, bodies, size=len(due))


def request_inputs(seed: int, n: int, final_dim, ncams: int):
    """The six inputs of each of ``n`` one-sample requests: uint8 images
    and the rig of one vehicle, jittered per body."""
    from benchmark.fixture import rig
    rng = np.random.default_rng([seed, 2])
    fH, fW = final_dim
    out = []
    for _ in range(n):
        imgs = rng.integers(0, 256, size=(1, ncams, 3, fH, fW), dtype=np.uint8)
        out.append((imgs, *rig(rng, 1, ncams, final_dim)))
    return out


def encode(args) -> bytes:
    names = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(names, args)))
    return buf.getvalue()


def post(port: int, body: bytes, timeout: float):
    """(status, response bytes); status 0 where the connection failed."""
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            conn.request("POST", "/predict", body,
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()
    except (OSError, http.client.HTTPException):
        return 0, b""


def percentile(latencies_ms, q: float) -> float:
    """Nearest-rank percentile (``q`` in (0, 100])."""
    s = sorted(latencies_ms)
    return float(s[max(0, int(np.ceil(q / 100.0 * len(s))) - 1)])


def tail_latencies(due, end, status, timeout_ms: float = TIMEOUT_MS):
    """Each request's latency in ms from its due time, with a failed
    request or one answered later than ``timeout_ms`` at ``timeout_ms``."""
    lat = (np.asarray(end) - np.asarray(due)) * 1e3
    bad = (np.asarray(status) != 200) | ~np.isfinite(lat) | (lat > timeout_ms)
    return np.where(bad, timeout_ms, lat)


def main(a: dict) -> None:
    inputs = request_inputs(a["seed"], a["bodies"], a["final_dim"], a["ncams"])
    bodies = [encode(x) for x in inputs]
    due, which = schedule(a["seed"], a["rate"], a["seconds"], len(bodies), a["extra_s"])
    keep = np.random.default_rng([a["seed"], 3]).permutation(len(due))[:a["sample"]]
    keep_set = set(keep.tolist())
    n = len(due)
    sent, end, status = np.full(n, np.nan), np.full(n, np.nan), np.zeros(n, np.int32)
    kept = {}
    timeout = a["seconds"] + a["extra_s"] + a["patience_s"]
    jobs: "queue.Queue" = queue.Queue()

    def worker():
        while True:
            job = jobs.get()
            if job is None:
                return
            i, t0 = job
            sent[i] = time.monotonic() - t0
            code, data = post(a["port"], bodies[which[i]], timeout)
            end[i] = time.monotonic() - t0
            status[i] = code
            if code == 200 and i in keep_set:
                kept[i] = np.load(io.BytesIO(data))["logits"]

    for body in bodies[:a["warmup"]]:           # the HTTP path, warm
        if post(a["port"], body, 60.0)[0] != 200:
            raise SystemExit("warm-up request failed")
    pool = [threading.Thread(target=worker, daemon=True) for _ in range(a["workers"])]
    for t in pool:
        t.start()
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        raise SystemExit("no GO")
    t0 = time.monotonic()
    for i, d in enumerate(due):
        wait = t0 + d - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        jobs.put((i, t0))
    for _ in pool:
        jobs.put(None)
    deadline = t0 + timeout + 5.0
    for t in pool:
        t.join(max(0.0, deadline - time.monotonic()))
    ids = sorted(kept)
    np.savez(a["out"], due=due, sent=sent, end=end, status=status,
             which=which, sample_ids=np.asarray(ids, np.int64),
             sample_logits=np.stack([kept[i] for i in ids]) if ids
             else np.zeros((0,), np.float32))
    print("DONE", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    main(json.loads(sys.argv[1]))
