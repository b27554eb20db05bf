"""The open-loop client against a stand-in server on 127.0.0.1: requests
go out on the schedule whatever the server does, each latency counts from
the due time (so a stall delays the requests behind it), and a failed
request enters the tail at 5,000 ms."""

import io
import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from benchmark import openloop
from benchmark.harness import BENCH


def stand_in(stall_s: float, fail_every: int):
    calls, lock = [], threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            with lock:
                calls.append(time.monotonic())
                n = len(calls)
            arrays = np.load(io.BytesIO(body))
            if n == 3:
                time.sleep(stall_s)
            if fail_every and n % fail_every == 0:
                self.send_response(500)
                self.end_headers()
                return
            out = io.BytesIO()
            np.savez(out, logits=np.full((1, 1, 2, 2), float(arrays["imgs"].sum()), np.float32))
            data = out.getvalue()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, calls


def drive(tmp_path, stall_s=0.0, fail_every=0, workers=1):
    httpd, calls = stand_in(stall_s, fail_every)
    out = tmp_path / "c.npz"
    args = {"port": httpd.server_address[1], "seed": 2 ** 31 + 11, "rate": 40.0,
            "seconds": 0.5, "extra_s": 0.0, "bodies": 4, "sample": 5, "workers": workers, "warmup": 1,
            "patience_s": 10, "final_dim": [32, 64], "ncams": 2, "out": str(out)}
    p = subprocess.Popen([sys.executable, str(BENCH / "openloop.py"), json.dumps(args)],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "READY"
        p.stdin.write("GO\n")
        p.stdin.flush()
        assert p.stdout.readline().strip() == "DONE"
        assert p.wait(timeout=30) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
        httpd.shutdown()
        httpd.server_close()
    return np.load(out)


def test_latency_counts_the_wait_behind_a_stall(tmp_path):
    r = drive(tmp_path, stall_s=0.3)
    due, sent, end = r["due"], r["sent"], r["end"]
    assert len(due) == 20 and np.all(r["status"] == 200)
    lat = openloop.tail_latencies(due, end, r["status"])
    assert np.allclose(lat, (end - due) * 1e3)
    # one worker: the requests due during the stall go late, and their
    # latency holds that wait, not only their own service time
    behind = (due > due[1]) & (due < due[1] + 0.25)
    assert behind.any() and np.all(sent[behind] - due[behind] > 0.02)
    assert np.all(lat[behind] > 50.0)
    assert np.all(sent >= due - 1e-3)


def test_failures_enter_the_tail_at_the_timeout(tmp_path):
    r = drive(tmp_path, fail_every=4, workers=4)
    lat = openloop.tail_latencies(r["due"], r["end"], r["status"])
    failed = r["status"] != 200
    assert failed.sum() == 5 and np.all(lat[failed] == openloop.TIMEOUT_MS)
    assert np.all(lat[~failed] < openloop.TIMEOUT_MS)


def test_sampled_answers_come_back_with_their_bodies(tmp_path):
    r = drive(tmp_path, workers=4)
    inputs = openloop.request_inputs(2 ** 31 + 11, 4, (32, 64), 2)
    assert len(r["sample_ids"]) == 5
    for i, logits in zip(r["sample_ids"], r["sample_logits"]):
        assert logits.flat[0] == float(inputs[r["which"][i]][0].sum())
