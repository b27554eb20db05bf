"""Serving traffic: the port's exported artifact behind its coalescing HTTP
server, under an open loop of one-sample requests from a child process.

Set-up makes the model's weights from the seed (every BN drawn, then its
running stats set to its batch moments on eight of the request bodies, so
the eval-mode forward normalises every layer, as a trained model's does),
exports the eval forward with
``export_predict`` (the cell's batch, uint8 images), loads it with
``server.serve(..., coalesce=True)`` on 127.0.0.1 at a port the OS picks,
and starts ``benchmark/openloop.py``, which warms the HTTP path. The window
opens when the client is told to go and lasts ``--seconds`` (a traced run's
traffic goes on for ``trace.TRACE_S`` more, profiled); the client then
waits for every answer. After the window the server is shut down,
the program's state freed, and the plain reference answers each sampled
request's body in f32 with TF32 off, and once more with its operands
rounded to TF32 (the scale of ``rel_l2_vs_tf32``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark import openloop, roofline
from benchmark.harness import BENCH, Cell, Run, boot_clock
from benchmark.reference import lss as ref_lss
from benchmark.trace import PAD_S, TRACE_S, Profiled, span
from benchmark.weights import calibrate_bn, make_weights


# the end-to-end metrics this driver measures
METRICS = ("serve_p95_ms", "serve_samples_per_s", "setup_s")


def serving_weights(cell: Cell, dev) -> dict:
    """The seed's weights with every BN drawn, then calibrated on the first
    eight request bodies (``weights.calibrate_bn``, f32, TF32 off): both
    sides serve these."""
    cfg = cell.config
    weights = make_weights(cfg, cell.seed, dev, random_bn=True)
    inputs = openloop.request_inputs(cell.seed, cell.traffic["bodies"],
                                     cfg["final_dim"], cfg["ncams"])[:8]
    batch = [torch.from_numpy(np.concatenate([x[j] for x in inputs])).to(dev)
             for j in range(6)]
    with ref_lss.full_f32():
        calibrate_bn(weights, cfg, batch)
    return weights


def export(cell: Cell, dev, path: str) -> None:
    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.models.lss import LiftSplatShoot
    from lss_carla_torch.serving import export_predict
    cfg = cell.config
    grid = GridConf(**{k: tuple(v) for k, v in cfg["grid"].items()})
    aug = DataAugConf(final_dim=tuple(cfg["final_dim"]), Ncams=cfg["ncams"])
    with torch.device(dev):
        model = LiftSplatShoot(grid, aug, outC=cfg["outC"], camC=cfg["camC"],
                               downsample=cfg["downsample"], variant=cfg["variant"],
                               compute_dtype=cell.work["compute_dtype"])
    model.to(dev).load_state_dict(serving_weights(cell, dev))
    export_predict(model, path, bsz=cell.work["max_batch"], uint8_images=True,
                   ncams=cfg["ncams"])


def plant(cell: Cell, service) -> None:
    """The check's own tests break the timed path underneath with
    ``cell.fault``: ``answer_altered`` (the first row of every batch the
    program computes is moved by its largest magnitude)."""
    if cell.fault == "answer_altered":
        whole = service._predict

        def altered(*args):
            out = whole(*args).clone()
            out[0] += out.abs().max()
            return out
        service._predict = altered
    elif cell.fault is not None:
        raise ValueError(f"no fault {cell.fault!r} in serving")


def run(cell: Cell) -> Run:
    from lss_carla_torch.serving import example_args, read_signature
    from lss_carla_torch.server import serve
    dev = torch.device(cell.device)
    cfg, work, t = cell.config, cell.work, cell.traffic
    tmp = tempfile.mkdtemp(prefix="bench-serve-")
    httpd = client = server = None
    try:
        path = os.path.join(tmp, "artifact.pt2")
        export(cell, dev, path)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        with span("service.warmup"):
            httpd = serve(path, port=0, host="127.0.0.1",
                          warmup_args=example_args(read_signature(path)),
                          coalesce=True, flush_ms=work["flush_ms"], device=dev)
        service = httpd.service
        plant(cell, service)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        out = os.path.join(tmp, "client.npz")
        args = {"port": httpd.server_address[1], "seed": cell.seed, "rate": t["rate_per_s"],
                "seconds": cell.seconds,
                "extra_s": TRACE_S + 2 * PAD_S if cell.trace else 0.0,
                "bodies": t["bodies"], "sample": t["sample"],
                "workers": t["workers"], "warmup": t["warmup"],
                "patience_s": t["patience_s"], "final_dim": cfg["final_dim"],
                "ncams": cfg["ncams"], "out": out}
        client = subprocess.Popen([sys.executable, str(BENCH / "openloop.py"), json.dumps(args)],
                                  stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if client.stdout.readline().strip() != "READY":
            raise RuntimeError("the open-loop client did not start")
        if dev.type == "cuda":     # the peak of the timed path, not of set-up's checks
            torch.cuda.reset_peak_memory_stats()
        window_start = boot_clock()
        t0 = time.perf_counter()
        client.stdin.write("GO\n")
        client.stdin.flush()
        b0, s0 = service.batches, service.batched_samples
        time.sleep(max(0.0, t0 + cell.seconds - time.perf_counter()))
        b1, s1 = service.batches, service.batched_samples
        seconds = time.perf_counter() - t0
        summary = None
        if cell.trace:             # the traffic goes on for the traced part
            with Profiled() as p:
                time.sleep(TRACE_S)
                traced = service.batches
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            summary, traced = p.summary, traced - b1
        if client.stdout.readline().strip() != "DONE":
            raise RuntimeError("the open-loop client failed")
        client.wait(timeout=30)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        httpd.shutdown()
        httpd.server_close()
        service.close()
        server.join(timeout=10)
        httpd = None
        r = np.load(out)
        due = r["due"] < cell.seconds        # the requests due in the window
        lat = openloop.tail_latencies(r["due"][due], r["end"][due], r["status"][due])
        answered = int(((r["status"] == 200) & (r["end"] <= seconds)).sum())
        failed = int((r["status"] != 200).sum())
        layer = {"trace": summary, "window_s": seconds, "batches": b1 - b0,
                 "traced_batches": traced if cell.trace else 0,
                 "batched_samples": s1 - s0, "answered": answered}
        if cell.trace:
            layer["flops_per_sample"] = roofline.model_flops(cfg, 1, train=False)["forward"]
            layer["peak_flops"] = roofline.PEAK_FLOPS[work["peak"]]
        del service
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ids = r["which"][r["sample_ids"]]
        want, scale = reference_answers(cell, dev, ids, (ref_lss.identity, ref_lss.tf32))
        numbers = logit_numbers(ids, r["sample_logits"], want, scale)
        numbers["unanswered"] = float(failed)
        layer["check"] = {"ids": ids, "answers": r["sample_logits"], "want": want,
                          "scale": scale, "numbers": numbers}
        late = r["sent"] - r["due"]
        notes = [f"requests {len(lat)}, answered in the window {answered}, failed {failed}; "
                 f"latency p50 {openloop.percentile(lat, 50)!r} p95 "
                 f"{openloop.percentile(lat, 95)!r} p99 {openloop.percentile(lat, 99)!r} ms; "
                 f"sent late by median {float(np.nanmedian(late)) * 1e3!r} max "
                 f"{float(np.nanmax(late)) * 1e3!r} ms; batches {b1 - b0}, samples {s1 - s0}"]
        checks = {k: (numbers[k], lim) for k, lim in work["limits"].items()}
        notes.append("printed, not compared: " + repr(
            {k: v for k, v in numbers.items() if k not in checks}))
        return Run(attempted=len(lat), failed=failed,
                   e2e={"serve_p95_ms": openloop.percentile(lat, 95),
                        "serve_samples_per_s": answered / seconds,
                        "setup_s": window_start - cell.start},
                   checks=checks, memory_peak_bytes=peak, layer=layer, notes=notes)
    finally:
        if httpd is not None:
            if server is not None:
                httpd.shutdown()
            httpd.server_close()
            httpd.service.close()
        if client is not None and client.poll() is None:
            client.kill()
            client.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


def reference_answers(cell: Cell, dev, body_ids, quants=(ref_lss.identity,)) -> list:
    """[{body: logits}] of the plain reference for each distinct body, one
    dict for each of ``quants``, in f32 with TF32 off, eight bodies a
    forward."""
    cfg = cell.config
    with ref_lss.full_f32():
        weights = serving_weights(cell, dev)
        inputs = openloop.request_inputs(cell.seed, cell.traffic["bodies"],
                                         cfg["final_dim"], cfg["ncams"])
        ids = sorted(set(int(i) for i in body_ids))
        outs = [{} for _ in quants]
        with torch.no_grad():
            for k in range(0, len(ids), 8):
                block = ids[k:k + 8]
                batch = [torch.from_numpy(np.concatenate([inputs[i][j] for i in block]))
                         .to(dev) for j in range(6)]
                for out, quant in zip(outs, quants):
                    logits = ref_lss.forward(weights, cfg, batch, quant=quant)
                    out.update(zip(block, logits.cpu().numpy()))
    return outs


def logit_numbers(body_ids, answers, want, scale) -> dict:
    """Over the answers: ``logit_gap``, the largest max |served - want| /
    max |want| (a widest gap); ``logit_rel_l2``, the largest ||served -
    want|| / ||want||; and ``rel_l2_vs_tf32``, the largest ||served -
    want|| / ||scale - want||, where ``scale`` is the reference with its
    operands rounded to TF32: the served answer's gap in units of the gap
    that the precision the cell states gives on the same network and body,
    which a network that amplifies rounding scales alike."""
    if len(body_ids) == 0:
        return {k: float("nan") for k in ("logit_gap", "logit_rel_l2", "rel_l2_vs_tf32")}
    gap = l2 = ratio = 0.0
    for i, a in zip(body_ids, answers):
        w = want[int(i)]
        d = np.asarray(a, np.float64).reshape(w.shape) - w
        gap = max(gap, float(np.abs(d).max() / np.abs(w).max()))
        l2 = max(l2, float(np.linalg.norm(d) / np.linalg.norm(w)))
        ratio = max(ratio, float(np.linalg.norm(d) / np.linalg.norm(scale[int(i)] - w)))
    return {"logit_gap": gap, "logit_rel_l2": l2, "rel_l2_vs_tf32": ratio}
