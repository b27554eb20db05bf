"""The port's tracer (``lss_carla_torch/utils/trace.py``) and the spans of
the step, the coalescing server and the loader, on the CPU.

Outside a profiler a span costs one flag read and records nothing. Under
``torch.profiler.profile`` every thread's spans reach the process-wide
table, whatever thread the profiler was started from; a span of the
profiling thread is also an event of the profile. No JAX here, so the
file also runs where only the port is installed."""

import http.client
import io
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.data.loader import DataLoader, prefetch_to_device
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.server import serve
from lss_carla_torch.serving import INPUT_NAMES, export_predict
from lss_carla_torch.training import loop
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils import trace

STEP_SPANS = ("lss.step", "lss.step.forward", "lss.step.backward", "lss.step.update")
SERVE_SPANS = ("lss.serve.fill", "lss.serve.assemble", "lss.serve.predict")


@pytest.fixture(autouse=True)
def empty_table():
    trace.reset()
    yield
    trace.reset()


def profiled(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def event_names(prof) -> set:
    return {e.name for e in prof.events()}


# --- the tracer


def test_off_outside_a_profiler(monkeypatch):
    """No profiler: one shared no-op context, no ``record_function``, an
    empty table."""
    calls = []
    monkeypatch.setattr(trace, "record_function", lambda name: calls.append(name))
    a, b = trace.span("lss.a"), trace.span("lss.b")
    assert a is b
    with a:
        pass
    assert calls == [] and trace.table() == {}


def test_counts_and_durations_add_up():
    t0 = time.perf_counter()
    with profiled():
        for _ in range(3):
            with trace.span("lss.a"):
                time.sleep(0.01)
    wall = time.perf_counter() - t0
    n, seconds = trace.table()["lss.a"]
    assert n == 3 and 0.03 <= seconds < wall


def test_nested_spans_are_all_recorded():
    with profiled() as prof:
        with trace.span("lss.outer"):
            with trace.span("lss.inner"):
                time.sleep(0.005)
            with trace.span("lss.inner"):
                pass
    t = trace.table()
    assert t["lss.outer"][0] == 1 and t["lss.inner"][0] == 2
    assert t["lss.outer"][1] >= t["lss.inner"][1] >= 0.005
    assert {"lss.outer", "lss.inner"} <= event_names(prof)


def test_a_thread_started_inside_the_profile_is_counted():
    def work():
        with trace.span("lss.worker"):
            time.sleep(0.005)

    with profiled():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    n, seconds = trace.table()["lss.worker"]
    assert n == 1 and seconds >= 0.005


def test_eight_threads_lose_no_count():
    each, old = 400, sys.getswitchinterval()
    barrier = threading.Barrier(8)

    def work():
        barrier.wait(timeout=30)
        for _ in range(each):
            with trace.span("lss.busy"):
                pass

    sys.setswitchinterval(1e-6)
    try:
        with profiled():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    t = trace.table()
    assert t["lss.busy"][0] == 8 * each


def test_reset_clears_the_table():
    with profiled():
        with trace.span("lss.a"):
            pass
    assert trace.table()
    trace.reset()
    assert trace.table() == {}


# --- the step


def tiny_confs():
    return (GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                     zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 36.0, 8.0)),
            DataAugConf(H=64, W=128, final_dim=(32, 64)))


def tiny_model():
    grid, aug = tiny_confs()
    return compile_model(grid, aug, variant="slim", device="cpu",
                         generator=torch.Generator().manual_seed(3))


def inputs(rng, B, N=6, fH=32, fW=64):
    """uint8 images and a level camera rig looking outwards from 1.5 m."""
    imgs = rng.integers(0, 256, size=(B, N, 3, fH, fW), dtype=np.uint8)
    yaw = 2 * np.pi * np.arange(N) / N
    rz = np.zeros((N, 3, 3), np.float32)
    rz[:, 0, 0], rz[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    rz[:, 1, 0], rz[:, 1, 1], rz[:, 2, 2] = np.sin(yaw), np.cos(yaw), 1
    cam = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rots = np.broadcast_to(rz @ cam, (B, N, 3, 3)).copy()
    trans = np.zeros((B, N, 3), np.float32)
    trans[..., 2] = 1.5
    intrins = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intrins[..., 0, 0] = intrins[..., 1, 1] = 0.9 * fW
    intrins[..., 0, 2], intrins[..., 1, 2] = fW / 2, fH / 2
    post_rots = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    post_trans = np.zeros((B, N, 3), np.float32)
    return imgs, rots, trans, intrins, post_rots, post_trans


@pytest.mark.parametrize("ema", [0.0, 0.9], ids=["no_ema", "ema"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(accum, ema):
    """``lss.step`` once a step, forward and backward once a microbatch,
    the update once; each also an event of the profiling thread."""
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    model = tiny_model()
    state = create_train_state(model, ema_decay=ema)
    step = make_train_step(model, accum_steps=accum, ema_decay=ema, device="cpu")
    micro = [(*inputs(rng, 1), (rng.uniform(size=(1, 1, 16, 16)) < 0.2)
              .astype(np.float32)) for _ in range(accum)]
    batch = micro[0] if accum == 1 else tuple(np.stack(x) for x in zip(*micro))
    step(state, batch)            # outside the profile: nothing recorded
    assert trace.table() == {}
    with profiled() as prof:
        step(state, batch)
    t = trace.table()
    assert {k: t[k][0] for k in STEP_SPANS} == {
        "lss.step": 1, "lss.step.forward": accum, "lss.step.backward": accum,
        "lss.step.update": 1}
    assert t["lss.step"][1] >= t["lss.step.forward"][1] + t["lss.step.backward"][1] \
        + t["lss.step.update"][1]
    assert set(STEP_SPANS) <= event_names(prof)


# --- the coalescing server


def _post(base, args):
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(INPUT_NAMES, args)))
    req = urllib.request.Request(base + "/predict", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        return np.load(io.BytesIO(r.read()))["logits"]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "lss4.pt")
    export_predict(tiny_model().eval(), path, bsz=4, uint8_images=True)
    return path


@pytest.mark.parametrize("all_threads", [False, True], ids=["default", "all_threads"])
def test_coalescing_server_spans(artifact, all_threads):
    """One read, parse and reply a request; one fill, assemble and predict a
    batch. With every thread profiled, the batcher's spans are also events
    of the profile with no CPU parent, as a trace's reader finds them."""
    kw = {}
    if all_threads:
        config = trace.all_threads_config()
        if config is None:
            pytest.skip("this torch's profiler has no profile_all_threads")
        kw["experimental_config"] = config
    rng = np.random.default_rng(2)
    args = inputs(rng, 6)
    httpd = serve(artifact, port=0, warmup_args=tuple(a[:4] for a in args),
                  coalesce=True, flush_ms=50.0, device="cpu")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    service = httpd.service
    results, errors = {}, []

    def client(i):
        try:
            results[i] = _post(base, tuple(a[i:i + 1] for a in args))
        except Exception as e:  # surfaced by the assert below
            errors.append((i, e))

    try:
        with profiled(**kw) as prof:
            b0 = service.batches
            clients = [threading.Thread(target=client, args=(i,)) for i in range(6)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=120)
            batches = service.batches - b0
        assert not errors, errors
        assert not any(c.is_alive() for c in clients) and len(results) == 6
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    server.join(timeout=10)
    assert not server.is_alive()
    # a handler thread ends its reply span after its client has read the
    # answer, and the server does not join its handler threads
    deadline = time.monotonic() + 30
    while (trace.table().get("lss.serve.reply", (0, 0.0))[0] < 6
           and time.monotonic() < deadline):
        time.sleep(0.01)
    t = trace.table()
    assert t["lss.serve.read"][0] == t["lss.serve.parse"][0] == t["lss.serve.reply"][0] == 6
    # the batcher's last fill may still wait for a request when the profile
    # ends; every batch it ran was filled, assembled and predicted in it
    assert t["lss.serve.assemble"][0] == t["lss.serve.predict"][0] == batches >= 2
    assert batches <= t["lss.serve.fill"][0] <= batches + 1
    if all_threads:
        roots = {e.name for e in prof.events() if e.cpu_parent is None}
        assert set(SERVE_SPANS) <= roots


def _raw_post(port, body, length):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        conn.send(body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _npz(arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["bad_length", "corrupt_body", "wrong_shape"])
def test_refused_requests_spans(artifact, case):
    """A refused request gets its 400 and no reply span: a bad
    Content-Length is refused before the body is parsed; a body that is no
    npz, or whose arrays are off the signature, after it."""
    rng = np.random.default_rng(3)
    args = inputs(rng, 4)
    httpd = serve(artifact, port=0, warmup_args=args, coalesce=True,
                  flush_ms=5.0, device="cpu")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    good = _npz(dict(zip(INPUT_NAMES, (a[:1] for a in args))))
    body, length, want = {
        "bad_length": (b"", "x", b"bad Content-Length header"),
        "corrupt_body": (good[:100], "100", b"unreadable npz payload"),
        "wrong_shape": (_npz(dict(zip(INPUT_NAMES, (a[:1, :2] for a in args)))),
                        None, b"signature mismatch"),
    }[case]
    try:
        with profiled():
            status, text = _raw_post(httpd.server_address[1], body,
                                     str(len(body)) if length is None else length)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
    server.join(timeout=10)
    assert status == 400 and text.startswith(want), text
    t = trace.table()
    assert t["lss.serve.read"][0] == 1
    assert t.get("lss.serve.parse", (0, 0.0))[0] == (0 if case == "bad_length" else 1)
    assert "lss.serve.reply" not in t and "lss.serve.predict" not in t


# --- the loader


class Items:
    """A dataset of numbered arrays."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return np.full((2, 3), i, np.float32), np.array([i], np.int64)


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_spans(workers):
    """A sample span for each sample, a collate and a pin span for each
    batch, through ``prefetch_to_device``."""
    loader = DataLoader(Items(), batch_size=4, num_workers=workers, pad_last=True)
    with profiled():
        got = [b for b in prefetch_to_device(iter(loader), "cpu")]
    assert [int(b[1][0, 0]) for b in got] == [0, 4, 8]
    t = trace.table()
    assert {k: t[k][0] for k in ("lss.loader.sample", "lss.loader.collate",
                                 "lss.loader.pin")} == {
        "lss.loader.sample": 12, "lss.loader.collate": 3, "lss.loader.pin": 3}


# --- train(profile_dir=...)


def test_train_profile_holds_the_step_spans(tmp_path):
    root = generate_fixture(tmp_path / "simbev", num_scenes=3, samples_per_scene=2,
                            H=64, W=128, grid=16)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = loop.train(str(root), nepochs=1, H=64, W=128, final_dim=(32, 64),
                         xbound=(-50.0, 50.0, 6.25), ybound=(-50.0, 50.0, 6.25),
                         dbound=(4.0, 36.0, 8.0), bsz=2, nworkers=1, variant="slim",
                         device="cpu", max_steps=2, val_step=0, save_step=0,
                         profile_dir=str(tmp_path / "prof"), logdir=str(tmp_path / "run"))
    finally:
        torch.set_num_threads(n)
    assert out["counter"] == 2
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert set(STEP_SPANS) <= names
    if trace.all_threads_config() is not None:    # the loader's threads too
        assert {"lss.loader.sample", "lss.loader.pin"} <= names
