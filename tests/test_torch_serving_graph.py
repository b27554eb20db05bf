"""The served artifact's CUDA graph (``serving.py::Predictor``).

On the CPU, which every test run reaches: a Predictor never captures and
answers exactly as its program does, every call in the span
``lss.serve.eager``; both services' ``stats()`` report the graph's
counters; an input off the signature raises before anything is copied or
run; a kernel wrapper's call under a capture takes scratch of its own.

On the card (``gpu`` marker; they skip without one): the B0 artifact at
the serving cell's signature (bsz 8, uint8 images, f32) and a bf16 one,
replayed against the eager program on the same inputs, within three times
the eager program's own call-to-call gap (the f32 tile splat adds with
atomics, so its sums move by a few ulps from call to call) and at least
``FLOOR`` of the logits' scale; three batches replayed in turn, each
against its own eager answer (a stale input buffer fails); an earlier
answer unchanged by later replays (an aliased output fails); the
counters, the splat's recorded launch and its replays' count; callers on
four threads at once, each answered on its own batch; a bf16 replay
after every stream's kept splat scratch is gone; the coalescing HTTP
server; the int8 artifact, which replays or reports why not; and a
capture made to fail, which leaves the Predictor eager and the process
able to draw random numbers and capture again. This file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_serving_graph.py -m gpu
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import mbconv_cuda, splat_cuda
from lss_carla_torch.server import serve
from lss_carla_torch.serving import (INPUT_NAMES, Predictor, example_args,
                                     export_predict, load_predict, read_signature)
from lss_carla_torch.utils import graph as Gr
from lss_carla_torch.utils import trace

from torch_twin import randomize_bn_stats

gpu = pytest.mark.gpu

# the least gap allowed, relative to max |logit|: a few f32 roundings
FLOOR = 2.0 ** -20
COUNTERS = ("captures", "replays", "eager_calls", "fallbacks", "graph_error")


def rig(rng, B, N, final):
    """N cameras around the ego at 1.5 m, level, small augmentation."""
    fH, fW = final
    yaw = 2 * np.pi * np.arange(N) / N
    cam_to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rz = np.zeros((N, 3, 3), np.float32)
    rz[:, 0, 0], rz[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    rz[:, 1, 0], rz[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    rz[:, 2, 2] = 1
    rots = np.broadcast_to(rz @ cam_to_ego, (B, N, 3, 3)).copy()
    trans = rng.normal(0, 0.3, size=(B, N, 3)).astype(np.float32)
    trans[..., 2] += 1.5
    intrins = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intrins[..., 0, 0] = intrins[..., 1, 1] = 0.9 * fW
    intrins[..., 0, 2], intrins[..., 1, 2] = fW / 2, fH / 2
    post_rots = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    post_rots[..., :2, :2] *= rng.uniform(0.9, 1.1, (B, N, 1, 1))
    post_trans = np.zeros((B, N, 3), np.float32)
    post_trans[..., :2] = rng.normal(0, 2, size=(B, N, 2))
    return rots, trans, intrins, post_rots, post_trans


def inputs(seed, B, final, uint8=True):
    rng = np.random.default_rng(seed)
    shape = (B, 6, 3, *final)
    imgs = (rng.integers(0, 256, shape, dtype=np.uint8) if uint8
            else rng.normal(size=shape).astype(np.float32))
    return (imgs, *rig(rng, B, 6, final))


def model_for(grid, aug, device, compute_dtype="float32", variant="b0"):
    model = compile_model(grid, aug, outC=1, variant=variant, device=device,
                          compute_dtype=compute_dtype,
                          generator=torch.Generator().manual_seed(7))
    randomize_bn_stats(model, np.random.default_rng(7), affine=True)
    return model.eval()


def eager(predictor, args):
    """The artifact's program called directly on ``args`` (on its device)."""
    with torch.inference_mode():
        return predictor.program(*(torch.as_tensor(a).to(predictor.device)
                                   for a in args))


def _npz(args):
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(INPUT_NAMES, args)))
    return buf.getvalue()


def _post(base, args):
    req = urllib.request.Request(base + "/predict", data=_npz(args), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return np.load(io.BytesIO(r.read()))["logits"]


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.read()


class Running:
    """``with Running(httpd) as base:`` serves on a thread and shuts the
    server (and a coalescing service's batcher) down after."""

    def __init__(self, httpd):
        self.httpd = httpd
        self.thread = threading.Thread(target=httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        close = getattr(self.httpd.service, "close", None)
        if close is not None:
            close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


# --- the CPU: no graph, the program's own answers ----------------------

TINY = (GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                 zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 36.0, 8.0)),
        DataAugConf(H=64, W=128, final_dim=(32, 64)))


@pytest.fixture(scope="module")
def cpu_artifacts(tmp_path_factory):
    """{"float32" | "uint8": path} of the slim LSS at 32 x 64, bsz 2."""
    model = model_for(*TINY, device="cpu", variant="slim")
    out = {}
    for img in ("float32", "uint8"):
        out[img] = str(tmp_path_factory.mktemp("cpu") / f"slim_{img}.pt2")
        export_predict(model, out[img], bsz=2, uint8_images=img == "uint8")
    return out


@pytest.mark.parametrize("img", ["float32", "uint8"])
def test_cpu_predictor_never_captures(cpu_artifacts, img):
    """Three calls of two batches: each answer bit-equal to the program's
    own on the same inputs, no capture, no replay, three eager calls, and
    each call inside ``lss.serve.eager`` alone."""
    p = load_predict(cpu_artifacts[img], device="cpu")
    batches = [inputs(s, 2, TINY[1].final_dim, uint8=img == "uint8") for s in range(2)]
    calls = batches + batches[:1]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        answers = [p(*b) for b in calls]
    t = trace.table()
    wants = [eager(p, b).numpy() for b in batches]
    for got, i in zip(answers, (0, 1, 0)):
        np.testing.assert_array_equal(got.numpy(), wants[i])
    assert (p.captures, p.replays, p.eager_calls, p.fallbacks, p.graph_error) == \
        (0, 0, len(calls), 0, None)
    assert t["lss.serve.eager"][0] == len(calls) and "lss.serve.replay" not in t


@pytest.mark.parametrize("coalesce", [False, True], ids=["single", "coalescing"])
def test_stats_report_the_graph_counters(cpu_artifacts, coalesce):
    """Both services' ``/stats``, after the warm-up and two requests: on
    the CPU no capture, no replay, three eager calls."""
    path = cpu_artifacts["uint8"]
    warm = example_args(read_signature(path))
    httpd = serve(path, port=0, warmup_args=warm, coalesce=coalesce,
                  flush_ms=1.0, device="cpu")
    with Running(httpd) as base:
        for s in range(2):
            _post(base, inputs(s, 2, TINY[1].final_dim))
        stats = json.loads(_get(base, "/stats")[1])
    assert {k: stats[k] for k in COUNTERS} == {
        "captures": 0, "replays": 0, "eager_calls": 3, "fallbacks": 0,
        "graph_error": None}
    assert httpd.service.stats()["eager_calls"] == 3


@pytest.mark.parametrize("case", ["count", "shape", "dtype", "last_input"])
def test_signature_mismatch_raises_before_any_copy(cpu_artifacts, case, monkeypatch):
    """An input off the signature (one missing, a wrong shape or dtype, or
    the last input wrong after five good ones) raises ValueError naming
    it, before any input is moved or copied and before the program runs."""
    p = load_predict(cpu_artifacts["uint8"], device="cpu")
    args = list(inputs(0, 2, TINY[1].final_dim))
    match = {"count": "expected 6 inputs", "shape": "imgs", "dtype": "imgs",
             "last_input": "post_trans"}[case]
    if case == "count":
        args = args[:5]
    elif case == "shape":
        args[0] = args[0][:1]
    elif case == "dtype":
        args[0] = args[0].astype(np.float32)
    else:
        args[5] = args[5][..., :2]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    moved, ran = [], []
    for name in ("to", "copy_"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            moved.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    monkeypatch.setattr(p, "program", lambda *a: ran.append(a))
    with pytest.raises(ValueError, match=match):
        p(*args)
    monkeypatch.undo()
    assert moved == [] and ran == []
    assert (p.captures, p.replays, p.eager_calls, p.fallbacks) == (0, 0, 0, 0)


@pytest.mark.parametrize("kernel", ["splat", "dw_conv_stats"])
def test_a_capture_takes_scratch_of_its_own(kernel, monkeypatch):
    """Outside a capture a wrapper keeps one scratch per (device, stream),
    shared by the calls there; a call under a capture gets scratch of its
    own (on the card, from the graph's pool), its table zeroed, and
    leaves the kept one as it was, so no later call on that stream can
    grow, free or share what a graph replays into."""
    m, args = ((splat_cuda, (splat_cuda.plan_splat(2, 1000, 500),))
               if kernel == "splat" else (mbconv_cuda, (8, 4)))
    cpu = torch.device("cpu")
    monkeypatch.setattr(m, "_SCRATCH", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    kept = m._scratch(cpu, 7, *args)
    assert all(a is b for a, b in zip(m._scratch(cpu, 7, *args), kept))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    first, second = m._scratch(cpu, 7, *args), m._scratch(cpu, 7, *args)
    for t in (*first, *second):
        assert all(t is not k for k in kept)
    assert first[0] is not second[0] and first[1] is not second[1]
    assert not first[1].any() and not second[1].any()
    assert list(m._SCRATCH) == [(None, 7)]
    assert all(a is b for a, b in zip(m._SCRATCH[(None, 7)], kept))


# --- the card ---------------------------------------------------------

CELL = (GridConf(), DataAugConf())       # b0-simbev: 128 x 352, 200 x 200


@pytest.fixture(scope="module")
def card_artifacts(tmp_path_factory):
    """{name: path}: B0 at bsz 8 with uint8 images, exported on the card
    in f32 (the serving cell's) and bf16, and the int8 one exported on
    the CPU (as ``chip_smoke.py`` serves it) and moved to the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the graph runs only there)")
    tmp = tmp_path_factory.mktemp("card")
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = str(tmp / f"b0_{dtype}.pt2")
        export_predict(model_for(*CELL, device="cuda", compute_dtype=dtype),
                       out[dtype], bsz=8, uint8_images=True)
    out["int8"] = str(tmp / "b0_int8.pt2")
    export_predict(model_for(*CELL, device="cpu"), out["int8"], bsz=8,
                   uint8_images=True, quantize=True)
    return out


def gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tolerance(p, args, calls=3) -> float:
    """Three times the largest gap between ``calls`` eager calls of the
    program on ``args``, and at least ``FLOOR`` x max |logit|."""
    outs = [eager(p, args) for _ in range(calls)]
    own = max(gap(a, b) for i, a in enumerate(outs) for b in outs[i + 1:])
    return max(3 * own, FLOOR * float(outs[0].float().abs().max()))


@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replay_matches_the_eager_program(card_artifacts, dtype):
    """Five calls on one batch: the first captures and answers eagerly,
    the four after replay; every answer within the eager program's own
    call-to-call gap (x3) of its answer; the splat's wrapper recorded one
    launch into the graph and launched only for the warm-up calls; an
    answer returned earlier is not overwritten by later replays."""
    p = load_predict(card_artifacts[dtype], device="cuda")
    x, other = inputs(1, 8, CELL[1].final_dim), inputs(2, 8, CELL[1].final_dim)
    recorded, launched = splat_cuda.captured_by_dtype[dtype], splat_cuda.launches
    replayed = Gr.replayed["splat"][dtype]
    answers = [p(*x) for _ in range(4)]
    kept = answers[1].clone()
    later = p(*other)
    torch.cuda.synchronize()
    assert (p.captures, p.replays, p.eager_calls, p.fallbacks, p.graph_error) == \
        (1, 4, 1, 0, None)
    assert splat_cuda.captured_by_dtype[dtype] - recorded == 1
    assert splat_cuda.launches - launched == Predictor.WARMUP_CALLS
    assert p._graph.held["splat"][dtype] == 1
    assert Gr.replayed["splat"][dtype] - replayed == 4
    want, tol = eager(p, x), tolerance(p, x)
    for i, got in enumerate(answers):
        assert gap(got, want) <= tol, (i, gap(got, want), tol)
    assert torch.equal(answers[1], kept)
    assert answers[1].data_ptr() != later.data_ptr()
    assert gap(later, want) > 100 * tol      # the other batch answers otherwise


@gpu
def test_batches_replayed_in_turn(card_artifacts):
    """Three batches replayed in turn, twice round, after a capture on a
    fourth: each answer within tolerance of its own batch's eager answer,
    and far from the others'."""
    p = load_predict(card_artifacts["float32"], device="cuda")
    p(*inputs(10, 8, CELL[1].final_dim))
    xs = [inputs(s, 8, CELL[1].final_dim) for s in (11, 12, 13)]
    wants = [eager(p, x) for x in xs]
    tols = [tolerance(p, x) for x in xs]
    for _ in range(2):
        for i, x in enumerate(xs):
            got = p(*x)
            assert gap(got, wants[i]) <= tols[i], (i, gap(got, wants[i]), tols[i])
            for j in set(range(3)) - {i}:
                assert gap(got, wants[j]) > 100 * tols[i], (i, j)
    assert (p.captures, p.replays, p.eager_calls) == (1, 6, 1)


@gpu
def test_concurrent_callers_get_their_own_answers(card_artifacts):
    """Four threads call one captured Predictor at once, three times
    each, each on a batch of its own: every answer is its own batch's,
    so no caller's inputs or output were replaced by another's."""
    p = load_predict(card_artifacts["float32"], device="cuda")
    final = CELL[1].final_dim
    p(*inputs(50, 8, final))
    xs = [inputs(s, 8, final) for s in (51, 52, 53, 54)]
    wants = [eager(p, x) for x in xs]
    tols = [tolerance(p, x) for x in xs]
    got, errors = {i: [] for i in range(4)}, []
    barrier = threading.Barrier(4)

    def caller(i):
        try:
            barrier.wait(timeout=60)
            for _ in range(3):
                got[i].append(p(*xs[i]))
        except Exception as e:  # surfaced by the assert below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not errors, errors
    for i, outs in got.items():
        assert len(outs) == 3
        for out in outs:
            assert gap(out, wants[i]) <= tols[i], (i, gap(out, wants[i]), tols[i])
    assert (p.captures, p.replays, p.eager_calls) == (1, 12, 1)


@gpu
def test_a_bf16_replay_keeps_its_scratch(card_artifacts):
    """The bf16 artifact's graph replays into splat scratch of its own:
    with every stream's kept scratch dropped, the cache emptied and device
    memory taken and filled with -1, a replay still answers as the eager
    program does."""
    p = load_predict(card_artifacts["bfloat16"], device="cuda")
    x = inputs(60, 8, CELL[1].final_dim)
    p(*x)
    torch.cuda.synchronize()
    splat_cuda._SCRATCH.clear()
    torch.cuda.empty_cache()
    filler = [torch.full((1 << 24,), -1, dtype=torch.int32, device="cuda")
              for _ in range(16)]
    got = p(*x)
    torch.cuda.synchronize()
    del filler
    want, tol = eager(p, x), tolerance(p, x)
    assert p.replays == 1 and gap(got, want) <= tol, (gap(got, want), tol)


@gpu
def test_coalescing_server_on_the_card(card_artifacts):
    """The coalescing HTTP server (bsz 8) on the card: a full batch and a
    3-sample request (padded by its last sample) answer as the eager
    program does on those batches; the warm-up captured, the two batches
    replayed."""
    path = card_artifacts["float32"]
    final = CELL[1].final_dim
    httpd = serve(path, port=0, warmup_args=inputs(20, 8, final), coalesce=True,
                  flush_ms=50.0, device="cuda")
    full, three = inputs(21, 8, final), inputs(22, 3, final)
    with Running(httpd) as base:
        got_full, got_three = _post(base, full), _post(base, three)
        stats = json.loads(_get(base, "/stats")[1])
    p = httpd.service._predict
    padded = tuple(np.concatenate([a, np.repeat(a[-1:], 5, axis=0)]) for a in three)
    for got, batch, rows in ((got_full, full, 8), (got_three, padded, 3)):
        want = eager(p, batch)[:rows]
        assert gap(torch.from_numpy(got), want.cpu()) <= tolerance(p, batch)
    assert {k: stats[k] for k in COUNTERS} == {
        "captures": 1, "replays": 2, "eager_calls": 1, "fallbacks": 0,
        "graph_error": None}


@gpu
def test_int8_artifact_replays_or_says_why_not(card_artifacts):
    """The int8 artifact (``_int_mm`` convs) moved to the card: three
    calls either replay after one capture or, where the capture fails,
    stay eager with one fallback and its reason; the answers are the
    eager program's either way."""
    p = load_predict(card_artifacts["int8"], device="cuda")
    assert p.moved_from == "cpu"
    x = inputs(30, 8, CELL[1].final_dim)
    answers = [p(*x) for _ in range(3)]
    if p.captures:
        assert (p.captures, p.replays, p.eager_calls, p.fallbacks, p.graph_error) == \
            (1, 2, 1, 0, None)
    else:
        assert (p.replays, p.eager_calls, p.fallbacks) == (0, 3, 1) and p.graph_error
    want, tol = eager(p, x), tolerance(p, x)
    for got in answers:
        assert gap(got, want) <= tol
    print(f"int8 artifact: captures {p.captures}, replays {p.replays}, "
          f"fallbacks {p.fallbacks}, graph_error {p.graph_error}")


@gpu
def test_a_failed_capture_stays_eager(card_artifacts):
    """A program that reads a value back to the host cannot be captured:
    the first call still answers (eagerly), the capture's failure is
    recorded once, and every later call runs eagerly, with no capture
    tried again. The process is left whole: random draws on the card
    work, and another Predictor captures and replays."""
    p = load_predict(card_artifacts["float32"], device="cuda")
    program = p.program

    def syncing(*args):
        out = program(*args)
        out.sum().item()          # a copy to the host: refused in a capture
        return out
    p.program = syncing
    x = inputs(40, 8, CELL[1].final_dim)
    answers = [p(*x) for _ in range(3)]
    assert (p.captures, p.replays, p.eager_calls, p.fallbacks) == (0, 0, 3, 1)
    assert p.graph_error
    want, tol = eager(p, x), tolerance(p, x)
    for got in answers:
        assert gap(got, want) <= tol
    assert torch.isfinite(torch.rand(1024, device="cuda")).all()
    q = load_predict(card_artifacts["float32"], device="cuda")
    again = [q(*x) for _ in range(2)]
    assert (q.captures, q.replays, q.fallbacks) == (1, 1, 0)
    assert gap(again[1], want) <= tol
