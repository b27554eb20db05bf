"""The port's whole model and serving path on the CPU: end-to-end logits
against the JAX package (its Pallas splat in interpret mode), and the
artifact round trip export_predict -> load_predict -> HTTP server (single
and coalescing) against the live model."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.configs import DataAugConf as JDataAugConf
from lss_carla_tpu.configs import GridConf as JGridConf
from lss_carla_tpu.models.lss import compile_model as jax_compile_model

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.server import serve
from lss_carla_torch.serving import INPUT_NAMES, export_predict, load_predict
from lss_carla_torch.utils.convert import jax_variables_to_state_dict

from test_torch_convert import randomize_variables, tiny_confs
from torch_twin import randomize_bn_stats
from util import tiny_aug, tiny_grid


def rig(rng, B, N, final_dim):
    """A camera rig whose frustums land in the grid: N cameras around the
    ego at 1.5 m, optical axis level, small augmentation."""
    fH, fW = final_dim
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


def _jax_vs_port(rng, jgrid, jaug, variant, B, N):
    fH, fW = jaug.final_dim
    imgs = rng.normal(size=(B, N, 3, fH, fW)).astype(np.float32)
    args = (imgs, *rig(rng, B, N, jaug.final_dim))
    jm = jax_compile_model(jgrid, jaug, outC=1, variant=variant,
                           splat_method="pallas")
    variables = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False)
    variables = randomize_variables(variables, rng)
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        variables, *map(jnp.asarray, args), train=False))

    port = compile_model(GridConf.from_dict(jgrid.to_dict()),
                         DataAugConf.from_dict(jaug.to_dict()), outC=1,
                         variant=variant, splat_method="pallas", device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(variables, variant))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == (B, 1, *GridConf.from_dict(
        jgrid.to_dict()).nx[:2])
    assert np.abs(want).max() > 1e-2  # the BEV is not empty
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-2)


def test_end_to_end_logits_match_jax_slim(rng):
    _jax_vs_port(rng, tiny_grid(), tiny_aug(), "slim", B=2, N=6)


@pytest.mark.slow
def test_end_to_end_logits_match_jax_b0(rng):
    """B0 trunk, default grid and depth bins, 6 cameras at 64x192."""
    _jax_vs_port(rng, JGridConf(), JDataAugConf(final_dim=(64, 192)), "b0",
                 B=1, N=6)


# --- artifact round trip and the HTTP server, on the CPU ---------------


@pytest.fixture(scope="module")
def live_model():
    grid, aug = tiny_confs()
    model = compile_model(grid, aug, variant="slim", device="cpu",
                          generator=torch.Generator().manual_seed(5))
    randomize_bn_stats(model, np.random.default_rng(5), affine=True)
    return model.eval()


def _inputs(rng, B, uint8):
    fH, fW = 32, 64
    imgs = (rng.integers(0, 256, size=(B, 6, 3, fH, fW), dtype=np.uint8)
            if uint8 else rng.normal(size=(B, 6, 3, fH, fW)).astype(np.float32))
    return (imgs, *rig(rng, B, 6, (fH, fW)))


def _live(model, args):
    with torch.no_grad():
        return model(*map(torch.from_numpy, args)).numpy()


def _npz(args):
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(INPUT_NAMES, args)))
    return buf.getvalue()


def _post(base, args):
    req = urllib.request.Request(base + "/predict", data=_npz(args),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        return np.load(io.BytesIO(r.read()))["logits"]


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, r.read()


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", t


def test_artifact_round_trip_is_exact(live_model, tmp_path):
    rng = np.random.default_rng(11)
    args = _inputs(rng, 2, uint8=True)
    path = str(tmp_path / "lss.pt")
    export_predict(live_model, path, bsz=2, uint8_images=True)
    predict = load_predict(path, device="cpu")
    got = predict(*args)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 16, 16)
    np.testing.assert_array_equal(got.numpy(), _live(live_model, args))
    with pytest.raises(ValueError, match="imgs"):
        predict(args[0].astype(np.float32), *args[1:])  # uint8 signature


def test_http_server_single_matches_live(live_model, tmp_path):
    rng = np.random.default_rng(12)
    args = _inputs(rng, 1, uint8=False)
    path = str(tmp_path / "lss1.pt")
    export_predict(live_model, path, bsz=1)
    httpd = serve(path, port=0, warmup_args=args, device="cpu")
    base, thread = _start(httpd)
    try:
        assert _get(base, "/healthz")[0] == 200
        for _ in range(2):
            np.testing.assert_array_equal(_post(base, args),
                                          _live(live_model, args))
        stats = json.loads(_get(base, "/stats")[1])
        assert stats["requests"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_server_coalesce_matches_live(live_model, tmp_path):
    """The coalescing server (artifact batch 4). Where the device batch is
    known -- one full 4-sample request, one lone request padded by
    repeating its sample -- the logits equal the live model's on that
    batch exactly. Concurrent single-sample requests are coalesced in
    arrival order, which the test cannot know; PyTorch's CPU kernels round
    a sample differently at another position in the batch, so those are
    held to 1e-5."""
    rng = np.random.default_rng(13)
    args8 = _inputs(rng, 8, uint8=True)
    path = str(tmp_path / "lss4.pt")
    export_predict(live_model, path, bsz=4, uint8_images=True)
    httpd = serve(path, port=0, warmup_args=tuple(a[:4] for a in args8),
                  coalesce=True, flush_ms=200.0, device="cpu")
    base, thread = _start(httpd)
    results, errors = {}, []
    barrier = threading.Barrier(8)

    def client(i):
        try:
            barrier.wait(timeout=60)
            results[i] = _post(base, tuple(a[i:i + 1] for a in args8))
        except Exception as e:  # surfaced by the assert below
            errors.append((i, e))

    try:
        full = tuple(a[4:8] for a in args8)
        np.testing.assert_array_equal(_post(base, full),
                                      _live(live_model, full))
        lone = _post(base, tuple(a[2:3] for a in args8))
        padded = tuple(np.repeat(a[2:3], 4, axis=0) for a in args8)
        np.testing.assert_array_equal(lone, _live(live_model, padded)[:1])

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not errors, errors
        assert not any(c.is_alive() for c in clients)
        want = _live(live_model, args8)
        for i in range(8):
            assert results[i].shape == (1, 1, 16, 16)
            np.testing.assert_allclose(results[i][0], want[i], rtol=1e-5,
                                       atol=1e-5)
        stats = json.loads(_get(base, "/stats")[1])
        assert stats["requests"] == 10
        # 8 concurrent single-sample clients against an idle batch-4
        # server coalesce: fewer device batches than requests
        assert stats["batches"] < 10 and stats["mean_batch_occupancy"] > 1.0
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
    thread.join(timeout=10)
    assert not thread.is_alive()
