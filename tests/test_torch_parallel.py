"""The port's parallel steps against the JAX package, on the CPU with gloo
ranks spawned per test (``torch_parallel_ranks.py``): the slim LSS with
JAX's weights through ``utils/convert.py``, dropout off on both sides
(flax's ``nn.Dropout`` patched to the identity where JAX trains, as in
``test_torch_accum.py``).

- The data-parallel step on 2 ranks against what JAX's
  ``make_sharded_train_step`` computes: JAX's single-device gradients on
  each half-batch, averaged, the mean loss, the averaged BN running stats
  and the summed IoU counts. Limits: loss 1e-5 relative, all gradients
  together 1e-4 relative (L2), running stats 1e-5; and against the port's
  own single-device step on each half, averaged (the same limits: only
  the all-reduce's rounding differs). (``slow``: the same against
  ``make_sharded_train_step`` itself on JAX's 2-device CPU mesh.)

  The images are 64 x 128, not the tiny config's 32 x 64: train-mode BN
  on the slim trunk's last planes (1 x 2 at 32 x 64) normalises 24 values
  a channel, and there the port's single-device gradients alone miss
  JAX's by 1.6e-5 to 1.1e-3 relative over seeds 1, 2 and 11 (the f32
  floor ``test_torch_accum.py`` records); at 64 x 128 (2 x 4 planes) the
  same step reads 1.1e-5 at seed 11. With ``fused_dw`` the BN moments
  come from sums and sums of squares, whose cancellation sets a floor of
  its own: the port's fused step misses JAX's by 1.96e-3 here (JAX's
  Pallas kernel interpreted, or JAX without it: the same reading), and
  its own result at 8 torch threads by 2.8e-3 at 1 thread. So the fused
  case is held to JAX at 5e-3, and to the port's own step at 1e-4 with
  one thread, as the ranks run.
- The camera-parallel predict at (1, 2), (1, 3) and (2, 3) against JAX's
  unsharded forward (JAX's own test's limits, rtol and atol 1e-5), and the
  camera gradient reduction against ``jax.grad`` of the unsharded loss
  (rtol 2e-4, atol 2e-6, as ``tests/test_parallel_camera.py``).
- The sharded validation of a ``pad_last`` set counts each sample once:
  loss and IoU equal JAX's unsharded evaluation of the whole set (1e-5).
- The EMA's BN recalibration on 2 ranks, without and with ``fused_dw``,
  takes the global batch's moments: JAX's ``BNRecalibrator`` over the
  whole batch (1e-5).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from lss_carla_tpu.configs import DataAugConf
from lss_carla_tpu.models.lss import compile_model as jax_compile_model
from lss_carla_tpu.ops import mbconv_pallas
from lss_carla_tpu.training import state as JState
from lss_carla_tpu.training.bn_recal import BNRecalibrator
from lss_carla_tpu.training.loss import bce_with_logits, masked_eval_metrics
from lss_carla_tpu.training.step import _micro_grads

from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils import convert as C

from test_torch_lss import rig
from torch_parallel_ranks import build, run_ranks, tensors
from util import tiny_grid

POS_WEIGHT = 2.13


AUG = DataAugConf(H=128, W=256, final_dim=(64, 128))


@pytest.fixture(scope="module")
def setup():
    """The slim JAX model, its variables (jitted init) and a batch of 4
    samples x 6 cameras whose frustums land in the grid."""
    rng = np.random.default_rng(11)
    B, N = 4, 6
    imgs = rng.normal(size=(B, N, 3) + AUG.final_dim).astype(np.float32)
    binimgs = (rng.uniform(size=(B, 1, 16, 16)) < 0.2).astype(np.float32)
    batch = (imgs, *rig(rng, B, N, AUG.final_dim), binimgs)
    jm = jax_compile_model(tiny_grid(), AUG, outC=1, variant="slim")
    variables = jax.jit(lambda r, *a: jm.init({"params": r}, *a, train=False))(
        jax.random.PRNGKey(0), *map(jnp.asarray, batch[:6]))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return jm, variables, batch


def _payload(setup, **kw):
    _, variables, batch = setup
    return {"grid": tiny_grid().to_dict(), "aug": AUG.to_dict(),
            "state_dict": C.jax_variables_to_state_dict(variables, "slim"),
            "batch": batch, "pos_weight": POS_WEIGHT, **kw}


def _jax_state(jm, variables, tx=None):
    return JState.TrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=tx or optax.identity())


def _as_state_dict(params, batch_stats):
    return C.variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)},
        C.name_map("slim"))


def _val_samples(rng, n=5):
    out = []
    for _ in range(n):
        imgs = rng.normal(size=(1, 6, 3) + AUG.final_dim).astype(np.float32)
        binimg = (rng.uniform(size=(1, 1, 16, 16)) < 0.2).astype(np.float32)
        out.append(tuple(a[0] for a in (imgs, *rig(rng, 1, 6, AUG.final_dim),
                                        binimg)))
    return out


@pytest.fixture(scope="module")
def data_parallel(setup, tmp_path_factory):
    """The 2-rank data-parallel run (both fused_dw settings and the
    validation): one spawn for the module."""
    val = _val_samples(np.random.default_rng(12))
    outs = run_ranks(tmp_path_factory.mktemp("dp"), 2, "data_parallel",
                     _payload(setup, val=val))
    return outs, val


@pytest.fixture(scope="module")
def jax_half_batches(setup):
    """JAX's single-device step on each half-batch, averaged: what
    ``make_sharded_train_step`` computes over 2 devices."""
    jm, variables, batch = setup
    state = _jax_state(jm, variables)
    fn = jax.jit(lambda s, b: _micro_grads(s, s.batch_stats, b,
                                           jax.random.PRNGKey(0), POS_WEIGHT))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        halves = [fn(state, tuple(jnp.asarray(a[i:i + 2]) for a in batch))
                  for i in (0, 2)]
    mean = lambda *xs: sum(np.asarray(x, np.float64) for x in xs) / len(xs)  # noqa: E731
    grads = jax.tree_util.tree_map(mean, *[h[0] for h in halves])
    stats = jax.tree_util.tree_map(mean, *[h[2] for h in halves])
    return {"loss": float(mean(*[h[1] for h in halves])),
            "intersect": sum(float(h[4]) for h in halves),
            "union": sum(float(h[5]) for h in halves),
            "state_dict": _as_state_dict(grads, stats)}


def _port_half_batches(setup, fused_dw):
    """The port's own single-device step on each half, averaged, on one
    torch thread as the ranks run."""
    p = _payload(setup)
    grads, stats, loss = {}, {}, 0.0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for i in (0, 2):
        model = build(p, fused_dw)
        state = create_train_state(model, weight_decay=0.0, max_grad_norm=0.0)
        m = make_train_step(model, POS_WEIGHT, device="cpu")(
            state, tensors(tuple(a[i:i + 2] for a in p["batch"])))
        loss += m["loss"].item() / 2
        for k, q in model.named_parameters():
            grads[k] = grads.get(k, 0) + q.grad / 2
        for k, v in model.state_dict().items():
            stats[k] = stats.get(k, 0) + v / 2
    torch.set_num_threads(threads)
    return loss, grads, stats


def _check_step(got, want, grad_tol=1e-4):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert (got["intersect"], got["union"]) == (want["intersect"],
                                                want["union"])
    ref = want["state_dict"]
    miss = {k: (float((g - ref[k]).norm()), float(ref[k].norm()))
            for k, g in got["grads"].items()}
    total = np.sqrt(sum(d * d for d, _ in miss.values())
                    / sum(r * r for _, r in miss.values()))
    assert total <= grad_tol, (total, max(miss.items(),
                                          key=lambda kv: kv[1][0]))
    for k, v in got["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    return total


@pytest.mark.parametrize("fused_dw", [False, True])
def test_data_parallel_step_matches_jax(setup, data_parallel,
                                        jax_half_batches, fused_dw):
    """Both ranks end bit-equal (each rank checked it), with the averaged
    gradient, the mean loss and the averaged running stats of JAX's two
    half-batch steps."""
    outs, _ = data_parallel
    want = jax_half_batches
    loss, grads, stats = _port_half_batches(setup, fused_dw)
    own = dict(want, loss=loss, state_dict={
        k: grads.get(k, v) for k, v in stats.items()})
    for out in outs:
        _check_step(out[fused_dw], want, 5e-3 if fused_dw else 1e-4)
        _check_step(out[fused_dw], own)
    for k, v in outs[0][fused_dw]["state"].items():
        assert torch.equal(v, outs[1][fused_dw]["state"][k]), k


def test_sharded_val_counts_each_sample_once(setup, data_parallel):
    """5 val samples over 2 ranks at 1 a rank: the loader pads to 6, the
    mask drops the copy, and the summed accumulators give JAX's loss and
    IoU over the whole set (as tests/test_parallel_eval.py)."""
    outs, val = data_parallel
    jm, variables, _ = setup
    apply = jax.jit(lambda *a: jm.apply(variables, *a, train=False))
    total = {"loss_sum": 0.0, "intersect": 0.0, "union": 0.0, "batch": 0.0}
    for s in val:
        logits = apply(*(jnp.asarray(a[None]) for a in s[:6]))
        m = masked_eval_metrics(logits, jnp.asarray(s[6][None]),
                                jnp.ones((1,)), POS_WEIGHT)
        for k in total:
            total[k] += float(m[k])
    assert total["batch"] == 5.0
    for out in outs:
        assert out["val_batches"] == 3
        assert out["val"]["loss"] == pytest.approx(total["loss_sum"] / 5, rel=1e-5)
        assert out["val"]["iou"] == pytest.approx(
            total["intersect"] / total["union"], rel=1e-5)


@pytest.fixture(scope="module")
def camera_runs(setup, tmp_path_factory):
    """{mesh: the ranks' results} of the camera worker on the first two
    samples, run once a mesh; (1, 2) also returns the ranks' gradients."""
    runs = {}

    def run(mesh):
        if mesh not in runs:
            batch = tuple(a[:2] for a in setup[2])
            runs[mesh] = run_ranks(
                tmp_path_factory.mktemp("camera"), mesh[0] * mesh[1],
                "camera", _payload(setup, batch=batch, mesh=mesh,
                                   grads=mesh == (1, 2)))
        return runs[mesh]
    return run


@pytest.mark.parametrize("fused_dw", [False, True])
def test_recalibration_takes_the_global_batch_moments(setup, data_parallel,
                                                      fused_dw):
    """BN recalibration on 2 ranks, each over its half of a batch, gives
    the running stats of JAX's ``BNRecalibrator`` over the whole batch (the
    global batch's moments, as JAX's recalibration over a sharded batch
    computes them), bit-equal on both ranks: 1e-5 relative and absolute, as
    the step's running stats (each mean sums thousands of f32 activations
    of order 1 in another order). With ``fused_dw`` the ranks average the
    depthwise kernel's sums, and JAX runs its Pallas kernel interpreted."""
    outs, _ = data_parallel
    jm, variables, batch = setup
    jm, kernel = jm.clone(fused_dw=fused_dw), mbconv_pallas.dw_conv_stats
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        mp.setattr(mbconv_pallas, "dw_conv_stats",
                   lambda x, w, stride=1: kernel(x, w, stride, True))
        stats = BNRecalibrator(jm, variables["batch_stats"]).recalibrate(
            variables["params"], [tuple(map(jnp.asarray, batch[:6]))])
    want = _as_state_dict(variables["params"], stats)
    for out in outs:
        got = out["recal"][fused_dw]
        assert set(got) and set(got) <= set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            assert torch.equal(v, outs[1]["recal"][fused_dw][k]), k


@pytest.mark.parametrize("mesh", [(1, 2), (1, 3), (2, 3)])
def test_camera_predict_matches_unsharded_jax(setup, camera_runs, mesh):
    jm, variables, batch = setup
    want = np.asarray(jax.jit(lambda *a: jm.apply(variables, *a, train=False))(
        *(jnp.asarray(a[:2]) for a in batch[:6])))
    for out in camera_runs(mesh):
        rows = slice(out["data_index"] * (2 // mesh[0]),
                     (out["data_index"] + 1) * (2 // mesh[0]))
        np.testing.assert_allclose(out["logits"].numpy(), want[rows],
                                   rtol=1e-5, atol=1e-5)


def test_camera_grad_reduction_matches_unsharded_jax(setup, camera_runs):
    """At (1, 2): each cam rank's camera-encoder gradient is 2x its
    cameras' part (the backward all-reduce), and the mean over the ranks
    is jax.grad of the unsharded loss (eval-mode forward: no dropout,
    fixed BN), as tests/test_parallel_camera.py holds JAX's own."""
    jm, variables, batch = setup
    batch = tuple(a[:2] for a in batch)
    jb = tuple(map(jnp.asarray, batch))

    def loss(params):
        out = jm.apply({"params": params,
                        "batch_stats": variables["batch_stats"]},
                       *jb[:6], train=False)
        return bce_with_logits(out, jb[6], POS_WEIGHT)

    grads = jax.jit(jax.grad(loss))(variables["params"])
    want = _as_state_dict(grads, variables["batch_stats"])
    outs = camera_runs((1, 2))
    for out in outs:
        assert set(out["grads"]) <= set(want)
        for k, g in out["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=k)
    for k, g in outs[0]["grads"].items():
        assert torch.equal(g, outs[1]["grads"][k]), k


@pytest.mark.slow
def test_data_parallel_step_matches_jax_sharded_step(setup, data_parallel,
                                                     monkeypatch):
    """Against ``make_sharded_train_step`` itself on JAX's 2-device CPU
    mesh, with an identity optimizer: its update is the gradient it
    applied (new params - old), its state the averaged running stats."""
    from lss_carla_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                             replicate)
    from lss_carla_tpu.parallel.step import make_sharded_train_step
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    jm, variables, batch = setup
    mesh = make_mesh(2)
    state = replicate(mesh, jax.tree_util.tree_map(
        lambda x: jnp.array(x, copy=True), _jax_state(jm, variables)))
    step = make_sharded_train_step(jm, mesh, POS_WEIGHT)
    new, metrics = step(state, jax.device_put(tuple(map(jnp.asarray, batch)),
                                              batch_sharding(mesh)),
                        jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        new.params, variables["params"])
    want = {"loss": float(metrics["loss"]),
            "intersect": float(metrics["intersect"]),
            "union": float(metrics["union"]),
            "state_dict": _as_state_dict(grads, new.batch_stats)}
    outs, _ = data_parallel
    # the applied update carries the parameters' rounding (ulp(p) against
    # a gradient of ~1e-3): held as all gradients together
    got = dict(outs[0][False])
    ref = want["state_dict"]
    miss = sum(float((g - ref[k]).norm()) ** 2 for k, g in got["grads"].items())
    norm = sum(float(ref[k].norm()) ** 2 for k in got["grads"])
    assert np.sqrt(miss / norm) <= 1e-4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k, v in got["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
