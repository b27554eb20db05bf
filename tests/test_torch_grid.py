"""The port's BEV-grid parallel mode (``parallel/halo.py``,
``parallel/grid.py``) on the CPU, with gloo ranks spawned per test
(``torch_parallel_ranks.py``).

- The halo ops on 1 to 4 grid ranks against the unsharded op, forward and
  gradient: convolutions of the BEV encoder's kinds (7 x 7 stride 2, 3 x 3
  stride 1 and 2, 1 x 1 stride 2) and the align_corners upsample by 2 and
  4, at row counts that leave slabs empty (2 rows over 4 ranks) and start
  them on odd rows (25 rows over 2). Limits: 1e-5 relative and absolute
  (the same sums in another order; the upsample computes PyTorch's
  formula).
- The grid predict at (data, grid) (1, 2), (1, 4) and (2, 2) against JAX's
  unsharded forward, rtol and atol 1e-5 (JAX's own
  ``tests/test_parallel_grid.py``'s limits), on the slim LSS with JAX's
  weights; at (1, 4) the 16 x 16 grid's layer-3 output has 2 rows, so two
  ranks own none.
- One grid train step at the same meshes against the unsharded step on
  the whole batch of 4, the port's own (one torch thread, as the ranks
  run) and JAX's (``training/step.py``'s gradient function, flax's
  ``nn.Dropout`` patched to the identity; the port's dropout at 0); and at
  (1, 2) one on 2 samples. PR 8's limits (``tests/test_torch_parallel.py``
  at its 64 x 128 images): loss 1e-5 relative, all gradients together
  1e-4 relative (L2), running stats 1e-5. They hold on 2 samples. On the
  4-sample batch the train-mode BN of the slim trunk is ill-conditioned
  and turns rounding into gradient: the port's single-device step misses
  JAX's by 4.3e-3 there, against 1.0e-5 on its first 2 samples (flax
  takes the variance as E[x^2] - E[x]^2, ``use_fast_variance``, the port
  two-pass), and the grid step, which splits the batch's sums over the
  ranks, misses the port's step by 3.3e-4 there and by under 1e-5 on the
  2 samples (the tests print these readings; ``pytest -s``). So on 4
  samples the gradients are held to the port's step at 1e-3 and to JAX's
  at the port's measured miss plus 1e-3 (the triangle inequality); loss,
  counts and stats keep PR 8's limits. Every rank's parameters and stats
  bit-equal.
- The masked validation of a ``pad_last`` set: JAX's unsharded loss and
  IoU over the whole set (1e-5).
- With dropout on, the replicas stay bit-equal over two steps.
- ``train()``'s refusals of the grid keywords (JAX's checks), and
  ``python -m lss_carla_torch.train --grid_devices 2 --n_devices 2`` on
  the fixture.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from lss_carla_tpu.training.loss import masked_eval_metrics
from lss_carla_tpu.training.step import _micro_grads

from test_torch_parallel import (POS_WEIGHT, _as_state_dict, _check_step,
                                 _jax_state, _payload, _val_samples, setup)
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.train import main
from lss_carla_torch.training.loop import train
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils.checkpoint import load_checkpoint

from torch_parallel_ranks import build, run_ranks, tensors

assert setup  # the module-scoped fixture, shared with this module


def _halo_cases(gen):
    def t(*shape):
        return torch.randn(*shape, generator=gen)

    cases = []
    for rows, k, s in ((16, 7, 2), (5, 3, 2), (2, 3, 1), (25, 3, 2),
                       (7, 1, 2), (6, 3, 1)):
        x = t(2, 3, rows, 5)
        w = t(4, 3, k, k)
        p = k // 2
        out = F.conv2d(x, w, stride=s, padding=p)
        cases.append({"x": x, "w": w, "stride": s, "padding": p,
                      "cot": t(*out.shape)})
    for rows, scale in ((2, 4), (3, 2), (25, 4)):
        x = t(2, 3, rows, 4)
        cases.append({"x": x, "scale": scale,
                      "cot": t(2, 3, rows * scale, 4 * scale)})
    return cases


@pytest.mark.parametrize("n_grid", [1, 2, 3, 4])
def test_halo_ops_match_the_unsharded_op(tmp_path, n_grid):
    """Each rank's output slab, input-gradient slab and weight-gradient
    part; the slabs concatenated in rank order and the weight parts summed
    give the unsharded op's output and gradients."""
    cases = _halo_cases(torch.Generator().manual_seed(n_grid))
    outs = run_ranks(tmp_path, n_grid, "halo", {"n": n_grid, "cases": cases})
    for i, case in enumerate(cases):
        x = case["x"].clone().requires_grad_()
        if "scale" in case:
            w = None
            y = F.interpolate(x, scale_factor=case["scale"], mode="bilinear",
                              align_corners=True)
        else:
            w = case["w"].clone().requires_grad_()
            y = F.conv2d(x, w, stride=case["stride"], padding=case["padding"])
        (y * case["cot"]).sum().backward()
        got = {k: torch.cat([o[i][k] for o in outs], dim=2)
               for k in ("y", "dx")}
        torch.testing.assert_close(got["y"], y.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["dx"], x.grad, rtol=1e-5, atol=1e-5)
        if w is not None:
            torch.testing.assert_close(sum(o[i]["dw"] for o in outs), w.grad,
                                       rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def grid_runs(setup, tmp_path_factory):
    """{mesh: the ranks' results} of the grid worker, run once a mesh;
    (1, 2) also steps on 2 samples, (2, 2) takes two steps with dropout
    on."""
    runs = {}
    val = _val_samples(np.random.default_rng(22), n=5)

    def run(mesh):
        if mesh not in runs:
            runs[mesh] = run_ranks(
                tmp_path_factory.mktemp("grid"), mesh[0] * mesh[1], "grid",
                _payload(setup, mesh=mesh, val=val, dropout=mesh == (2, 2),
                         half=(tuple(a[:2] for a in setup[2])
                               if mesh == (1, 2) else None)))
        return runs[mesh], val
    return run


MESHES = [(1, 2), (1, 4), (2, 2)]


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_predict_matches_unsharded_jax(setup, grid_runs, mesh):
    jm, variables, batch = setup
    want = np.asarray(jax.jit(lambda *a: jm.apply(variables, *a, train=False))(
        *(jnp.asarray(a) for a in batch[:6])))
    rows = 4 // mesh[0]
    for out in grid_runs(mesh)[0]:
        d = out["data_index"]
        np.testing.assert_allclose(out["logits"].numpy(),
                                   want[d * rows:(d + 1) * rows],
                                   rtol=1e-5, atol=1e-5)


def _jax_step(jm, variables, batch):
    """JAX's unsharded train step's gradients, loss, running stats and IoU
    counts on ``batch`` (dropout the identity)."""
    state = _jax_state(jm, variables)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        grads, loss, stats, _, inter, union = jax.jit(
            lambda s, b: _micro_grads(s, s.batch_stats, b,
                                      jax.random.PRNGKey(0), POS_WEIGHT))(
            state, tuple(map(jnp.asarray, batch)))
    return {"loss": float(loss), "intersect": float(inter),
            "union": float(union), "state_dict": _as_state_dict(grads, stats)}


def _port_step(setup, batch):
    """The port's single-device step on ``batch``, one thread."""
    p = _payload(setup)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build(p)
        state = create_train_state(model, weight_decay=0.0, max_grad_norm=0.0)
        m = make_train_step(model, POS_WEIGHT, device="cpu")(
            state, tensors(batch))
    finally:
        torch.set_num_threads(threads)
    grads = {k: q.grad.clone() for k, q in model.named_parameters()}
    return {"loss": m["loss"].item(), "intersect": m["intersect"].item(),
            "union": m["union"].item(), "grads": grads,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "state_dict": {**model.state_dict(), **grads}}


@pytest.fixture(scope="module")
def steps(setup):
    """{"jax", "port"} x {"whole", "half"}: the unsharded steps on the
    batch and on its first 2 samples."""
    jm, variables, batch = setup
    half = tuple(a[:2] for a in batch)
    return {(side, part): fn(b) for part, b in (("whole", batch), ("half", half))
            for side, fn in (("jax", lambda b: _jax_step(jm, variables, b)),
                             ("port", lambda b: _port_step(setup, b)))}


SPLIT_FLOOR = 1e-3  # the 4-sample batch's rounding floor (module note)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_train_step_matches_unsharded_jax(grid_runs, steps, mesh):
    """The grid step is the single-device step on the global batch:
    global-batch BN in the camera trunk and the BEV encoder, the global
    mean loss, the gradient summed over the ranks."""
    outs, _ = grid_runs(mesh)
    port, jax_ = steps["port", "whole"], steps["jax", "whole"]
    floor = _check_step(port, jax_, grad_tol=1e-2)
    for out in outs:
        split = _check_step(out["step"], port, grad_tol=SPLIT_FLOOR)
        total = _check_step(out["step"], jax_, grad_tol=floor + SPLIT_FLOOR)
    print(f"4 samples, gradients relative L2: the port's step vs JAX's "
          f"{floor:.2e}; the grid step at {mesh} vs the port's {split:.2e}, "
          f"vs JAX's {total:.2e}")
    for out in outs[1:]:
        for k, v in out["step"]["state"].items():
            assert torch.equal(v, outs[0]["step"]["state"][k]), k
        for k, g in out["step"]["grads"].items():
            assert torch.equal(g, outs[0]["step"]["grads"][k]), k


def test_grid_train_step_on_two_samples_at_pr8_limits(grid_runs, steps):
    """At (1, 2) on the batch's first 2 samples, one a lift rank: JAX's
    unsharded step and the port's, each to 1e-4."""
    outs, _ = grid_runs((1, 2))
    floor = _check_step(steps["port", "half"], steps["jax", "half"])
    for out in outs:
        total = _check_step(out["half_step"], steps["jax", "half"])
        split = _check_step(out["half_step"], steps["port", "half"])
    print(f"2 samples, gradients relative L2: the port's step vs JAX's "
          f"{floor:.2e}; the grid step at (1, 2) vs the port's {split:.2e}, "
          f"vs JAX's {total:.2e}")


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_validation_counts_each_sample_once(setup, grid_runs, mesh):
    """5 val samples, one a rank: the loaders pad to a multiple of the
    ranks, the mask drops the copies, the slabs' partial sums add up to
    JAX's loss and IoU over the whole set."""
    outs, val = grid_runs(mesh)
    jm, variables, _ = setup
    apply = jax.jit(lambda *a: jm.apply(variables, *a, train=False))
    total = {"loss_sum": 0.0, "intersect": 0.0, "union": 0.0}
    for s in val:
        logits = apply(*(jnp.asarray(a[None]) for a in s[:6]))
        m = masked_eval_metrics(logits, jnp.asarray(s[6][None]),
                                jnp.ones((1,)), POS_WEIGHT)
        for k in total:
            total[k] += float(m[k])
    for out in outs:
        assert out["val"]["loss"] == pytest.approx(total["loss_sum"] / 5,
                                                   rel=1e-5)
        assert out["val"]["iou"] == pytest.approx(
            total["intersect"] / total["union"], rel=1e-5)


def test_grid_replicas_stay_equal_with_dropout_on(grid_runs):
    """(2, 2), two steps with dropout and drop-connect on: each lift rank
    draws its own masks, the grid ranks of a data row one Dropout2d mask;
    the four replicas end bit-equal (each rank checked the digests)."""
    outs, _ = grid_runs((2, 2))
    assert len({out["digest"] for out in outs}) == 1


TINY = dict(nepochs=3, H=64, W=128, final_dim=(32, 64), xbound=(-50.0, 50.0, 6.25),
            ybound=(-50.0, 50.0, 6.25), dbound=(4.0, 36.0, 8.0), bsz=2,
            nworkers=1, iou_log_step=1, variant="slim", device="cpu")


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                            samples_per_scene=3, H=64, W=128, grid=16)


@pytest.mark.parametrize("kw,match", [
    ({"n_devices": 4, "cam_devices": 2}, "alternative model-parallel axes"),
    ({"n_devices": 2, "accum_steps": 2}, "accum_steps > 1 is not supported"),
    ({"n_devices": 2, "fused_dw": True}, "composes with data parallelism"),
    ({"n_devices": 3}, "n_devices=3 must be divisible by grid_devices=2"),
    ({"n_devices": 3, "grid_devices": 3}, "grid X dim 16 must be divisible"),
    ({"n_devices": 4, "bsz": 2}, "bsz=2 must be divisible by n_devices=4"),
])
def test_train_refuses_what_jax_refuses(fixture_root, tmp_path, monkeypatch,
                                        kw, match):
    """The JAX trainer's checks of the grid keywords
    (``lss_carla_tpu/training/loop.py:218-256``), before any rank starts
    (8 cores here, so no count is clamped)."""
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    with pytest.raises(ValueError, match=match):
        train(fixture_root, **{**TINY, "grid_devices": 2, **kw},
              logdir=str(tmp_path))


def test_train_cli_grid_devices(fixture_root, tmp_path):
    """``python -m lss_carla_torch.train --grid_devices 2 --n_devices 2``
    on the CPU: 2 gloo ranks, each loading and lifting its own row of the
    global batch of 2 and decoding half the grid; validation and the EMA's
    BN recalibration through the grid forward, figures from the grid
    predict, rank-0 checkpoints."""
    logdir = tmp_path / "run"
    assert main(["--dataroot", str(fixture_root), "--device", "cpu",
                 "--H", "64", "--W", "128", "--final_h", "32", "--final_w", "64",
                 "--xbound", "-50", "50", "6.25", "--ybound", "-50", "50", "6.25",
                 "--dbound", "4", "36", "8", "--bsz", "2", "--nworkers", "1",
                 "--max_steps", "4", "--val_step", "2",
                 "--save_step", "2", "--viz_step", "2", "--iou_log_step", "1",
                 "--ema_decay", "0.9", "--ema_bn_recal", "2",
                 "--grid_devices", "2", "--n_devices", "2",
                 "--logdir", str(logdir)]) == 0
    recs = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["step"] for r in recs if "val/iou" in r] == [2, 4]
    assert sorted(r["step"] for r in recs if "train/iou" in r) == [1, 2, 3, 4]
    assert all(np.isfinite(r[k]) for r in recs for k in r
               if k.startswith(("train/loss", "val/")))
    assert sorted(os.listdir(logdir / "ckpts")) == [
        "model_000002.pt", "model_000004.pt", "model_best.pt",
        "model_final.pt"]
    final = load_checkpoint(str(logdir / "ckpts" / "model_final.pt"))
    assert final["counter"] == 4 and "ema_state_dict" in final
