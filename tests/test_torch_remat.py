"""Activation rematerialisation (``compile_model(remat=True)``,
``models/layers.py::remat``) on the CPU.

- Remat on against off, one train step of the slim LSS at the tiny config
  with the same weights and batch: every gradient, the loss and every
  running stat within 1e-6 (relative and absolute; the recompute runs the
  same ops on the same inputs), and each BN's ``num_batches_tracked`` 1:
  the recompute updates no running stat, the fused ``bn1`` through the
  depthwise op included. With dropout off, and with dropout on inside an
  ``RngStream`` (the data-parallel steps' draws), whose state the backward
  runs outside of: the recompute draws the forward's masks. Without and
  with ``fused_dw``.
- Remat leaves an eval forward, and a train forward without gradients
  (the recalibration's), as they were: no checkpoint, one update.
- JAX's ``remat=True`` step against the port's on 2 samples of 64 x 128
  images (``tests/test_torch_parallel.py``'s batch): loss 1e-5 relative,
  gradients 1e-4 relative (L2), running stats 1e-5, with flax's
  ``nn.Dropout`` patched to the identity and the port's dropout at 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from lss_carla_tpu.training.step import _micro_grads

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.layers import BatchNorm2d
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.parallel.step import RngStream
from lss_carla_torch.training.bn_recal import recalibrate_bn
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step

from test_torch_lss import rig
from test_torch_parallel import (POS_WEIGHT, _as_state_dict, _check_step,
                                 _jax_state, _payload, setup)
from torch_parallel_ranks import build, tensors
from util import tiny_aug, tiny_grid

assert setup  # the module-scoped fixture, shared with this module


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(B, 6, 3, 32, 64)).astype(np.float32)
    binimgs = (rng.uniform(size=(B, 1, 16, 16)) < 0.2).astype(np.float32)
    return tensors((imgs, *rig(rng, B, 6, (32, 64)), binimgs))


def _step(remat, fused_dw, dropout, batch):
    model = compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                          DataAugConf.from_dict(tiny_aug().to_dict()),
                          variant="slim", fused_dw=fused_dw, remat=remat,
                          device="cpu",
                          generator=torch.Generator().manual_seed(3))
    if not dropout:
        for m in model.modules():
            if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
                m.p = 0.0
    stream = RngStream(17, "cpu")

    def forward(*inputs):
        with stream:
            return model(*inputs)

    state = create_train_state(model, weight_decay=0.0, max_grad_norm=0.0)
    m = make_train_step(model, 2.13, device="cpu", forward=forward)(state,
                                                                     batch)
    return model, m


@pytest.mark.parametrize("fused_dw", [False, True])
@pytest.mark.parametrize("dropout", [False, True])
def test_remat_step_equals_the_plain_step(monkeypatch, fused_dw, dropout):
    """Remat runs the encoders' BNs again in the backward (more train-mode
    BN forwards than the plain step), and changes nothing."""
    calls = []
    forward = BatchNorm2d.forward
    monkeypatch.setattr(BatchNorm2d, "forward",
                        lambda self, x: calls.append(1) or forward(self, x))
    batch = _batch(1)
    plain, m0 = _step(False, fused_dw, dropout, batch)
    n_plain = len(calls)
    remat, m1 = _step(True, fused_dw, dropout, batch)
    assert len(calls) - n_plain > n_plain
    assert remat.remat and remat.config()["remat"] is True
    np.testing.assert_allclose(m1["loss"].item(), m0["loss"].item(),
                               rtol=1e-6, atol=1e-6)
    for (k, q0), (_, q1) in zip(plain.named_parameters(),
                                remat.named_parameters()):
        torch.testing.assert_close(q1.grad, q0.grad, rtol=1e-6, atol=1e-6,
                                   msg=k)
    for k, v in plain.state_dict().items():
        torch.testing.assert_close(remat.state_dict()[k], v, rtol=1e-6,
                                   atol=1e-6, msg=k)
    counts = {m.num_batches_tracked.item() for m in remat.modules()
              if isinstance(m, BatchNorm2d)}
    assert counts == {1}


def test_remat_stays_idle_without_a_backward():
    """An eval forward gives the plain model's logits; a no-grad train
    forward (the EMA recalibration's) records one moment a BN."""
    batch = _batch(2)
    plain, remat = (compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                                  DataAugConf.from_dict(tiny_aug().to_dict()),
                                  variant="slim", remat=r, device="cpu")
                    for r in (False, True))
    with torch.no_grad():
        torch.testing.assert_close(remat.eval()(*batch[:6]),
                                   plain.eval()(*batch[:6]), rtol=0, atol=0)
    torch.manual_seed(0)
    assert recalibrate_bn(remat, [batch]) == 1
    torch.manual_seed(0)
    recalibrate_bn(plain, [batch])
    for k, v in plain.state_dict().items():
        torch.testing.assert_close(remat.state_dict()[k], v, rtol=0, atol=0,
                                   msg=k)


def test_remat_step_matches_jax_remat(setup):
    """JAX's ``remat=True`` model (``nn.remat`` around both encoders) and
    the port's, one train step on the first 2 samples."""
    jm, variables, batch = setup
    batch = tuple(a[:2] for a in batch)
    jm = jm.clone(remat=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        grads, loss, stats, _, inter, union = jax.jit(
            lambda s, b: _micro_grads(s, s.batch_stats, b,
                                      jax.random.PRNGKey(0), POS_WEIGHT))(
            _jax_state(jm, variables), tuple(map(jnp.asarray, batch)))
    want = {"loss": float(loss), "intersect": float(inter),
            "union": float(union), "state_dict": _as_state_dict(grads, stats)}
    model = build(_payload(setup))
    model.remat = True
    state = create_train_state(model, weight_decay=0.0, max_grad_norm=0.0)
    m = make_train_step(model, POS_WEIGHT, device="cpu")(state,
                                                         tensors(batch))
    _check_step({"loss": m["loss"].item(), "intersect": m["intersect"].item(),
                 "union": m["union"].item(),
                 "grads": {k: q.grad for k, q in model.named_parameters()},
                 "state": model.state_dict()}, want)
