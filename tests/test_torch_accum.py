"""Gradient accumulation in the port against the JAX package on the CPU
(mirrors tests/test_accum.py): ``stack_microbatches``, and one accumulated
step of a slim LSS against ``accum_scan`` for the averaged gradients, the
loss, the IoU counts and the BN running stats threaded through both
microbatches.

The JAX model always draws dropout in train mode; both sides run here with
it off (flax's ``nn.Dropout`` patched to the identity for the test, the
port's dropout probabilities set to 0; the slim trunk has no drop-connect
on a residual branch), so the two compute the same function.

Tolerances: gradients that come back through train-mode BNs magnify f32
rounding (the batch-mean subtraction cancels), and this slim LSS with
random weights and BN has logits in the hundreds. Over seeds 5-7 the
gradients of all parameters together miss JAX's by 4e-5 to 1.6e-2
relative (L2) for one plain step and 1.5e-3 to 4.8e-3 accumulated; a
semantic slip (gradients summed, not averaged) misses by 0.5. So all the
gradients together are held to 5e-2, and the BEV head's (after the last
BN) to 1e-3 relative; the loss to 1e-5 relative; running stats to 1e-5
relative and absolute (batch means of activations near 1, two updates);
the IoU counts exactly."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from lss_carla_tpu.data.loader import stack_microbatches as jax_stack
from lss_carla_tpu.models.lss import compile_model as jax_compile_model
from lss_carla_tpu.training import state as JState
from lss_carla_tpu.training.step import accum_scan

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.loader import stack_microbatches
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils import convert as C

from test_torch_lss import rig
from test_torch_variants import random_variables
from util import tiny_aug, tiny_batch, tiny_grid


def test_stack_microbatches_shapes_and_ragged_tail():
    rng = np.random.default_rng(0)
    batches = [tiny_batch(rng, B=2) for _ in range(5)]
    out = list(stack_microbatches(iter(batches), 2))
    want = list(jax_stack(iter(batches), 2))
    assert len(out) == len(want) == 2  # 5 batches -> 2 stacks, tail dropped
    for got_b, want_b in zip(out, want):
        for g, w in zip(got_b, want_b):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert out[0][0].shape == (2,) + batches[0][0].shape
    np.testing.assert_array_equal(out[1][6][1], batches[3][6])
    same = list(stack_microbatches(iter(batches), 1))
    assert len(same) == 5 and same[0] is batches[0]


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _microbatches(rng, A=2, B=2, N=6):
    out = []
    for _ in range(A):
        imgs = rng.normal(size=(B, N, 3, 32, 64)).astype(np.float32)
        binimgs = (rng.uniform(size=(B, 1, 16, 16)) < 0.2).astype(np.float32)
        out.append((imgs, *rig(rng, B, N, (32, 64)), binimgs))
    return out


def _port(variables, fused_dw):
    model = compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                          DataAugConf.from_dict(tiny_aug().to_dict()),
                          variant="slim", fused_dw=fused_dw, device="cpu")
    model.load_state_dict(C.jax_variables_to_state_dict(variables, "slim"))
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


@pytest.mark.parametrize("fused_dw", [False, True])
def test_accum_matches_jax_accum_scan(no_dropout, fused_dw):
    rng = np.random.default_rng(5)
    mbs = _microbatches(rng)
    stacked = tuple(np.stack(parts) for parts in zip(*mbs))
    jm = jax_compile_model(tiny_grid(), tiny_aug(), outC=1, variant="slim")
    variables = random_variables(jm, tuple(map(jnp.asarray, mbs[0][:6])), rng)
    jstate = JState.TrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=optax.identity(),
        batch_stats=variables["batch_stats"])
    grads, loss, new_bs, inter, union = jax.jit(
        lambda s, b: accum_scan(s, b, jax.random.PRNGKey(0), 2.13, 2))(
        jstate, tuple(map(jnp.asarray, stacked)))

    model = _port(variables, fused_dw)
    # no clip and no weight decay: the .grad left after the step is the
    # averaged gradient itself
    state = create_train_state(model, weight_decay=0.0, max_grad_norm=0.0)
    metrics = make_train_step(model, 2.13, accum_steps=2, device="cpu")(
        state, tuple(map(torch.from_numpy, stacked)))
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=1e-5)
    assert metrics["intersect"].item() == float(inter)
    assert metrics["union"].item() == float(union)

    names = C.name_map("slim")
    want = C.variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new_bs)}, names)
    params = dict(model.named_parameters())
    miss = {k: (np.linalg.norm(p.grad.numpy() - want[k].numpy()),
                np.linalg.norm(want[k].numpy())) for k, p in params.items()}
    total = np.sqrt(sum(d * d for d, _ in miss.values())
                    / sum(r * r for _, r in miss.values()))
    assert total <= 5e-2, total
    for k in ("bevencode.up2.4.weight", "bevencode.up2.4.bias"):
        assert miss[k][0] <= 1e-3 * miss[k][1], (k, miss[k])
    sd = model.state_dict()
    for k in names:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_accum_step_is_one_update_of_the_averaged_gradient():
    """Two identical microbatches (dropout off) accumulate to that batch's
    own gradient, and the step is one Adam update: every parameter's
    optimizer state has seen one step, and the parameters equal a plain
    step's on the single batch."""
    rng = np.random.default_rng(6)
    mb = _microbatches(rng, A=1)[0]
    twice = tuple(np.stack([a, a]) for a in mb)
    grid, aug = (GridConf.from_dict(tiny_grid().to_dict()),
                 DataAugConf.from_dict(tiny_aug().to_dict()))
    models = []
    for accum, batch in ((2, twice), (1, mb)):
        model = compile_model(grid, aug, variant="slim", device="cpu",
                              generator=torch.Generator().manual_seed(2))
        for m in model.modules():
            if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
                m.p = 0.0
        state = create_train_state(model)
        make_train_step(model, accum_steps=accum, device="cpu")(
            state, tuple(map(torch.from_numpy, batch)))
        assert state.step == 1
        assert all(int(s["step"]) == 1 for s in
                   state.optimizer.adam.state.values())
        models.append(model)
    for (k, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=k)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(models[0], accum_steps=3, device="cpu")(
            create_train_state(models[0]), tuple(map(torch.from_numpy, twice)))
