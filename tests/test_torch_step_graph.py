"""What the CUDA graph of the train step (``training/step.py``) rests on,
on the CPU: the learning rate and EMA decay as device scalars against the
host floats, the ``pos_weight`` tensor made once, the forward's constants
as the model's buffers, the conditions that keep the step eager, what a capture
holds, the launch counters' arithmetic, and that the CPU step never
captures. The graph itself runs only on a card
(``tests/test_torch_cuda_graph.py``)."""

import copy
import sys

import numpy as np
import pytest
import torch
import torch.optim.adam  # noqa: F401  (sys.modules below)

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import mbconv_cuda, splat_cuda
from lss_carla_torch.ops import splat as Sg
from lss_carla_torch.ops.image import (IMAGENET_MEAN, IMAGENET_STD, imagenet_stats,
                                       normalize_uint8)
from lss_carla_torch.training import state as St
from lss_carla_torch.training import step as Sp
from lss_carla_torch.training.loss import bce_with_logits
from lss_carla_torch.utils import graph as Gr
from lss_carla_torch.utils import trace

from test_torch_lss import rig

# the optimizer's parity tolerance (tests/test_torch_training.py) and the
# EMA's (tests/test_torch_ema.py)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
EMA_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def on_card(monkeypatch):
    """The optimizer as it is built on a card (a 0-d tensor learning rate,
    Adam ``capturable`` with its step counts beside the parameters, the
    foreach update), here on CPU tensors: torch keeps capturable Adam to
    accelerators, and its tensor arithmetic is the same on the CPU."""
    monkeypatch.setattr(sys.modules["torch.optim.adam"], "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cpu", "cuda"])

    def build(params, **kw):
        with monkeypatch.context() as m:
            m.setattr(St, "_capturable", lambda params: True)
            opt = St.make_optimizer(params, **kw)
        for group in opt.adam.param_groups:
            group["foreach"] = True
        return opt
    return build


def _params(seed, shapes=((4, 3), (5,), (2, 2, 3))):
    rng = np.random.default_rng(seed)
    return [torch.nn.Parameter(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
            for s in shapes]


SCHEDULES = [("constant", 0), ("constant", 3), ("cosine", 0), ("cosine", 3),
             ("linear", 0), ("linear", 3)]


@pytest.mark.parametrize("schedule,warmup", SCHEDULES)
def test_device_scalars_match_host_floats(on_card, schedule, warmup):
    """Ten updates of the same gradients and the EMA after each, as the
    eager step takes them (host float learning rate and decay) and as a
    replay takes them (``set_lr`` into the 0-d tensor, the decay written
    into a 0-d tensor, ``update``): parameters, both moments, the EMA and
    the norms within the optimizer's and the EMA's parity tolerances."""
    kw = dict(lr=1e-2, weight_decay=1e-7, max_grad_norm=5.0,
              lr_schedule=schedule, warmup_steps=warmup, decay_steps=12)
    host_p, dev_p = _params(0), _params(0)
    host = St.make_optimizer(host_p, **kw)
    dev = on_card(dev_p, **kw)
    assert not host.capturable and isinstance(host.lr, float)
    assert dev.capturable and torch.is_tensor(dev.lr)
    assert all(g["lr"] is dev.lr and g["capturable"] for g in dev.adam.param_groups)
    decay = 0.9
    host_ema = [p.detach().clone() for p in host_p]
    dev_ema = [p.detach().clone() for p in dev_p]
    d = torch.zeros(())
    rng = np.random.default_rng(1)
    for count in range(10):
        grads = [torch.from_numpy((4.0 * rng.normal(size=p.shape)).astype(np.float32))
                 for p in host_p]
        for p, q, g in zip(host_p, dev_p, grads):
            p.grad, q.grad = g.clone(), g.clone()
        n_host = host.step(count)
        dev.set_lr(count)
        assert dev.lr.item() == np.float32(dev.schedule(count))
        assert dev.last_lr == host.last_lr == dev.schedule(count)
        n_dev = dev.update()
        torch.testing.assert_close(n_dev, n_host, **OPT_TOL)
        # the EMA as ema_update runs it: t is the count after this update
        dh = St.ema_decay_at(decay, count + 1)
        torch._foreach_mul_(host_ema, dh)
        torch._foreach_add_(host_ema, [p.detach() for p in host_p], alpha=1.0 - dh)
        d.fill_(St.ema_decay_at(decay, count + 1))
        torch._foreach_mul_(dev_ema, d)
        torch._foreach_add_(dev_ema, torch._foreach_mul([p.detach() for p in dev_p], 1.0 - d))
    for p, q in zip(host_p, dev_p):
        torch.testing.assert_close(q, p, **OPT_TOL)
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(dev.adam.state[q][key], host.adam.state[p][key],
                                       **OPT_TOL)
        assert dev.adam.state[q]["step"].item() == host.adam.state[p]["step"].item() == 10
    for a, b in zip(dev_ema, host_ema):
        torch.testing.assert_close(a, b, **EMA_TOL)


def _tiny_state(ema_decay=0.0, seed=0, **kw):
    grid = GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                    zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 36.0, 8.0))
    aug = DataAugConf(H=64, W=128, final_dim=(32, 64))
    model = compile_model(grid, aug, variant="slim", device="cpu",
                          generator=torch.Generator().manual_seed(seed), **kw)
    return model, St.create_train_state(model, lr=1e-2, ema_decay=ema_decay,
                                        lr_schedule="cosine", warmup_steps=2,
                                        decay_steps=10)


def _batch(rng, B=2, N=6):
    imgs = rng.integers(0, 256, (B, N, 3, 32, 64), dtype=np.uint8)
    binimgs = (rng.uniform(size=(B, 1, 16, 16)) < 0.2).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (imgs, *rig(rng, B, N, (32, 64)), binimgs))


@pytest.mark.parametrize("ema", [0.5, 0.999])
def test_ema_update_from_a_device_scalar(ema):
    """``ema_update`` with the decay as a 0-d tensor (the replay's) against
    the host float, over ten EMA steps of a moving model (the ramp's
    first steps, and 0.5 past it): within the EMA's parity tolerance."""
    model, host = _tiny_state(ema_decay=ema)
    _, dev = _tiny_state(ema_decay=ema)
    dev.model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(3)
    d = torch.zeros(())
    for t in range(1, 11):
        with torch.no_grad():
            for p, q in zip(St.averaged_tensors(host.model), St.averaged_tensors(dev.model)):
                step = torch.randn(p.shape, generator=gen)
                p.add_(step)
                q.add_(step)
        host.step = dev.step = t
        St.ema_update(host, ema)
        d.fill_(St.ema_decay_at(ema, t))
        St.ema_update(dev, ema, d)
    for a, b in zip(St.averaged_tensors(dev.ema_model), St.averaged_tensors(host.ema_model)):
        torch.testing.assert_close(a, b, **EMA_TOL)


@pytest.mark.parametrize("pos_weight", [2.13, (1.0, 2.5, 0.5)])
def test_pos_weight_tensor_made_once_leaves_the_loss_bit_equal(pos_weight):
    """The step's ``pos_weight``, one f32 tensor made with the step, gives
    the loss bit for bit as the Python number (or tuple) did."""
    rng = np.random.default_rng(4)
    C = 1 if np.ndim(pos_weight) == 0 else len(pos_weight)
    logits = torch.from_numpy((3 * rng.normal(size=(2, C, 8, 8))).astype(np.float32))
    targets = torch.from_numpy((rng.uniform(size=(2, C, 8, 8)) < 0.3).astype(np.float32))
    once = torch.as_tensor(pos_weight, dtype=torch.float32, device="cpu")
    assert torch.equal(bce_with_logits(logits, targets, once),
                       bce_with_logits(logits, targets, pos_weight))
    assert torch.equal(bce_with_logits(logits.bfloat16(), targets, once),
                       bce_with_logits(logits.bfloat16(), targets, pos_weight))


def test_forward_constants_are_buffers_of_the_model():
    """The forward's host constants (the grid's dx and bx, ImageNet's mean
    and std) are buffers of the model, out of its state dict, on its
    device; the forward with them is the forward with the host arrays, bit
    for bit."""
    model, _ = _tiny_state()
    buffers = dict(model.named_buffers())
    for name, want in (("grid_dx", model.dx), ("grid_bx", model.bx),
                       ("img_mean", IMAGENET_MEAN), ("img_std", IMAGENET_STD)):
        assert buffers[name].dtype == torch.float32
        assert np.array_equal(buffers[name].numpy().ravel(), want), name
        assert name not in model.state_dict()
    assert model.to(torch.device("meta")).img_mean.device.type == "meta"
    x = torch.randint(0, 256, (2, 3, 4, 5), dtype=torch.uint8)
    mean, std = imagenet_stats()
    want = (x.float() / 255.0 - torch.from_numpy(IMAGENET_MEAN).view(3, 1, 1)) \
        / torch.from_numpy(IMAGENET_STD).view(3, 1, 1)
    assert torch.equal(normalize_uint8(x, mean, std), want)
    assert torch.equal(normalize_uint8(x), want)
    rng = np.random.default_rng(2)
    geom = torch.from_numpy(rng.uniform(-45, 45, size=(2, 50, 3)).astype(np.float32))
    model, _ = _tiny_state()
    for got, want in zip(Sg.voxel_indices(geom, model.grid_dx, model.grid_bx, model.nx),
                         Sg.voxel_indices(geom, model.dx, model.bx, model.nx)):
        assert torch.equal(got, want)


def test_cpu_step_never_captures():
    """On the CPU the step has no graph: under a profiler its spans count
    every step and no capture or replay."""
    from torch.profiler import ProfilerActivity, profile
    model, state = _tiny_state()
    step = Sp.make_train_step(model, device="cpu")
    assert step.graph is None
    rng = np.random.default_rng(5)
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                step(state, _batch(rng))
        t = trace.table()
    finally:
        trace.reset()
    assert t["lss.step"][0] == 2
    assert t.get("lss.step.capture", (0, 0.0))[0] == 0
    assert t.get("lss.step.replay", (0, 0.0))[0] == 0


def test_what_keeps_the_step_eager():
    """A forward, forward-pre or backward hook on any module, or a global
    one, is seen; so is remat; a removed hook is not."""
    model, _ = _tiny_state()
    graph = Sp._StepGraph(model, None, None, 0.0, torch.device("cpu"))
    assert graph.engages()
    leaf = model.bevencode.up1
    for register in (leaf.register_forward_hook, leaf.register_forward_pre_hook,
                     leaf.register_full_backward_hook):
        handle = register(lambda *a: None)
        assert not graph.engages()
        handle.remove()
        assert graph.engages()
    handle = torch.nn.modules.module.register_module_forward_hook(lambda *a: None)
    try:
        assert not graph.engages()
    finally:
        handle.remove()
    assert graph.engages()
    remat, _ = _tiny_state(remat=True)
    assert not Sp._StepGraph(remat, None, None, 0.0, torch.device("cpu")).engages()


def test_what_a_capture_holds_changes_only_on_a_rebinding():
    """``_bound``: the same objects after an eager step (in place), others
    after ``restore_train_state`` (Adam's new moment tensors), with the
    learning rate still the optimizer's own."""
    model, state = _tiny_state(ema_decay=0.999)
    step = Sp.make_train_step(model, ema_decay=0.999, device="cpu")
    rng = np.random.default_rng(6)
    step(state, _batch(rng))
    held = Sp._bound(model, state)
    step(state, _batch(rng))
    now = Sp._bound(model, state)
    assert len(now) == len(held) and all(a is b for a, b in zip(now, held))
    ckpt = {"model_state_dict": model.state_dict(),
            "optimizer_state_dict": state.optimizer.state_dict(),
            "counter": state.step, "ema_state_dict": state.ema_model.state_dict()}
    assert isinstance(ckpt["optimizer_state_dict"]["param_groups"][0]["lr"], float)
    St.restore_train_state(state, ckpt)
    now = Sp._bound(model, state)
    assert len(now) == len(held) and not all(a is b for a, b in zip(now, held))
    assert all(g["lr"] is state.optimizer.lr for g in state.optimizer.adam.param_groups)


def test_restore_into_the_card_optimizer_continues_the_run(on_card):
    """A checkpoint's optimizer state loaded into the device-scalar
    optimizer (as ``restore_train_state`` does after a CPU or a card
    run) keeps the bound learning rate and capturable step counts, and
    the next updates equal the uninterrupted run's."""
    kw = dict(lr=1e-2, lr_schedule="linear", warmup_steps=2, decay_steps=9)
    a_p, b_p = _params(7), _params(7)
    a = on_card(a_p, **kw)
    rng = np.random.default_rng(8)
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
              for p in a_p] for _ in range(5)]
    for count in range(3):
        for p, g in zip(a_p, grads[count]):
            p.grad = g.clone()
        a.step(count)
    saved = copy.deepcopy(a.state_dict())      # as a checkpoint file holds it
    assert saved["param_groups"][0]["lr"] == a.schedule(2)
    with torch.no_grad():
        for p, q in zip(a_p, b_p):
            q.copy_(p)
    b = on_card(b_p, **kw)
    host = St.make_optimizer(_params(9), **kw)    # a CPU run's state loads too
    host.load_state_dict(copy.deepcopy(saved))
    assert not host.adam.param_groups[0]["capturable"] and host.lr == a.schedule(2)
    b.load_state_dict(saved)
    assert all(g["lr"] is b.lr and g["capturable"] for g in b.adam.param_groups)
    for count in range(3, 5):
        for p, q, g in zip(a_p, b_p, grads[count]):
            p.grad, q.grad = g.clone(), g.clone()
        a.step(count)
        b.step(count)
    for p, q in zip(a_p, b_p):
        torch.testing.assert_close(q, p, rtol=0, atol=0)


def test_a_replay_adds_the_launches_it_holds(monkeypatch):
    """A wrapper's call under a stream capture counts as recorded, not
    launched; what a capture recorded (``held``) each replay adds to
    ``replayed``, and the wrappers' own counters stay as they launched."""
    for m in (splat_cuda, mbconv_cuda):
        monkeypatch.setattr(m, "launches", 5)
        monkeypatch.setattr(m, "launches_by_dtype", {"float32": 2, "bfloat16": 3})
        monkeypatch.setattr(m, "captured_by_dtype", {"float32": 0, "bfloat16": 0})
    monkeypatch.setattr(Gr, "replayed", {name: {"float32": 0, "bfloat16": 0}
                                         for name in Gr._COUNTED})
    before = Gr._captured()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    splat_cuda._count(torch.bfloat16)
    for _ in range(32):
        mbconv_cuda._count(torch.bfloat16)
    held = {name: {k: v - before[name][k] for k, v in by.items()}
            for name, by in Gr._captured().items()}
    assert held == {"splat": {"float32": 0, "bfloat16": 1},
                    "dw_conv_stats": {"float32": 0, "bfloat16": 32}}
    assert splat_cuda.launches == mbconv_cuda.launches == 5
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    splat_cuda._count(torch.float32)
    assert splat_cuda.launches == 6
    assert splat_cuda.launches_by_dtype == {"float32": 3, "bfloat16": 3}
    for _ in range(3):
        Gr._count_replay(held)
    assert Gr.replayed == {"splat": {"float32": 0, "bfloat16": 3},
                           "dw_conv_stats": {"float32": 0, "bfloat16": 96}}
    assert mbconv_cuda.launches == 5 and mbconv_cuda.launches_by_dtype["bfloat16"] == 3
    Gr.reset_replayed()
    assert all(v == 0 for by in Gr.replayed.values() for v in by.values())
    splat_cuda.reset_launches()
    assert splat_cuda.launches == 0
    assert set(splat_cuda.captured_by_dtype.values()) == {0}
