"""The train step's CUDA graph (``training/step.py::_StepGraph``) on the
card, against the eager step from the same weights, on the same batches,
with the same seeds: B0 in bf16 (bsz 2, one microbatch, cosine warm-up)
and B4 at a small grid (bf16, two microbatches, EMA 0.999, ``fused_dw``),
and both at the shapes, batch sizes and recipes of the benchmark's
training cells (``b0-fast-train``: B0 bf16 bsz 8 at 200 x 200;
``stretch-train``: B4 bf16 bsz 4 x 2 microbatches at 400 x 400, EMA,
``fused_dw``). Also planted faults of a replay that the check must
catch, a restore between steps (a capture again), the cases that stay
eager, the launch counts, the profiler's view of a replay, and the card's
optimizer against the host-float one. They need a GPU and nvcc; without a
GPU they skip. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -m gpu
"""

import copy

import numpy as np
import pytest
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.efficientnet import block_plan
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import mbconv_cuda, splat_cuda
from lss_carla_torch.training import state as St
from lss_carla_torch.training import step as Sp
from lss_carla_torch.training.state import (averaged_tensors, create_train_state,
                                            ema_decay_at, ema_update, make_optimizer,
                                            restore_train_state)
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils import graph as Gr

pytestmark = pytest.mark.gpu

STEPS = 6
# bf16 rounding (the card tests' bf16 tolerance, rtol 2^-7), relative to
# the norm of what is compared. Two eager steps from one state with the
# same draws differ by more than that in the gradients, and so in the
# update and Adam's moments (1-4 % on an H100: PyTorch's backward sums
# some gradients with atomics), so those are held to the eager step's own
# spread instead
REL = 2.0 ** -7
EXACT = ("loss", "intersect", "union", "bn")     # the forward's, deterministic
# the graph's update against the eager update of the graph's own gradients
# (the same kernels on the same tensors: no atomics there); a learning
# rate or an EMA decay one step off moves it by 4 % or more
GIVEN = 1e-3

SMALL = dict(final=(64, 128), image=(128, 256), dbound=(4.0, 36.0, 8.0),
             warmup=2, decay=20)
# the training cells' own (benchmark/configs, benchmark/workloads)
CELL = dict(final=(128, 352), image=(224, 480), dbound=(4.0, 45.0, 1.0), warmup=500)
CONFIGS = {
    "b0": dict(SMALL, variant="b0", outC=1, fused_dw=False, bsz=2, accum=1, ema=0.0,
               cells=(-40.0, 40.0, 5.0)),
    "b4": dict(SMALL, variant="b4", outC=4, fused_dw=True, bsz=2, accum=2, ema=0.999,
               cells=(-16.0, 16.0, 1.0)),
    "b0-fast-train": dict(CELL, variant="b0", outC=1, fused_dw=False, bsz=8, accum=1,
                          ema=0.0, cells=(-50.0, 50.0, 0.5), decay=4000),
    "stretch-train": dict(CELL, variant="b4", outC=4, fused_dw=True, bsz=4, accum=2,
                          ema=0.999, cells=(-50.0, 50.0, 0.25), decay=30000),
}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the graph and the kernels run only there)")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


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


def batches(cfg, n, seed, device):
    """``n`` changing batches (uint8 images), with the leading microbatch
    axis where ``accum`` > 1; on ``device`` (the CPU: copied in by the
    step)."""
    rng = np.random.default_rng(seed)
    A, B, N = cfg["accum"], cfg["bsz"], 6
    X = int(2 * cfg["cells"][1] / cfg["cells"][2])
    out = []
    for _ in range(n):
        imgs = rng.integers(0, 256, (A * B, N, 3, *cfg["final"]), dtype=np.uint8)
        labels = (rng.uniform(size=(A * B, cfg["outC"], X, X)) < 0.1).astype(np.float32)
        arrays = (imgs, *rig(rng, A * B, N, cfg["final"]), labels)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
        if A > 1:
            batch = tuple(t.view(A, B, *t.shape[1:]) for t in batch)
        out.append(batch)
    return out


def build(cfg, device, **kw):
    lo, hi, res = cfg["cells"]
    grid = GridConf(xbound=(lo, hi, res), ybound=(lo, hi, res),
                    zbound=(-10.0, 10.0, 20.0), dbound=cfg["dbound"])
    aug = DataAugConf(H=cfg["image"][0], W=cfg["image"][1], final_dim=cfg["final"])
    model = compile_model(grid, aug, outC=cfg["outC"], variant=cfg["variant"],
                          fused_dw=cfg["fused_dw"], compute_dtype="bfloat16",
                          device=device, generator=torch.Generator().manual_seed(0), **kw)
    return model


def state_of(model, cfg):
    return create_train_state(model, lr=1e-3, lr_schedule="cosine",
                              warmup_steps=cfg["warmup"], decay_steps=cfg["decay"],
                              ema_decay=cfg["ema"])


def issued():
    """(splat, dw_conv_stats) kernels issued on the card so far: what the
    wrappers launched and what the step's graph replays launched."""
    return tuple(m.launches + sum(Gr.replayed[name].values())
                 for name, m in (("splat", splat_cuda), ("dw_conv_stats", mbconv_cuda)))


def run(step, state, feed, seed0):
    """Each step's metrics as floats, and the kernels the steps issued; the
    dropout draws seeded alike before each step."""
    s0, d0 = issued()
    out = []
    for i, batch in enumerate(feed):
        torch.manual_seed(seed0 + i)
        out.append({k: float(v) for k, v in step(state, batch).items()})
    torch.cuda.synchronize()
    s1, d1 = issued()
    return out, (s1 - s0, d1 - d0)


def tensors(state):
    """{kind: the state's tensors of that kind}, in a fixed order."""
    m, adam = state.model, state.optimizer.adam
    out = {"params": list(m.parameters()),
           "bn": [b for k, b in m.named_buffers() if k.endswith(("running_mean", "running_var"))],
           "exp_avg": [adam.state[p]["exp_avg"] for p in state.optimizer.params],
           "exp_avg_sq": [adam.state[p]["exp_avg_sq"] for p in state.optimizer.params]}
    if state.ema_model is not None:
        out["ema"] = averaged_tensors(state.ema_model)
    return out


def gap(a, b, before=None) -> float:
    """||a - b|| / ||b|| over a list of tensors; with ``before``, of the
    changes from it (one step's update)."""
    a = torch.cat([t.detach().float().flatten() for t in a])
    b = torch.cat([t.detach().float().flatten() for t in b])
    if before is not None:
        base = torch.cat([t.float().flatten() for t in before])
        a, b = a - base, b - base
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def sync(dst, src):
    """``src``'s values into ``dst``'s tensors, in place (what a captured
    graph holds stays bound): model, Adam's state, EMA, update count."""
    with torch.no_grad():
        pairs = list(zip(dst.model.state_dict().values(), src.model.state_dict().values()))
        if src.ema_model is not None:
            pairs += zip(dst.ema_model.state_dict().values(), src.ema_model.state_dict().values())
        for p, q in zip(dst.optimizer.params, src.optimizer.params):
            a, b = dst.optimizer.adam.state.get(p, {}), src.optimizer.adam.state.get(q, {})
            pairs += [(a[k], b[k]) for k in b if k in a]
        for a, b in pairs:
            a.copy_(b)
    dst.step = src.step


def update_of(state, grads, buffers, ema_decay):
    """The eager update of ``grads`` (a step's gradients) at ``state``, in
    place: clip and Adam at the schedule's learning rate for the update
    count, the count advanced, and with ``ema_decay`` the EMA at the decay
    of the new count written into a device scalar, as a replay writes it,
    over the model whose BN stats are ``buffers`` (the step's forward's)."""
    with torch.no_grad():
        for a, b in zip(state.model.buffers(), buffers):
            a.copy_(b)
    for p, g in zip(state.optimizer.params, grads):
        p.grad = g.clone()
    state.optimizer.step(state.step)
    state.step += 1
    if ema_decay > 0:
        d = torch.tensor(ema_decay_at(ema_decay, state.step), device=grads[0].device)
        ema_update(state, ema_decay, d)


def state_gaps(t, tw, before, ema0) -> dict:
    """The gaps of ``t`` from ``tw`` (``tensors``): the parameters' change
    from ``before``, Adam's moments, and the EMA's change from ``ema0``."""
    out = {"update": gap(t["params"], tw["params"], before),
           **{k: gap(t[k], tw[k]) for k in ("exp_avg", "exp_avg_sq")}}
    if ema0 is not None:
        out["ema"] = gap(t["ema"], tw["ema"], ema0)
    return out


def steps_against_eager(cfg, feed, seed0, paths, restore_at=None, ckpt=None):
    """Each step from one state: the graph state (and an eager twin, the
    floor, and the replica, below) set to the eager state's values, then
    one step each with the same dropout seed. Per step, the gaps against
    the eager step's of the metrics, of the update, of the gradients, of
    the EMA's change and of each other kind of state ("graph", "twin");
    and the gaps of the graph's update, moments and EMA change against
    the replica's eager update of the graph's own gradients ("given")."""
    (step_g, sg), (step_e, se), (step_t, st), sr = paths
    rows = []
    for i, batch in enumerate(feed):
        if i == restore_at:
            for state in (sg, se, st, sr):
                restore_train_state(state, copy.deepcopy(ckpt))
        for state in (sg, st, sr):
            sync(state, se)
        before = [p.detach().clone() for p in se.model.parameters()]
        ema0 = [t.clone() for t in averaged_tensors(se.ema_model)] if se.ema_model else None
        got = {}
        for key, step, state in (("graph", step_g, sg), ("eager", step_e, se),
                                 ("twin", step_t, st)):
            torch.manual_seed(seed0 + i)
            metrics = {k: float(v) for k, v in step(state, batch).items()}
            grads = [p.grad.detach().clone() for p in state.optimizer.params]
            got[key] = (metrics, {**tensors(state), "grads": grads})
        update_of(sr, got["graph"][1]["grads"], list(sg.model.buffers()), cfg["ema"])
        row = {key: {**state_gaps(got[key][1], got["eager"][1], before, ema0),
                     "grads": gap(got[key][1]["grads"], got["eager"][1]["grads"]),
                     "bn": gap(got[key][1]["bn"], got["eager"][1]["bn"]),
                     **{k: abs(v - got["eager"][0][k]) / max(abs(got["eager"][0][k]), 1e-3)
                        for k, v in got[key][0].items()}}
               for key in ("graph", "twin")}
        row["given"] = state_gaps(got["graph"][1], tensors(sr), before, ema0)
        rows.append(row)
    return rows


def check(rows):
    """The graph's step against the eager step: the forward's readings (the
    loss, the IoU counts, the BN running stats) bit for bit; over the
    steps, the gradients, the update, Adam's moments, the EMA's change and
    the other metrics within bf16 rounding or within three times the
    largest gap of a second eager step (the twin) from the same state with
    the same draws; and the graph's update of its own gradients (the
    parameters' change, the moments, the EMA's change) within ``GIVEN`` of
    the eager update of them, which a wrong learning rate or EMA in a
    replay moves whatever the gradients' noise."""
    for i, row in enumerate(rows):
        print(f"step {i}: graph {row['graph']}\n        twin  {row['twin']}"
              f"\n        given {row['given']}")
    for k in rows[0]["graph"]:
        g = max(r["graph"][k] for r in rows)
        t = max(r["twin"][k] for r in rows)
        if k in EXACT:
            assert g == t == 0.0, (k, g, t)
        else:
            assert g <= max(REL, 3 * t), (k, g, t)
    for k in rows[0]["given"]:
        g = max(r["given"][k] for r in rows)
        assert g <= GIVEN, ("given", k, g)


def paths_of(cfg, device):
    """A graph step, two eager ones (``forward`` given) and a replica state
    (no step), from the same weights."""
    mg = build(cfg, device)
    out = []
    for m in (mg, copy.deepcopy(mg), copy.deepcopy(mg)):
        kw = dict(pos_weight=2.13, accum_steps=cfg["accum"], ema_decay=cfg["ema"],
                  device=device, forward=None if m is mg else m)
        out.append((make_train_step(m, **kw), state_of(m, cfg)))
    return (*out, state_of(copy.deepcopy(mg), cfg))


def per_step(cfg):
    """(splat, dw_conv_stats) kernels of one train step of ``cfg``."""
    return (cfg["accum"], cfg["accum"] * len(block_plan(cfg["variant"]))
            if cfg["fused_dw"] else 0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_step_equals_the_eager_step(cuda, name):
    """Six steps on changing batches: one capture, five replays. Each step
    starts from the eager path's state and both take the same dropout
    draws; its metrics, gradients, update of the parameters, Adam's
    moments, the BN stats and the EMA as ``check`` holds them. The
    wrappers count the capture's eager step and the eager paths' launches,
    the capture's calls as recorded, and the replays add what the capture
    recorded, so the graph's path issues the eager path's kernels."""
    cfg = CONFIGS[name]
    paths = paths_of(cfg, cuda)
    (step_g, sg), (step_e, se) = paths[:2]
    assert step_e.graph is None
    # the B0 batches come from the host (the loader's), the B4 ones from the card
    feed = batches(cfg, STEPS, 1, "cpu" if cfg["variant"] == "b0" else cuda)
    n = dict(zip(("splat", "dw_conv_stats"), per_step(cfg)))
    launched = (splat_cuda.launches, mbconv_cuda.launches)
    captured = [sum(m.captured_by_dtype.values()) for m in (splat_cuda, mbconv_cuda)]
    replayed = [sum(Gr.replayed[k].values()) for k in n]
    rows = steps_against_eager(cfg, feed, 100, paths)
    assert (step_g.graph.captures, step_g.graph.replays) == (1, STEPS - 1)
    assert sg.step == se.step == STEPS
    assert {k: sum(v.values()) for k, v in step_g.graph.graph.held.items()} == n
    # the graph's first step and the two eager paths' steps launched; the
    # capture recorded one step; the replays issued the rest
    assert (splat_cuda.launches - launched[0], mbconv_cuda.launches - launched[1]) == \
        tuple((2 * STEPS + 1) * v for v in n.values())
    assert [sum(m.captured_by_dtype.values()) - c
            for m, c in zip((splat_cuda, mbconv_cuda), captured)] == list(n.values())
    assert [sum(Gr.replayed[k].values()) - r for k, r in zip(n, replayed)] == \
        [(STEPS - 1) * v for v in n.values()]
    _, launches_g = run(step_g, sg, feed[:2], 500)
    _, launches_e = run(step_e, se, feed[:2], 500)
    assert launches_g == launches_e == tuple(2 * v for v in n.values())
    check(rows)


def plant(monkeypatch, fault):
    """A fault of the replays alone (the capture's eager step, the eager
    paths and the replica stay sound): ``stale_lr``, the learning rate of
    the count before (a ``set_lr`` one step late); ``skipped_ema``, no EMA
    in the graph; ``late_ema_decay``, the EMA decay of the count before."""
    if fault == "stale_lr":
        set_lr = St.Optimizer.set_lr
        monkeypatch.setattr(St.Optimizer, "step",
                            lambda self, count: (set_lr(self, count), self.update())[1])
        monkeypatch.setattr(St.Optimizer, "set_lr",
                            lambda self, count: set_lr(self, max(count - 1, 0)))
    elif fault == "skipped_ema":
        monkeypatch.setattr(Sp, "ema_update", lambda state, decay, d=None:
                            None if d is not None else ema_update(state, decay))
    else:
        monkeypatch.setattr(Sp, "ema_decay_at", lambda decay, t: ema_decay_at(decay, t - 1))


@pytest.mark.parametrize("fault", ["stale_lr", "skipped_ema", "late_ema_decay"])
def test_a_wrong_replay_fails_the_check(cuda, monkeypatch, fault):
    """Each planted fault of a replay fails ``check`` on the small B4 (cosine
    warm-up and decay, two microbatches, EMA 0.999), by more than ten
    times ``GIVEN`` in the graph's update of its own gradients."""
    plant(monkeypatch, fault)
    cfg = CONFIGS["b4"]
    paths = paths_of(cfg, cuda)
    rows = steps_against_eager(cfg, batches(cfg, STEPS, 5, cuda), 600, paths)
    assert paths[0][0].graph.replays == STEPS - 1
    worst = {k: max(r["given"][k] for r in rows) for k in rows[0]["given"]}
    print(fault, "given", worst, "graph", {k: max(r["graph"][k] for r in rows)
                                           for k in worst},
          "3 x twin", {k: 3 * max(r["twin"][k] for r in rows) for k in worst})
    assert max(worst.values()) > 10 * GIVEN, worst
    with pytest.raises(AssertionError):
        check(rows)


def test_restore_between_steps_captures_again(cuda):
    """A ``restore_train_state`` before the fourth step (Adam's moments
    rebound) leads to a second capture, and every step still equals the
    eager path's. The checkpoint is a fifth run's, after two steps."""
    cfg = CONFIGS["b0"]
    paths = paths_of(cfg, cuda)
    (step_g, sg), (_, se) = paths[:2]
    feed = batches(cfg, STEPS, 2, cuda)
    mc = build(cfg, cuda)
    sc = state_of(mc, cfg)
    run(make_train_step(mc, device=cuda, forward=mc), sc, feed[:2], 200)
    ckpt = {"model_state_dict": {k: v.cpu() for k, v in mc.state_dict().items()},
            "optimizer_state_dict": copy.deepcopy(sc.optimizer.state_dict()),
            "counter": sc.step}
    rows = steps_against_eager(cfg, feed, 300, paths, restore_at=3, ckpt=ckpt)
    assert (step_g.graph.captures, step_g.graph.replays) == (2, STEPS - 2)
    assert sg.step == se.step == 2 + 3
    check(rows)


def test_what_stays_eager_never_captures(cuda):
    """A forward hook, ``forward``, ``reduce`` and remat: the step runs
    eagerly and captures nothing; once the hook is removed it captures."""
    cfg = dict(CONFIGS["b0"], variant="slim")
    feed = batches(cfg, 2, 3, cuda)
    model = build(cfg, cuda)
    state = state_of(model, cfg)
    step = make_train_step(model, device=cuda)
    handle = model.bevencode.register_forward_hook(lambda *a: None)
    run(step, state, feed, 400)
    assert step.graph.captures == 0
    handle.remove()
    run(step, state, feed, 400)
    assert (step.graph.captures, step.graph.replays) == (1, 1)
    for kw in (dict(forward=model), dict(reduce=lambda state, m: m)):
        assert make_train_step(model, device=cuda, **kw).graph is None
    remat = build(cfg, cuda, remat=True)
    step = make_train_step(remat, device=cuda)
    run(step, state_of(remat, cfg), feed, 400)
    assert step.graph.captures == 0


def test_profiler_sees_the_kernels_of_a_replay(cuda):
    """Under torch.profiler, replays show each kernel of the graph as a
    device activity of its own: the segment splat and ``dw_conv_stats``
    as often as the capture recorded them (``held``) a replay, which is
    what a replay adds to ``utils/graph.py::replayed``."""
    from torch.profiler import ProfilerActivity, profile
    cfg = CONFIGS["b4"]
    model = build(cfg, cuda)
    state = state_of(model, cfg)
    step = make_train_step(model, accum_steps=2, ema_decay=cfg["ema"], device=cuda)
    feed = batches(cfg, 3, 4, cuda)
    step(state, feed[0])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in feed[1:]:
            step(state, batch)
        torch.cuda.synchronize()
    assert step.graph.replays == 2
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    held = {k: sum(v.values()) for k, v in step.graph.graph.held.items()}
    assert held == dict(zip(("splat", "dw_conv_stats"), per_step(cfg))) == \
        {"splat": 2, "dw_conv_stats": 2 * 32}
    assert sum("splat_kernel" in n for n in names) == 2 * held["splat"]
    assert sum("dw_conv_stats_kernel" in n for n in names) == 2 * held["dw_conv_stats"]


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("cosine", 3),
                                             ("linear", 3)])
def test_card_optimizer_matches_the_host_float_one(cuda, schedule, warmup):
    """The card's optimizer (learning rate as a 0-d tensor there, Adam
    capturable) against the CPU's host-float one over ten updates of the
    same gradients: the optimizer's parity tolerance."""
    rng = np.random.default_rng(5)
    shapes = [(64, 3), (257,), (8, 4, 3, 3)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    host = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    card = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(cuda)) for a in init]
    kw = dict(lr=1e-2, lr_schedule=schedule, warmup_steps=warmup, decay_steps=12)
    oh, oc = make_optimizer(host, **kw), make_optimizer(card, **kw)
    assert oc.capturable and torch.is_tensor(oc.lr) and not oh.capturable
    for count in range(10):
        grads = [(4.0 * rng.normal(size=s)).astype(np.float32) for s in shapes]
        for p, q, g in zip(host, card, grads):
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g).to(cuda)
        torch.testing.assert_close(oc.step(count).cpu(), oh.step(count), rtol=1e-6, atol=1e-6)
    for p, q in zip(host, card):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=1e-6, atol=1e-6)
