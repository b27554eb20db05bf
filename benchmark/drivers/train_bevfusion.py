"""Training traffic for BEVFusion's camera-only map segmentation: the
port's step on ``BEVFusionSeg``, fed staged batches, timed over the
window, as ``drivers/train.py`` drives LSS.

Set-up builds the model (``models/bevfusion.py``) with weights the
benchmark made from the seed (``reference/bevfusion.py::make_weights``),
one train state (``create_train_state``, AdamW) and one step
(``make_train_step``, which takes the model's focal loss), and a staged
feed: step batches made from the seed on the card (uint8 images, the
frozen rig resized and cropped as the traffic says, labels of each class
at the traffic's occupancy), cycled. The run then goes as
``drivers/train.py`` says: three checked steps (read-only hooks record
each stochastic-depth draw, the logits, the loss's gradient by them and
the pooled BEV, so those steps run eagerly), the window, a traced part
where asked, one checked step after the window (hooked, so eager too),
then one more with no hook, which on the card the step's CUDA graph
replays as it replayed the window's (``replayed_step``), and the plain
reference (``reference/bevfusion.py``) in f32 with TF32 off following the
program from the same weights, batches and draws. The numbers compared
are ``compare.train_numbers``' and two of the replayed step
(``replay_numbers``). A traced run also reads how many attention windows
the traced steps computed (the port's counter, which counts a graph
replay as its capture recorded), the attention calls of a forward, and
the splat's least time of each call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, roofline
from benchmark.drivers.train import CHECK_STEPS, adam_moments, micro, step_gradient, traced_part
from benchmark.fixture import rig
from benchmark.harness import Cell, Run, boot_clock
from benchmark.reference import bevfusion as ref
from benchmark.reference.lss import full_f32, identity

# the end-to-end metrics this driver measures
METRICS = ("train_samples_per_s", "setup_s")


def build(cell: Cell, dev):
    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.models.bevfusion import BEVFusionSeg
    from lss_carla_torch.training.state import create_train_state
    from lss_carla_torch.training.step import make_train_step
    cfg, work, opt = cell.config, cell.work, cell.work["optimizer"]
    vt = cfg["vtransform"]
    grid = GridConf(**{k: tuple(vt[k]) for k in ("xbound", "ybound", "zbound", "dbound")})
    H, W = cfg["image_size"]
    aug = DataAugConf(H=H, W=W, final_dim=(H, W), Ncams=cfg["ncams"])
    with torch.device(dev):
        model = BEVFusionSeg(grid, aug, classes=len(cfg["head"]["classes"]),
                             camC=vt["out_channels"], downsample=cfg["feature_stride"],
                             output_scope=cfg["head"]["output_scope"],
                             drop_path_rate=cfg["swin"]["drop_path_rate"],
                             compute_dtype=work["compute_dtype"])
    model.to(dev).load_state_dict(ref.make_weights(cfg, cell.seed, dev))
    state = create_train_state(
        model, lr=opt["lr"], weight_decay=opt["weight_decay"],
        max_grad_norm=opt["max_grad_norm"], lr_schedule=opt["schedule"],
        warmup_steps=opt["warmup_steps"], decay_steps=opt["decay_steps"],
        ema_decay=work["ema_decay"], optimizer=opt["kind"])
    step = make_train_step(model, accum_steps=work["accum_steps"],
                           ema_decay=work["ema_decay"], device=dev)
    return model, state, step


def out_cells(cfg: dict):
    return [int(round((hi - lo) / step)) for lo, hi, step in cfg["head"]["output_scope"]]


def staged_feed(cell: Cell, dev):
    """Endless device batches cycled from ``batches`` made on the device:
    uint8 images, the frozen rig at the source image size with the
    traffic's resize and crop in ``post_rots``/``post_trans``, and labels
    of each class drawn at its occupancy."""
    t, cfg, work = cell.traffic, cell.config, cell.work
    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    rng = np.random.default_rng(cell.seed)
    A, B, N = work["accum_steps"], work["bsz"], cfg["ncams"]
    fH, fW = cfg["image_size"]
    X, Y = out_cells(cfg)
    occ = torch.tensor([t["occupancy"][c] for c in cfg["head"]["classes"]], device=dev)
    staged = []
    for _ in range(t["batches"]):
        imgs = torch.randint(0, 256, (A * B, N, 3, fH, fW), generator=gen, device=dev,
                             dtype=torch.uint8)
        rots, trans, intrins, post_rots, post_trans = rig(rng, A * B, N, tuple(t["source_image"]))
        post_rots[..., :2, :2] *= t["resize"]
        post_trans[..., 0], post_trans[..., 1] = -t["crop"][0], -t["crop"][1]
        cams = [torch.from_numpy(a).to(dev) for a in (rots, trans, intrins, post_rots, post_trans)]
        labels = (torch.rand((A * B, len(occ), X, Y), generator=gen, device=dev)
                  < occ[:, None, None]).float()
        batch = (imgs, *cams, labels)
        staged.append(tuple(x.view(A, B, *x.shape[1:]) for x in batch) if A > 1 else batch)

    def batches():
        i = 0
        while True:
            yield staged[i % len(staged)]
            i += 1
    return batches()


class Recorder:
    """Hooks on the port's model that, while ``on``, keep what a step's
    forward and backward produce (they read, never write): every
    stochastic-depth draw of a forward (each forward's per-sample keep
    masks in ``forwards``, by module name, the reference's names), its
    logits, the loss's gradient by the logits and the pooled BEV that the
    BEV downsample takes, each but the masks copied to the host."""

    def __init__(self, model):
        from lss_carla_torch.models.swin import DropPath
        self.on, self.forwards, self.current = False, [], {}
        self.logits, self.dlogits, self.bev = [], [], []
        self.handles = [m.register_forward_hook(self._draw(name))
                        for name, m in model.named_modules()
                        if isinstance(m, DropPath) and m.p > 0]
        self.handles.append(model.register_forward_hook(self._output))
        self.handles.append(model.vtransform.downsample.register_forward_pre_hook(self._bev))

    def _draw(self, name):
        def hook(module, inputs, output):
            if self.on:
                self.current[name] = (output != 0).flatten(1).any(-1)
        return hook

    def _output(self, module, inputs, output):
        if self.on:
            self.forwards.append(self.current)
            self.current = {}
            self.logits.append(output.detach().float().cpu())
            if output.requires_grad:
                output.register_hook(lambda g: self.dlogits.append(g.detach().float().cpu()))

    def _bev(self, module, inputs):
        if self.on:
            self.bev.append(inputs[0].detach().float().cpu())

    def step(self, accum: int, grad: dict) -> dict:
        return {"logits": self.logits[:accum], "dlogits": self.dlogits[:accum],
                "bev": self.bev[:accum], "grad": grad}

    def remove(self):
        for h in self.handles:
            h.remove()


# faults of the optimizer that ``plant_late`` sets once the checked steps
# have run, so that the window's capture and replays hold them
LATE_FAULTS = ("late_lr_frozen", "late_no_decay")


def plant(cell: Cell, state):
    """The check's own tests break the timed path underneath with
    ``cell.fault``, for the whole run: ``state_unchanged`` (the optimizer
    step updates nothing), ``half_batch`` (the forward runs on every row
    and the loss is over the first half of each microbatch's) or
    ``late_half_batch`` (the same from the fourth step on); ``LATE_FAULTS``
    are set by ``plant_late``. Returns a function that takes it out."""
    if cell.fault in LATE_FAULTS:
        return lambda: None
    if cell.fault == "state_unchanged":
        state.optimizer.step = lambda count: torch.zeros(())
    elif cell.fault in ("half_batch", "late_half_batch"):
        import lss_carla_torch.training.step as port_step
        whole, calls = port_step.sigmoid_focal_loss, 0
        late = CHECK_STEPS * cell.work["accum_steps"] if cell.fault == "late_half_batch" else 0

        def half(logits, targets):
            nonlocal calls
            calls += 1
            if calls <= late:
                return whole(logits, targets)
            n = logits.shape[0] // 2
            return whole(logits[:n], targets[:n])
        port_step.sigmoid_focal_loss = half
        return lambda: setattr(port_step, "sigmoid_focal_loss", whole)
    elif cell.fault is not None:
        raise ValueError(f"no fault {cell.fault!r} in training")
    return lambda: None


def plant_late(cell: Cell, state) -> None:
    """After the checked steps, before the window: ``late_lr_frozen`` (the
    learning rate stays the third step's: ``set_lr`` writes nothing) or
    ``late_no_decay`` (AdamW's weight decay 0): what a replay that reads a
    stale learning rate or skips the decay would do."""
    if cell.fault == "late_lr_frozen":
        state.optimizer.set_lr = lambda count: None
    elif cell.fault == "late_no_decay":
        for group in state.optimizer.adam.param_groups:
            group["weight_decay"] = 0.0


def after_window(model, state, step, feed, names, accum, order, dev):
    """One more step through the same step object once the window has
    closed: (the weights it started from, its batch, its draws, what the
    program produced). ``prog["redrawn"]``: whether ``redraw`` from the
    generator's state before the step gives the draws its forwards took."""
    weights = {k: v.detach().float().clone() for k, v in model.state_dict().items()}
    before = adam_moments(state, names)
    rec = Recorder(model)
    rec.on = True
    batch = next(feed)
    start = rng_state(dev)
    loss = float(step(state, batch)["loss"])
    rec.on = False
    rec.remove()
    prog = rec.step(accum, step_gradient(before, adam_moments(state, names), names))
    prog["loss"] = loss
    drawn = rec.forwards[:accum]
    prog["redrawn"] = all(
        list(took) == list(again) and all(torch.equal(took[n], again[n]) for n in took)
        for took, again in zip(drawn, redraw(order, accum, start, dev)))
    return (weights, batch, drawn), prog


def adamw_state(state, names) -> dict:
    """{name: (AdamW's first moment, its second moment)}, copies; zeros
    where AdamW holds none."""
    out = {}
    for name, p in zip(names, state.optimizer.params):
        st = state.optimizer.adam.state.get(p, {})
        out[name] = tuple(st[k].detach().clone() if k in st else torch.zeros_like(p)
                          for k in ("exp_avg", "exp_avg_sq"))
    return out


def rng_state(dev):
    return torch.cuda.get_rng_state(dev) if dev.type == "cuda" else torch.get_rng_state()


def set_rng_state(state, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.set_rng_state(state, dev)
    else:
        torch.set_rng_state(state)


def redraw(order, accum: int, start, dev) -> list:
    """The stochastic-depth draws of a step of ``accum`` microbatches that
    started with the default generator at ``start``: each microbatch's
    forward draws, in ``order`` ([(module name, samples, drop rate)], the
    order an eager forward drew them), what ``models/swin.py::DropPath``
    draws; a graph replay takes the offsets the same draws take eagerly
    (``training/step.py``). Returns [{name: (samples,) keep mask}] a
    microbatch, the ``Recorder``'s form; the generator is left as it was."""
    saved = rng_state(dev)
    set_rng_state(start, dev)
    masks = []
    for _ in range(accum):
        masks.append({name: ((1.0 - p) + torch.rand(n, device=dev)).floor_() != 0
                      for name, n, p in order})
    set_rng_state(saved, dev)
    return masks


def replayed_step(model, state, step, feed, names, order, accum: int, dev):
    """One more step with no hook on the model, so that where the step is
    a CUDA graph it replays, as every step of the window did: ((the
    weights it started from, its batch, its draws, AdamW's moments before
    it, the first moments after it, its update count), what the program
    produced: its loss, the gradient its moments took, each parameter and
    its second moment after it, and whether it ran as the window's steps
    ran, a replay where the step has a graph). The draws are drawn again
    from the generator's state before the step (``redraw``)."""
    weights = {k: v.detach().float().clone() for k, v in model.state_dict().items()}
    before = adamw_state(state, names)
    start, count, graph = rng_state(dev), state.step, step.graph
    replays = None if graph is None else graph.replays
    batch = next(feed)
    loss = float(step(state, batch)["loss"])
    masks = redraw(order, accum, start, dev)
    after = adamw_state(state, names)
    m1 = {n: m for n, (m, _) in after.items()}
    prog = {"loss": loss,
            "window_path": graph is None or graph.replays == replays + 1,
            "grad": step_gradient({n: m for n, (m, _) in before.items()}, m1, names),
            "p": {n: p.detach().clone() for n, p in zip(names, state.optimizer.params)},
            "v": {n: v for n, (_, v) in after.items()}}
    return (weights, batch, masks, before, m1, count), prog


def replay_reference(replay, cfg: dict, opt: dict, accum: int, quant=identity) -> dict:
    """The reference of the replayed step: its gradient (``one_step`` from
    the weights the program started it from, its batch and draws), and
    AdamW's update at its count from the program's own state before it
    and the gradient its first moments took (``ref.adamw``, in f64): each
    parameter after it (its change rounded by ``quant``) and its second
    moment (rounded by ``quant``)."""
    weights, batch, masks, before, m1, count = replay
    out = ref.one_step(weights, cfg, opt, micro(batch, accum), masks, quant)
    out["p"], out["v"] = {}, {}
    b1 = ref.BETAS[0]
    with torch.no_grad():
        for n, (m0, v0) in before.items():
            m0, v0 = m0.double(), v0.double()
            g = (m1[n].double() - b1 * m0) / (1 - b1)
            p0 = weights[n].double()
            p = p0.clone()
            ref.adamw(p, m0, v0, g, ref.lr_at(opt, count), count + 1, opt["weight_decay"])
            out["p"][n] = p0 + quant((p - p0).float()).double()
            out["v"][n] = quant(v0.float()).double()
    return out


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| elementwise in units of the last place of ``want``
    rounded to float32 (2^(e - 24) where want = m 2^e, 0.5 <= |m| < 1)."""
    _, e = torch.frexp(want.float())
    unit = torch.ldexp(torch.ones_like(want, dtype=torch.float64), e - 24)
    return ((got.to(want.device, torch.float64) - want.double()).abs() / unit).float()


def replay_numbers(prog: dict, ref_out: dict) -> dict:
    """The numbers of the replayed step: ``replay_grad_dir``, the median
    parameter's ||program - reference|| / ||reference|| of the gradient
    (``compare.median_dir`` over the parameters it moves), which a replay
    on stale inputs or a wrong backward moves; ``replay_update_ulps``, the
    larger of the median element's distance from AdamW's of the
    parameters after the step and of the second moments, in float32 units
    in the last place (``ulps``): a sound float32 update reads under one
    (each value rounded once or twice), while a stale learning rate, a
    wrong count or a skipped decay (lr x decay x 2^23, some 17 units at
    lr 2e-4 and decay 0.01) reads far more. Both inf where the step did
    not run as the window's steps ran, or where the eager step before it
    showed ``redraw`` not to give the draws a forward takes."""
    if not (prog.get("window_path", True) and prog.get("redrawn", True)):
        return {"replay_grad_dir": float("inf"), "replay_update_ulps": float("inf")}
    norms = {n: float(g.norm()) for n, g in ref_out["grad"].items()}
    medians = [float(torch.cat([ulps(prog[key][n], want).flatten()
                                for n, want in ref_out[key].items()]).median())
               for key in ("p", "v")]
    return {"replay_grad_dir": compare.median_dir(prog["grad"], ref_out["grad"],
                                                  compare.moved(norms)),
            "replay_update_ulps": max(medians)}


def numbers(prog: dict, ref_out: dict):
    """``compare.train_numbers`` and ``replay_numbers``: ({number: value},
    {reading: value})."""
    out, readings = compare.train_numbers(prog, ref_out)
    out.update(replay_numbers({**prog["replay"], "redrawn": prog["after"].get("redrawn", True)},
                              ref_out["replay"]))
    readings["replay_loss_gap"] = (abs(prog["replay"]["loss"] - ref_out["replay"]["loss"])
                                   / abs(ref_out["replay"]["loss"]))
    return out, readings


def reference_opt(work: dict) -> dict:
    opt = work["optimizer"]
    if opt["schedule"] != "cosine" or opt["kind"] != "adamw":
        raise ValueError("the reference steps AdamW on the cosine schedule")
    return opt


def reference(cell: Cell, dev, checked, masks, after, quant=identity, replay=None) -> dict:
    """The plain reference's three steps from the seed's weights on the
    batches the program took, its step after the window from the weights
    the program reached, and, given ``replay``, the replayed step's
    (``replay_reference``), in f32 with TF32 off."""
    cfg, accum = cell.config, cell.work["accum_steps"]
    opt = reference_opt(cell.work)
    with full_f32():
        weights = ref.make_weights(cfg, cell.seed, dev)
        out = ref.follow(weights, cfg, opt, [micro(b, accum) for b in checked], masks, quant)
        del weights
        start, batch, after_masks = after
        out["after"] = ref.one_step(start, cfg, opt, micro(batch, accum), after_masks, quant)
        if replay is not None:
            out["replay"] = replay_reference(replay, cfg, opt, accum, quant)
    return out


def model_flops(cfg: dict, batch: int) -> float:
    """FLOPs of the reference's forward and backward on ``batch``
    samples, counted on the meta device: the trunk, the neck and the depth
    net of every camera, and the BEV downsample, decoder and head; the
    geometry, the outer product and the splat are not counted."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = torch.device("meta")
    p = {n: torch.empty(s, device=meta, requires_grad=not n.endswith(ref.BUFFER_SUFFIXES),
                        dtype=torch.int64 if n.endswith("tracked") else None)
         for n, s in ref.param_shapes(cfg)}
    _, _, (X, Y, Z) = ref.grid_dims(ref.bounds_of(cfg))
    H, W = cfg["image_size"]
    imgs = torch.empty(batch, cfg["ncams"], 3, H, W, device=meta)
    bev = torch.empty(batch, Z * cfg["vtransform"]["out_channels"], X, Y, device=meta,
                      requires_grad=True)
    net = ref.Net(p, cfg, True)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: roofline.conv_backward_flops})
    with counter:
        out = net.lift(imgs).sum() + net.bev(bev).sum()
    forward = float(counter.get_total_flops())
    with counter:
        out.backward()
    return forward + float(counter.get_total_flops())


def trace_layer(cell: Cell, geoms, dev) -> dict:
    """What the traced run's kernel and step metrics read besides the
    trace: the splat's least time over the window's calls, the calls, the
    steps, and the model's FLOPs a step."""
    cfg, work, accum = cell.config, cell.work, cell.work["accum_steps"]
    item = 2 if work["compute_dtype"] == "bfloat16" else 4
    bounds = ref.bounds_of(cfg)
    frus = ref.frustum(cfg["image_size"], cfg["feature_stride"],
                       cfg["vtransform"]["dbound"]).to(dev)
    _, _, (X, Y, Z) = ref.grid_dims(bounds)
    C = cfg["vtransform"]["out_channels"]
    splat_s = 0.0
    for g in geoms:
        for cams in ([tuple(x[i] for x in g) for i in range(accum)] if accum > 1 else [g]):
            ids = ref.voxel_ids(ref.geometry(frus, *(t.float() for t in cams[:5])), bounds)
            splat_s += roofline.splat_seconds(int((ids >= 0).sum()), ids.numel(), C, item,
                                              ids.shape[0], Z * X * Y)
    return {"splat_bound_s": splat_s, "forwards": len(geoms) * accum,
            "traced_steps": len(geoms),
            "flops_per_step": model_flops(cfg, work["bsz"]) * accum,
            "peak_flops": roofline.PEAK_FLOPS[work["peak"]]}


def run(cell: Cell) -> Run:
    from lss_carla_torch.ops import window_attention
    dev = torch.device(cell.device)
    work, accum = cell.work, cell.work["accum_steps"]
    undo = lambda: None
    try:
        model, state, step = build(cell, dev)
        feed = staged_feed(cell, dev)
        names = [n for n, _ in model.named_parameters()]
        start = [p.detach().clone() for p in state.optimizer.params]
        undo = plant(cell, state)
        rec = Recorder(model)
        rec.on = True
        prog = {"loss": []}
        checked = []
        for s in range(CHECK_STEPS):
            batch = next(feed)
            checked.append(batch)
            before, calls = window_attention.computed(), dict(window_attention.calls)
            metrics = step(state, batch)
            prog["loss"].append(float(metrics["loss"]))
            if s == 0:
                per_forward = {k: (v - before[k]) // accum
                               for k, v in window_attention.computed().items()}
                calls_per_forward = sum(window_attention.calls[k] - calls[k]
                                        for k in calls) // accum
                prog["first"] = rec.step(accum, step_gradient({}, adam_moments(state, names),
                                                              names))
        prog["grad1"] = {n: float(g.norm()) for n, g in prog["first"]["grad"].items()}
        prog["change"] = {n: float((p.detach() - p0).norm())
                          for n, p, p0 in zip(names, state.optimizer.params, start)}
        rec.on = False
        rec.remove()
        masks = [rec.forwards[i * accum:(i + 1) * accum] for i in range(CHECK_STEPS)]
        drops = {n: m.p for n, m in model.named_modules() if n in masks[0][0]}
        order = [(n, keep.numel(), drops[n]) for n, keep in masks[0][0].items()]
        del start, rec
        plant_late(cell, state)
        if dev.type == "cuda":     # the peak of the timed path, not of set-up's checks
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        steps = 0
        window_start = boot_clock()
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + cell.seconds:
            step(state, next(feed))
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        windows0 = window_attention.computed()
        summary, geoms = traced_part(cell, feed, state, step, dev) if cell.trace else (None, [])
        windows = {k: v - windows0[k] for k, v in window_attention.computed().items()}
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        after, prog["after"] = after_window(model, state, step, feed, names, accum, order, dev)
        replay, prog["replay"] = replayed_step(model, state, step, feed, names, order, accum,
                                               dev)
        feed.close()
        undo()
        samples = steps * work["bsz"] * accum
        layer = {"trace": summary, "steps": steps, "window_s": seconds, "samples": samples,
                 "windows": windows, "windows_per_forward": per_forward,
                 "attention_calls_per_forward": calls_per_forward}
        if cell.trace:
            layer.update(trace_layer(cell, geoms, dev))
        del model, state, step, feed, geoms
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref_out = reference(cell, dev, checked, masks, after, replay=replay)
        got, readings = numbers(prog, ref_out)
        checks = {k: (got[k], lim) for k, lim in work["limits"].items()}
        layer["check"] = {"checked": checked, "masks": masks, "after": after, "replay": replay,
                          "prog": prog, "ref": ref_out, "numbers": got}
        notes = [f"losses program {prog['loss']} reference {ref_out['loss']}",
                 "printed, not compared: " + repr(
                     {**{k: v for k, v in got.items() if k not in checks}, **readings}),
                 f"the replayed step ran as the window's: {prog['replay']['window_path']}; "
                 f"its draws followed: {prog['after']['redrawn']}",
                 f"window {seconds!r} s, {steps} steps, {samples} samples; attention "
                 f"windows a forward {per_forward}, in the traced part {windows}"]
        return Run(attempted=steps, failed=0,
                   e2e={"train_samples_per_s": samples / seconds,
                        "setup_s": window_start - cell.start},
                   checks=checks, memory_peak_bytes=peak, layer=layer, notes=notes)
    finally:
        undo()
