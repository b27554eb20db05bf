"""Training traffic: the port's step, fed as its recipe feeds it, timed over
the window.

Set-up builds one train state (``create_train_state``) and one step
(``make_train_step``) around a model whose weights the benchmark made from
the seed, and one feed:

* ``fixture`` traffic: a seeded SimBEV tree written under ``TMPDIR`` by
  the frozen generator, read by the port's ``compile_data`` and
  ``prefetch_to_device`` (through ``stack_microbatches``), epoch after
  epoch, as ``training/loop.py`` composes them;
* ``staged`` traffic: batches made from the seed on the card (uint8
  images, the frozen rig, labels at the traffic's occupancy), cycled.

The first three steps go through that feed and that step; they are the
warm-up, and the reference follows them: the harness records their
batches, losses, Adam's first moments after step 1, the parameters after
step 3, and what each forward and backward produced (``Recorder``: hooks
that only read). The window then runs steps until ``--seconds`` have
passed, and ends when the device has finished them; a traced run then
profiles ``trace.TRACE_S`` more seconds of steps. Once the window has
closed and the peak is read, one more step goes through the same step
object, from a copy of the weights and Adam's moments that the program
reached, so that what the path does only once it has warmed up is
checked too. Then the program's state is freed and the plain reference
runs the same three steps from the seed's weights, and the step after the
window from the copied weights, in f32 with TF32 off.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import compare, roofline
from benchmark.fixture import generate_fixture, rig
from benchmark.harness import Cell, Run, boot_clock
from benchmark.reference import lss as ref_lss
from benchmark.reference.train import follow, one_step
from benchmark.trace import TRACE_S, Profiled, span
from benchmark.weights import make_weights

CHECK_STEPS = 3


# the end-to-end metrics this driver measures
METRICS = ("train_samples_per_s", "setup_s")


def build(cell: Cell, dev):
    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.models.lss import LiftSplatShoot
    from lss_carla_torch.training.state import create_train_state
    from lss_carla_torch.training.step import make_train_step
    cfg, work, opt = cell.config, cell.work, cell.work["optimizer"]
    grid = GridConf(**{k: tuple(v) for k, v in cfg["grid"].items()})
    aug = DataAugConf(H=cell.traffic.get("H", 224), W=cell.traffic.get("W", 480),
                      final_dim=tuple(cfg["final_dim"]), Ncams=cfg["ncams"],
                      resize_lim=tuple(work.get("resize_lim", (1.0, 1.0))))
    with torch.device(dev):
        model = LiftSplatShoot(grid, aug, outC=cfg["outC"], camC=cfg["camC"],
                               downsample=cfg["downsample"], variant=cfg["variant"],
                               fused_dw=work["fused_dw"],
                               compute_dtype=work["compute_dtype"])
    model.to(dev).load_state_dict(make_weights(cfg, cell.seed, dev))
    state = create_train_state(
        model, lr=opt["lr"], weight_decay=opt["weight_decay"],
        max_grad_norm=opt["max_grad_norm"], lr_schedule=opt["schedule"],
        warmup_steps=opt["warmup_steps"], decay_steps=opt["decay_steps"],
        ema_decay=work["ema_decay"])
    step = make_train_step(model, cfg["pos_weight"], accum_steps=work["accum_steps"],
                           ema_decay=work["ema_decay"], device=dev)
    return model, aug, grid, state, step


def fixture_feed(cell: Cell, aug, grid, dev, root):
    """Endless device batches from the port's loader over a seeded tree."""
    from lss_carla_torch.data.loader import (compile_data, prefetch_to_device,
                                             stack_microbatches)
    t = cell.traffic
    generate_fixture(root, num_scenes=t["scenes"], samples_per_scene=t["samples_per_scene"],
                     H=t["H"], W=t["W"], seed=cell.seed,
                     grid=ref_lss.grid_dims(cell.config["grid"])[2][0])
    loader, _ = compile_data("unused", root, aug, grid, bsz=cell.work["bsz"],
                             nworkers=cell.work["nworkers"], seed=cell.seed,
                             dataset_kwargs={"label_mode": cell.config["label_mode"],
                                             "device_normalize": True})
    accum = cell.work["accum_steps"]

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from prefetch_to_device(stack_microbatches(iter(loader), accum), dev)
            epoch += 1
    return batches(), loader.dataset


def staged_feed(cell: Cell, dev):
    """Endless device batches cycled from ``batches`` made on the device."""
    t, cfg, work = cell.traffic, cell.config, cell.work
    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    rng = np.random.default_rng(cell.seed)
    A, B, N = work["accum_steps"], work["bsz"], cfg["ncams"]
    (fH, fW), (X, Y) = cfg["final_dim"], ref_lss.grid_dims(cfg["grid"])[2][:2]
    staged = []
    for _ in range(t["batches"]):
        imgs = torch.randint(0, 256, (A, B, N, 3, fH, fW), generator=gen,
                             device=dev, dtype=torch.uint8)
        cams = [torch.from_numpy(a).to(dev).view(A, B, *a.shape[1:])
                for a in rig(rng, A * B, N, (fH, fW))]
        labels = (torch.rand((A, B, cfg["outC"], X, Y), generator=gen, device=dev)
                  < t["occupancy"]).float()
        staged.append((imgs, *cams, labels))
    if A == 1:
        staged = [tuple(x[0] for x in b) for b in staged]

    def batches():
        i = 0
        while True:
            yield staged[i % len(staged)]
            i += 1
    return batches(), None


class Recorder:
    """Hooks on the port's model that, while ``on``, keep what a step's
    forward and backward produce (they read, never write): every dropout
    draw of a forward (each forward's masks in ``forwards``, in the
    reference's names), its logits (``logits``), the loss's gradient by the
    logits (``dlogits``) and the pooled BEV that the BEV encoder takes
    (``bev``, channels first), each copied to the host."""

    def __init__(self, model):
        self.on, self.forwards, self.current = False, [], {}
        self.logits, self.dlogits, self.bev = [], [], []
        hooks = [(model.camencode.dropout, "camencode.dropout", self._elementwise),
                 (model.bevencode.dropout, "bevencode.dropout", self._channels)]
        for i, block in enumerate(model.camencode.trunk._blocks):
            if block.id_skip and block.drop_connect_rate > 0:
                hooks.append((block, f"camencode.trunk._blocks.{i}", self._samples))
        self.handles = [m.register_forward_hook(self._hook(name, fn))
                        for m, name, fn in hooks]
        self.handles.append(model.register_forward_hook(self._output))
        self.handles.append(model.bevencode.register_forward_pre_hook(self._bev))

    def _output(self, module, inputs, output):
        if self.on:
            self.logits.append(output.detach().float().cpu())
            if output.requires_grad:
                output.register_hook(lambda g: self.dlogits.append(g.detach().float().cpu()))

    def _bev(self, module, inputs):
        if self.on:
            self.bev.append(inputs[0].detach().permute(0, 3, 1, 2).float().cpu())

    def _hook(self, name, fn):
        def hook(module, inputs, output):
            if self.on:
                self.current[name] = fn(inputs[0], output)
                if name == "bevencode.dropout":      # a forward's last draw
                    self.forwards.append(self.current)
                    self.current = {}
        return hook

    @staticmethod
    def _elementwise(x, y):
        return y != 0

    @staticmethod
    def _channels(x, y):
        return (y != 0).flatten(2).any(-1)[:, :, None, None]

    @staticmethod
    def _samples(x, y):
        return (y != x).flatten(1).any(-1)

    def step(self, accum: int, grad: dict) -> dict:
        """The first recorded step's readings, with its ``grad``."""
        return {"logits": self.logits[:accum], "dlogits": self.dlogits[:accum],
                "bev": self.bev[:accum], "grad": grad}

    def remove(self):
        for h in self.handles:
            h.remove()


def adam_moments(state, names) -> dict:
    """{name: Adam's first moment} (None where it holds none)."""
    out = {}
    for name, p in zip(names, state.optimizer.params):
        m = state.optimizer.adam.state.get(p, {}).get("exp_avg")
        out[name] = None if m is None else m.detach().float().clone()
    return out


def step_gradient(before: dict, after: dict, names) -> dict:
    """{name: the gradient that one Adam step took}, on the host, from the
    first moments before and after it (m' = 0.9 m + 0.1 g); 0 where the
    step left none."""
    out = {}
    for n in names:
        m0, m1 = before.get(n), after[n]
        if m1 is None:
            out[n] = torch.zeros(())
        else:
            out[n] = ((m1 if m0 is None else m1 - 0.9 * m0) / 0.1).cpu()
    return out


def micro(batch, accum: int):
    """The microbatches of one step's batch, each a 7-tuple."""
    if accum == 1:
        return [tuple(batch[:7])]
    return [tuple(x[i] for x in batch[:7]) for i in range(accum)]


def plant(cell: Cell, state):
    """The check's own tests break the timed path underneath with
    ``cell.fault``, for the whole run: ``state_unchanged`` (the optimizer
    step updates nothing), ``half_batch`` (the forward runs on every row
    and the loss is the mean over the first half of each microbatch's) or
    ``late_half_batch`` (the same from the fourth step on, after the
    steps that set-up checks). Returns a function that takes it out."""
    if cell.fault == "state_unchanged":
        state.optimizer.step = lambda count: torch.zeros(())
    elif cell.fault in ("half_batch", "late_half_batch"):
        import lss_carla_torch.training.step as port_step
        whole, calls = port_step.bce_with_logits, 0
        late = CHECK_STEPS * cell.work["accum_steps"] if cell.fault == "late_half_batch" else 0

        def half(logits, targets, pos_weight):
            nonlocal calls
            calls += 1
            if calls <= late:
                return whole(logits, targets, pos_weight)
            n = logits.shape[0] // 2
            return whole(logits[:n], targets[:n], pos_weight)
        port_step.bce_with_logits = half
        return lambda: setattr(port_step, "bce_with_logits", whole)
    elif cell.fault is not None:
        raise ValueError(f"no fault {cell.fault!r} in training")
    return lambda: None


def after_window(model, state, step, feed, names, accum):
    """One more step through the same step object once the window has
    closed: (the weights it started from, its batch, its dropout masks,
    what the program produced)."""
    weights = {k: v.detach().float().clone() for k, v in model.state_dict().items()}
    before = adam_moments(state, names)
    rec = Recorder(model)
    rec.on = True
    batch = next(feed)
    loss = float(step(state, batch)["loss"])
    rec.on = False
    rec.remove()
    prog = rec.step(accum, step_gradient(before, adam_moments(state, names), names))
    prog["loss"] = loss
    return (weights, batch, rec.forwards[:accum]), prog


def image_levels(check_batches, dataset, root, aug) -> float:
    """Largest |loader - PIL| in levels over the check batches' images.

    Each row is matched to its sample by its label, and its resize and
    crop are read back from its post-rotation and translation; PIL then
    decodes the sample's files, resizes them bicubically and crops."""
    from PIL import Image
    by_label = {}
    for i, s in enumerate(dataset.samples):
        bev = np.load(os.path.join(s["meta_dir"], s["bev"]))["bev"]
        lab = np.flipud(((bev[1] > 0) | (bev[2] > 0) | (bev[3] > 0))).astype(np.float32)
        by_label[lab.tobytes()] = i
    fH, fW = aug.final_dim
    worst = 0.0
    for batch in check_batches:
        imgs, post_rots, post_trans, labels = (batch[0].cpu().numpy(), batch[4].cpu().numpy(),
                                               batch[5].cpu().numpy(), batch[6].cpu().numpy())
        for b in range(imgs.shape[0]):
            sample = dataset.samples[by_label[labels[b, 0].tobytes()]]
            r = float(post_rots[b, 0, 0, 0])
            cw, ch = int(round(-post_trans[b, 0, 0])), int(round(-post_trans[b, 0, 1]))
            newH = ch + fH
            ws = {int(aug.W * r + d) for d in (-1e-3, 0.0, 1e-3)}
            for c in range(imgs.shape[1]):
                src = Image.open(os.path.join(root, sample["images"][c])).convert("RGB")
                best = min(
                    np.abs(np.asarray(src.resize((w, newH), Image.BICUBIC)
                                      .crop((cw, ch, cw + fW, ch + fH)), np.int16)
                           .transpose(2, 0, 1) - imgs[b, c].astype(np.int16)).max()
                    for w in ws)
                worst = max(worst, float(best))
    return worst


def run(cell: Cell) -> Run:
    dev = torch.device(cell.device)
    work, cfg, accum = cell.work, cell.config, cell.work["accum_steps"]
    root = tempfile.mkdtemp(prefix="bench-fixture-") if cell.traffic["generator"] == "fixture" else None
    undo = lambda: None
    try:
        model, aug, grid, state, step = build(cell, dev)
        if root is not None:
            feed, dataset = fixture_feed(cell, aug, grid, dev, root)
        else:
            feed, dataset = staged_feed(cell, dev)
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
            metrics = step(state, batch)
            prog["loss"].append(float(metrics["loss"]))
            if s == 0:
                prog["first"] = rec.step(accum, step_gradient({}, adam_moments(state, names),
                                                              names))
        prog["grad1"] = {n: float(g.norm()) for n, g in prog["first"]["grad"].items()}
        prog["change"] = {n: float((p.detach() - p0).norm())
                          for n, p, p0 in zip(names, state.optimizer.params, start)}
        rec.on = False
        rec.remove()
        masks = [rec.forwards[i * accum:(i + 1) * accum] for i in range(CHECK_STEPS)]
        del start, rec
        if dev.type == "cuda":     # the peak of the timed path, not of set-up's checks
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        steps, waited = 0, 0.0
        window_start = boot_clock()
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + cell.seconds:
            t1 = time.perf_counter()
            batch = next(feed)
            waited += time.perf_counter() - t1
            step(state, batch)
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        summary, geoms = traced_part(cell, feed, state, step, dev) if cell.trace else (None, [])
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        after, prog["after"] = after_window(model, state, step, feed, names, accum)
        feed.close()
        undo()
        samples = steps * work["bsz"] * accum
        layer = {"trace": summary, "steps": steps, "window_s": seconds,
                 "samples": samples, "loader_wait_s": waited if root else None}
        if cell.trace:
            layer.update(trace_layer(cell, geoms, dev))
        images = image_levels(checked, dataset, root, aug) if root else None
        del model, state, step, feed, geoms
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference(cell, dev, checked, masks, after)
        numbers, readings = compare.train_numbers(prog, ref)
        if images is not None:
            numbers["image_levels"] = images
        checks = {k: (numbers[k], lim) for k, lim in work["limits"].items()}
        layer["check"] = {"checked": checked, "masks": masks, "after": after,
                          "prog": prog, "ref": ref, "numbers": numbers}
        notes = [f"losses program {prog['loss']} reference {ref['loss']}",
                 "printed, not compared: " + repr(
                     {**{k: v for k, v in numbers.items() if k not in checks}, **readings}),
                 f"window {seconds!r} s, {steps} steps, {samples} samples"]
        return Run(attempted=steps, failed=0,
                   e2e={"train_samples_per_s": samples / seconds,
                        "setup_s": window_start - cell.start},
                   checks=checks, memory_peak_bytes=peak, layer=layer, notes=notes)
    finally:
        undo()
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)


def traced_part(cell: Cell, feed, state, step, dev):
    """(trace summary, each traced step's camera inputs): ``TRACE_S`` more
    seconds of steps under the profiler, each call spanned."""
    geoms = []
    with Profiled() as p:
        while p.elapsed() < TRACE_S:
            with span("loader.next"):
                batch = next(feed)
            with span("train_step"):
                step(state, batch)
            geoms.append(batch[1:6])
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return p.summary, geoms


def reference(cell: Cell, dev, checked, masks, after, quant=ref_lss.identity) -> dict:
    """The plain reference's three steps from the seed's weights on the
    batches the program took, and its step after the window from the
    weights the program reached, in f32 with TF32 off."""
    cfg, opt, accum = cell.config, cell.work["optimizer"], cell.work["accum_steps"]
    with ref_lss.full_f32():
        weights = make_weights(cfg, cell.seed, dev)
        out = follow(weights, cfg, opt, [micro(b, accum) for b in checked], masks, quant)
        del weights
        start, batch, after_masks = after
        out["after"] = one_step(start, cfg, opt, micro(batch, accum), after_masks, quant)
    return out


def trace_layer(cell: Cell, geoms, dev) -> dict:
    """What the traced run's kernel and step metrics read besides the
    trace: the splat's and the depthwise kernel's least time over the
    window's calls, the calls, and the model's FLOPs a step."""
    cfg, work, accum = cell.config, cell.work, cell.work["accum_steps"]
    item = 2 if work["compute_dtype"] == "bfloat16" else 4
    frus = ref_lss.frustum(cfg["final_dim"], cfg["downsample"], cfg["grid"]["dbound"]).to(dev)
    _, _, (X, Y, Z) = ref_lss.grid_dims(cfg["grid"])
    splat_s = 0.0
    for g in geoms:
        for cams in ([tuple(x[i] for x in g) for i in range(accum)] if accum > 1 else [g]):
            ids = ref_lss.voxel_ids(ref_lss.geometry(frus, *(t.float() for t in cams[:5])),
                                    cfg["grid"])
            splat_s += roofline.splat_seconds(int((ids >= 0).sum()), ids.numel(),
                                              cfg["camC"], item, ids.shape[0], Z * X * Y)
    dw = ref_lss.dw_shapes(cfg, work["bsz"] * cfg["ncams"])
    flops = roofline.model_flops(cfg, work["bsz"], train=True)["total"] * accum
    return {"splat_bound_s": splat_s, "forwards": len(geoms) * accum,
            "dw_bound_s_per_forward": sum(roofline.dw_seconds(sh, k, s, item)
                                          for k, s, sh in dw) if work["fused_dw"] else None,
            "dw_launches_per_forward": len(dw), "flops_per_step": flops,
            "peak_flops": roofline.PEAK_FLOPS[work["peak"]]}
