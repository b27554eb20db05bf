"""Train, eval and predict steps: counterpart of
``lss_carla_tpu/training/step.py`` (single device).

One train step is the reference hot loop: geometry -> CamEncode -> lift ->
splat -> BevEncode -> weighted BCE -> backward -> clip -> Adam, on the
model's device; a model may name another loss (``BEVFusionSeg``: the
sigmoid focal loss), and the state another optimizer (AdamW). Metrics come
back as device scalars and are synced only where the caller reads them.
Every factory takes ``device`` ("cuda" unless the caller asks for the CPU;
no GPU raises) and moves each batch there.

On one card the train step runs as one CUDA graph (``_StepGraph``): its
first call runs the step eagerly on a stream of its own and captures the
whole of it (forward and loss of every microbatch, backward, the
gradients' division, clip, Adam, EMA); every later call copies the batch
into the graph's input buffers, writes the learning rate and the EMA
decay into their device scalars, and replays it. The kernels are the
eager step's, the two CUDA kernels of ``ops/`` among them. The step runs
eagerly, as it always has, where a replay would not be the same step: on
the CPU; with ``forward`` or ``reduce`` (the parallel modes, whose
collectives stay eager); when the model rematerialises (``model.remat``);
and while any module of the model has a forward, forward-pre or backward
hook, or a global one is set (a hook runs Python that a replay skips). A
batch of another shape or dtype than the graph's also runs eagerly. The
graph captures again once anything it reads has been rebound (a
parameter, buffer or Adam tensor replaced, as ``restore_train_state``
does), or the state is another.

The parallel steps (``parallel/step.py``, ``parallel/camera.py``) are
these steps with two hooks: ``forward`` replaces the model's forward on
the six inputs, and ``reduce`` runs the step's collectives.

The train step emits the spans ``lss.step`` (the whole step),
``lss.step.forward`` and ``lss.step.backward`` (once a microbatch run on
the host) and ``lss.step.update`` (clip, Adam and the EMA), and on the
graph path ``lss.step.capture`` (a first call's eager step and capture)
and ``lss.step.replay`` (a replay) inside ``lss.step``; like every span
of ``utils/trace.py``, they record only while a profiler records.
"""

from __future__ import annotations

import torch

from lss_carla_torch.training.loss import (bce_with_logits,
                                           get_batch_iou_counts,
                                           masked_eval_metrics,
                                           sigmoid_focal_loss)
from lss_carla_torch.training.state import ema_decay_at, ema_update
from lss_carla_torch.utils.backend import resolve_device
from lss_carla_torch.utils.graph import capture
from lss_carla_torch.utils.trace import span

# the train step's losses, by the name a model's ``loss`` gives
LOSSES = ("bce", "sigmoid_focal")
_HOOKS = ("_forward_hooks", "_forward_pre_hooks", "_backward_hooks",
          "_backward_pre_hooks")

def to_device(batch, device: torch.device):
    """Each array of ``batch`` as a tensor on ``device`` (no copy where it
    is there already)."""
    return tuple(torch.as_tensor(a).to(device, non_blocking=True)
                 for a in batch)


def make_train_step(model, pos_weight=2.13, accum_steps: int = 1,
                    ema_decay: float = 0.0, device="cuda", forward=None,
                    reduce=None):
    """Returns ``train_step(state, batch) -> metrics``.

    ``batch`` is the reference 7-tuple (imgs, rots, trans, intrins,
    post_rots, post_trans, binimgs). metrics = {loss, intersect, union,
    grad_norm} as device scalars, from the logits before the update.

    ``accum_steps > 1``: gradient accumulation (the JAX ``accum_scan``).
    Each batch entry carries a leading (accum_steps, ...) microbatch axis
    (``data.loader.stack_microbatches``). The microbatches run in turn at
    the same parameters; BN running stats update in turn, as consecutive
    steps would; dropout draws afresh for each. The gradients are summed,
    divided by ``accum_steps``, clipped once and applied in one Adam
    update. loss is the microbatches' mean, intersect and union their sums.

    ``ema_decay > 0`` advances ``state.ema_model`` after the update
    (``training/state.py::ema_update``); the state must have been made with
    ``create_train_state(..., ema_decay=...)``. On one card the step is a
    CUDA graph where it can be (the module note); ``train_step.graph`` is
    its ``_StepGraph`` (None where the step is always eager).

    The loss is the one the model's ``loss`` names, "bce" where it names
    none: "bce" is the weighted BCE at ``pos_weight`` (``SimpleLoss``'s),
    "sigmoid_focal" BEVFusion's (``training/loss.py``). ``train_step.loss``
    is the one taken."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_name = getattr(model, "loss", "bce")
    if loss_name not in LOSSES:
        raise ValueError(f"unknown loss {loss_name!r} ({'|'.join(LOSSES)})")
    focal = loss_name == "sigmoid_focal"
    dev = resolve_device(device)
    graphable = dev.type == "cuda" and forward is None and reduce is None
    forward = forward or model
    # made once: a copy from the host inside the step would stop a capture
    weight = torch.as_tensor(pos_weight, dtype=torch.float32, device=dev)

    def micro_step(micro):
        with span("lss.step.forward"):
            logits = forward(*micro[:6])
        binimgs = micro[6]
        if focal:
            loss = sigmoid_focal_loss(logits, binimgs)
        else:
            loss = bce_with_logits(logits, binimgs, weight)
        with span("lss.step.backward"):
            loss.backward()
        intersect, union = get_batch_iou_counts(logits.detach(), binimgs)
        return loss.detach(), intersect, union

    def gradients(state, batch):
        """Forward, loss and backward of every microbatch into the
        parameters' gradients: (loss, intersect, union)."""
        if accum_steps == 1:
            return micro_step(batch)
        if batch[0].shape[0] != accum_steps:
            raise ValueError(f"batch has {batch[0].shape[0]} microbatches, "
                             f"accum_steps is {accum_steps}")
        parts = [micro_step(tuple(x[i] for x in batch))
                 for i in range(accum_steps)]
        loss, intersect, union = (sum(p) for p in zip(*parts))
        grads = [p.grad for p in state.optimizer.params if p.grad is not None]
        torch._foreach_div_(grads, float(accum_steps))
        return loss / accum_steps, intersect, union

    def step(state, batch):
        batch = to_device(batch[:7], dev)
        model.train()
        state.optimizer.zero_grad()
        loss, intersect, union = gradients(state, batch)
        metrics = {"loss": loss, "intersect": intersect, "union": union}
        if reduce is not None:
            metrics = reduce(state, metrics)
        with span("lss.step.update"):
            grad_norm = state.optimizer.step(state.step)
            state.step += 1
            if ema_decay > 0:
                ema_update(state, ema_decay)
        return {**metrics, "grad_norm": grad_norm}

    def captured(state, batch, decay):
        """What the graph holds: the step after ``set_lr``, with the EMA
        decay read from ``decay``."""
        model.train()
        loss, intersect, union = gradients(state, batch)
        with span("lss.step.update"):
            grad_norm = state.optimizer.update()
            if ema_decay > 0:
                ema_update(state, ema_decay, decay)
        return {"loss": loss, "intersect": intersect, "union": union,
                "grad_norm": grad_norm}

    graph = _StepGraph(model, step, captured, ema_decay, dev) if graphable else None

    def train_step(state, batch):
        with span("lss.step"):
            if graph is not None and graph.engages():
                return graph(state, batch)
            return step(state, batch)

    train_step.graph = graph
    train_step.loss = loss_name
    return train_step


def _hooked(model) -> bool:
    """Whether a hook would run Python in the model's forward or backward:
    a global module hook, or one on any module of ``model``."""
    glob = torch.nn.modules.module
    if any(getattr(glob, "_global" + name, None) for name in _HOOKS):
        return True
    return any(getattr(m, name) for m in model.modules() for name in _HOOKS)


def _bound(model, state) -> list:
    """Everything a captured step reads or writes in place, in a fixed
    order: the state's optimizer and EMA model, every parameter and buffer
    of the model and the EMA model, the optimizer's learning rate and
    whether each group reads it, and Adam's state tensors."""
    out = [state.optimizer, state.ema_model]
    for m in (model, state.ema_model):
        for mod in () if m is None else m.modules():
            out.extend(mod._parameters.values())
            out.extend(mod._buffers.values())
    adam = state.optimizer.adam
    out.append(state.optimizer.lr)
    out.extend(group["lr"] is state.optimizer.lr for group in adam.param_groups)
    for p in state.optimizer.params:
        out.append(p)
        out.extend(adam.state.get(p, {}).values())
    return out


class _StepGraph:
    """The single-device train step as one CUDA graph.

    The first call (and any call after a rebinding, below) runs the eager
    step on this object's own stream, which is this call's step and warms
    up everything a capture must find made (Adam's state, cuBLAS's
    workspace, the kernels' per-stream scratch), then captures
    ``captured`` on that stream into a graph with its own memory pool and
    returns the eager step's metrics. The capture's kernels take scratch
    of their own from the graph's pool (``ops/splat_cuda.py``), so no
    other caller grows or frees what the graph holds. A later call with a batch of the captured shapes and dtypes copies it
    into the input buffers, writes ``lr`` (``Optimizer.set_lr``) and the
    EMA decay, replays the graph on the caller's stream and returns clones
    of the graph's outputs, each call's own values. Dropout draws from
    the default CUDA generator as the eager step does: a replay takes the
    offsets the same launches would take eagerly.

    The graph holds the addresses of everything in ``_bound``: a call whose
    ``_bound`` differs (a tensor rebound, another state) captures again.
    After a replay the parameters' ``grad`` are the graph's gradients,
    clipped, as after an eager step. ``graph`` is the ``utils/graph.py``
    capture: its ``held`` is what the capture's calls of the splat and
    depthwise wrappers recorded ({kernel: {dtype: kernels}}) and its
    ``windows`` what its attention calls recorded ({kind: windows}), which
    each replay adds to those modules' ``replayed``. ``captures`` and
    ``replays`` count this object's."""

    def __init__(self, model, step, captured, ema_decay: float, dev):
        self.model, self.step, self.captured = model, step, captured
        self.ema_decay, self.dev = ema_decay, dev
        self.stream = None
        self.captures = self.replays = 0
        self._drop()

    def _drop(self) -> None:
        """Let go of the graph and every tensor of its pool."""
        self.graph = self.inputs = self.decay = self.grads = self.sig = None
        self.bound = []

    def engages(self) -> bool:
        """Whether this call may run as the graph: no remat, no hook."""
        return not getattr(self.model, "remat", False) and not _hooked(self.model)

    def __call__(self, state, batch):
        batch = tuple(torch.as_tensor(a) for a in batch[:7])
        sig = tuple((t.shape, t.dtype) for t in batch)
        live = _bound(self.model, state)
        if self.graph is not None and len(live) == len(self.bound) and all(
                a is b for a, b in zip(live, self.bound)):
            if sig == self.sig:
                return self._replay(state, batch)
            return self.step(state, batch)
        return self._capture(state, batch, sig)

    def _capture(self, state, batch, sig):
        with span("lss.step.capture"):
            self._drop()
            caller = torch.cuda.current_stream(self.dev)
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.dev)
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                metrics = self.step(state, batch)
                warm = [p.grad for p in state.optimizer.params]
                state.optimizer.zero_grad()      # the graph's own gradients
                inputs = tuple(torch.empty_like(t, device=self.dev) for t in batch)
                decay = torch.zeros((), dtype=torch.float32, device=self.dev)
                graph = capture(lambda: self.captured(state, inputs, decay),
                                self.stream)
            caller.wait_stream(self.stream)
            self.grads = [p.grad for p in state.optimizer.params]
            for p, g in zip(state.optimizer.params, warm):
                p.grad = g
            self.graph, self.inputs, self.decay = graph, inputs, decay
            self.sig = sig
            self.bound = _bound(self.model, state)
            self.captures += 1
            return metrics

    def _replay(self, state, batch):
        with span("lss.step.replay"):
            for buf, t in zip(self.inputs, batch):
                buf.copy_(t, non_blocking=True)
            state.optimizer.set_lr(state.step)
            if self.ema_decay > 0:
                self.decay.fill_(ema_decay_at(self.ema_decay, state.step + 1))
            if not self.model.training:
                self.model.train()
            self.graph.replay()
            state.step += 1
            for p, g in zip(state.optimizer.params, self.grads):
                if p.grad is not g:
                    p.grad = g
            self.replays += 1
            return {k: v.clone() for k, v in self.graph.out.items()}


def make_eval_step(model, pos_weight=2.13, device="cuda", forward=None,
                   reduce=None):
    """Returns ``eval_step(state, batch) -> metrics`` for ``get_val_info``:
    {loss_sum, intersect, union, intersect_c, union_c, batch}. An 8th
    batch element is the val loader's (B,) validity mask (``pad_last``);
    padded samples count nowhere. ``forward`` and ``reduce(metrics) ->
    metrics`` as in ``make_train_step``."""
    dev = resolve_device(device)
    forward = forward or model

    def eval_step(state, batch):
        batch = to_device(batch, dev)
        imgs, rots, trans, intrins, post_rots, post_trans, binimgs = batch[:7]
        valid = batch[7] if len(batch) > 7 else \
            torch.ones(imgs.shape[0], device=dev)
        model.eval()
        with torch.no_grad():
            logits = forward(imgs, rots, trans, intrins, post_rots, post_trans)
        metrics = masked_eval_metrics(logits, binimgs, valid, pos_weight)
        return metrics if reduce is None else reduce(metrics)

    return eval_step


def make_predict_step(model, device="cuda", forward=None):
    """Returns ``predict(state, inputs) -> logits (B, outC, X, Y)``;
    ``forward`` as in ``make_train_step``."""
    dev = resolve_device(device)
    forward = forward or model

    def predict(state, inputs):
        model.eval()
        with torch.no_grad():
            return forward(*to_device(inputs, dev))

    return predict
