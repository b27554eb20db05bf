"""Train state and optimizer: counterpart of ``lss_carla_tpu/training/state.py``.

The optimizer computes what the JAX package's optax chain computes (the
reference trainer's torch ``Adam(lr, weight_decay=1e-7)`` after
``clip_grad_norm_(5.0)``, ``train_simbev.py:192,247``):

    clip_by_global_norm(max_grad_norm)   # optax's rule, below
    -> add_decayed_weights(weight_decay) # L2 into the Adam moments
    -> scale_by_adam(0.9, 0.999, 1e-8)
    -> -lr * schedule(count)

torch ``Adam(weight_decay=...)`` folds the L2 term into the gradient before
the moments, as ``add_decayed_weights`` does. The clip is optax's: scale by
``max_norm / ||g||`` only when ``||g|| >= max_norm``, with no epsilon
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and is not used).
The schedule's value for update ``count`` (0 for the first) is set as the
learning rate before each step, as optax's ``scale_by_learning_rate``
reads its count.

EMA (``ema_decay > 0``): ``TrainState.ema_model`` is a copy of the model
whose parameters and BN running stats hold the exponential moving average
of the trained model's (the JAX state's ``ema_params`` and
``ema_batch_stats``); ``ema_update`` advances it after each optimizer
step, and validation and serving read it. ``restore_train_state`` loads a
checkpoint with or without an EMA into a run with or without one.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``steps``, then held."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0: init -> 0 over ``steps``."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive steps, got {steps}")
    return lambda count: init * 0.5 * (1.0 + math.cos(
        math.pi * min(count, steps) / steps))


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else then(count - boundary)


def make_lr_schedule(lr: float, lr_schedule: str = "constant",
                     warmup_steps: int = 0, decay_steps: int = 0) -> Schedule:
    """Update count -> learning rate. "constant" (the reference's), or
    "cosine" / "linear": a linear warmup from 0 to ``lr`` over
    ``warmup_steps``, then a decay to 0 at ``decay_steps``."""
    if lr_schedule not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown lr_schedule {lr_schedule!r} "
                         "(constant|cosine|linear)")
    if lr_schedule == "constant":
        return _linear(0.0, lr, warmup_steps) if warmup_steps else (lambda _: lr)
    if decay_steps <= warmup_steps:
        raise ValueError(f"{lr_schedule} schedule needs decay_steps "
                         f"(total steps) > warmup_steps; got "
                         f"{decay_steps} <= {warmup_steps}")
    if lr_schedule == "cosine":
        return _join(_linear(0.0, lr, warmup_steps),
                     _cosine(lr, decay_steps - warmup_steps), warmup_steps)
    return _join(_linear(0.0, lr, max(warmup_steps, 1)),
                 _linear(lr, 0.0, decay_steps - warmup_steps), warmup_steps)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, as an f32 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(tensors: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm n is at
    least ``max_norm`` every tensor becomes ``(t / n) * max_norm``, else it
    is left bit for bit. No host sync. Returns n (before clipping)."""
    norm = global_norm(tensors)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(tensors, torch.where(keep, one, norm))
    torch._foreach_mul_(tensors, torch.where(keep, one, one * max_norm))
    return norm


class Optimizer:
    """The optax chain above over ``params``. ``step(count)`` clips the
    gradients, sets the learning rate ``schedule(count)`` and takes one
    Adam step; it returns the gradients' global norm before clipping."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 weight_decay: float, max_grad_norm: float,
                 schedule: Schedule):
        self.params = [p for p in params if p.requires_grad]
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = clip_by_global_norm_(grads, self.max_grad_norm)
        else:
            norm = global_norm(grads)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(count)
        self.adam.step()
        return norm

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def make_optimizer(params: Iterable[nn.Parameter], lr: float = 1e-3,
                   weight_decay: float = 1e-7, max_grad_norm: float = 5.0,
                   lr_schedule: str = "constant", warmup_steps: int = 0,
                   decay_steps: int = 0) -> Optimizer:
    return Optimizer(params, lr, weight_decay, max_grad_norm,
                     make_lr_schedule(lr, lr_schedule, warmup_steps,
                                      decay_steps))


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the update count (``step``, the
    reference's ``counter``), the learning-rate schedule and, with EMA on,
    the averaged copy of the model (else None)."""
    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    ema_model: Optional[nn.Module] = None

    @property
    def schedule(self) -> Schedule:
        return self.optimizer.schedule


def averaged_tensors(model: nn.Module) -> List[torch.Tensor]:
    """What the EMA averages, in a fixed order: every parameter and every
    BN running mean and variance (the JAX ``params`` and
    ``batch_stats``)."""
    return list(model.parameters()) + [
        b for name, b in model.named_buffers()
        if name.endswith((".running_mean", ".running_var"))]


@torch.no_grad()
def ema_update(state: TrainState, decay: float) -> None:
    """One EMA step over the (already updated) model, in place:
    ``ema <- d ema + (1 - d) x`` for every averaged tensor, with the
    warm-up ramp ``d = min(decay, (1 + t) / (10 + t))``, t = ``state.step``:
    the update count after this step, 1 at the first (the JAX package
    reads flax's step after ``apply_gradients`` has advanced it)."""
    t = float(state.step)
    d = min(decay, (1.0 + t) / (10.0 + t))
    ema = averaged_tensors(state.ema_model)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, averaged_tensors(state.model), alpha=1.0 - d)


def create_train_state(model: nn.Module, lr: float = 1e-3,
                       weight_decay: float = 1e-7, max_grad_norm: float = 5.0,
                       lr_schedule: str = "constant", warmup_steps: int = 0,
                       decay_steps: int = 0,
                       ema_decay: float = 0.0) -> TrainState:
    """``ema_decay > 0`` seeds the EMA with a copy of the model (same
    device, no gradients): its parameters and BN running stats."""
    ema_model = None
    if ema_decay > 0:
        ema_model = copy.deepcopy(model).requires_grad_(False)
    return TrainState(model, make_optimizer(
        model.parameters(), lr, weight_decay, max_grad_norm, lr_schedule,
        warmup_steps, decay_steps), ema_model=ema_model)


def restore_train_state(state: TrainState, ckpt: dict) -> None:
    """Load a checkpoint dict (``utils/checkpoint.py``) into ``state`` in
    place: the model, the optimizer and ``step`` (= ``counter``).

    Tolerant of EMA either way, as the JAX ``restore_train_state``: a run
    with EMA restores ``ema_state_dict`` where the checkpoint has one and
    seeds the EMA from the restored model where it has none; a run without
    EMA ignores the checkpoint's."""
    state.model.load_state_dict(ckpt["model_state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt["counter"])
    has_ema = "ema_state_dict" in ckpt
    if state.ema_model is not None:
        if not has_ema:
            print("checkpoint has no EMA; seeding the EMA from the restored "
                  "weights")
        state.ema_model.load_state_dict(
            ckpt["ema_state_dict"] if has_ema else state.model.state_dict())
    elif has_ema:
        print("checkpoint carries an EMA this run does not track; dropped")
