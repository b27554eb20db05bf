"""The numbers that decide ``correct``, each worked out from the program's
reading and the plain reference's. A cell's file lists under ``limits``
the numbers it compares; the others are printed beside them.

Training, of the first step of the timed path (which set-up drives) and
of one step taken after the window (prefixed ``after_``), the reference
following the program from the same weights, batch and dropout draws:

* ``logits_gap``: ||program - reference|| / ||reference|| of the
  train-mode logits, the largest over the step's microbatches; inf where
  the program answered other rows than it was given;
* ``dlogits_gap``: the same of the loss's gradient by the logits (the
  program's read by a hook on its output that only reads): where the loss
  leaves rows out, or weighs them wrongly, the gap is of the order of 1;
* ``bev_gap``: the same of the pooled BEV that the BEV encoder takes
  (the lift and the splat, before the encoder's train-mode BNs amplify
  the rounding);
* ``grad1_dir`` (``after_grad_dir``): the median parameter's
  ||program - reference|| / ||reference|| of the gradient as the
  optimizer takes it (clipped, with the decay term; the program's read
  back from Adam's first moments), which a wrong direction moves where a
  norm would not;

and of the first three steps:

* ``grad1_gap``: the median parameter's |program norm - reference norm|
  / reference norm of the first gradient;
* ``change_gap``: the same of each parameter's change after the three
  steps.

The training cells compare ``dlogits_gap``, ``bev_gap``, ``grad1_gap``,
``change_gap`` and ``after_dlogits_gap``. In bf16, at the cells' depths
and at initialisation, a sound program's logits, its step's BEV after the
window and its per-parameter gradients already differ from f32 by 0.1 to
1, and fp8 moves them less than three times further, so those are
printed (PERF.md has the readings).

The parameter numbers leave out the parameters whose reference gradient
is under a thousandth of the median parameter's (round-off alone moves
them under Adam). Printed beside them (PERF.md has the readings): each
step's relative loss gap, which averages the rounding of 320,000
near-zero logits away, and the worst parameters' gaps over the larger of
their reference norm and the median's, which in bf16 is the noise of the
squeeze-excitation convolutions' weight gradients, whose sums cancel.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Tuple

ROUNDOFF = 1e-3   # of the median parameter's gradient norm


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Iterable[str]) -> Tuple[float, str]:
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    worst = max(names, key=lambda n: abs(prog[n] - ref[n]) / max(ref[n], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst


def median_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The median parameter's |program - reference| / reference."""
    return statistics.median(abs(prog[n] - ref[n]) / ref[n] for n in names)


def rel_gap(prog, ref) -> float:
    """Largest ||program - reference|| / ||reference|| over a step's
    microbatches; inf where the program's tensors have other shapes."""
    if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return float("inf")
    return max(float((p.to(r.device, r.dtype) - r).norm() / r.norm())
               for p, r in zip(prog, ref))


def moved(grad_norms: Dict[str, float]):
    """The parameters whose reference gradient is at least ``ROUNDOFF`` of
    the median parameter's."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= ROUNDOFF * med]


def median_dir(prog: dict, ref: dict, names) -> float:
    """The median parameter's ||program - reference|| / ||reference||."""
    return statistics.median(
        float((prog[n].to(ref[n].device, ref[n].dtype) - ref[n]).norm() / ref[n].norm())
        for n in names)


def step_numbers(prog: dict, ref: dict, prefix: str = "", grad: str = "grad_dir"):
    """The numbers of one step: ``prog`` and ``ref`` each hold the step's
    "logits", "dlogits", "bev" (lists) and "grad" ({name: tensor})."""
    norms = {n: float(g.norm()) for n, g in ref["grad"].items()}
    return {prefix + "logits_gap": rel_gap(prog["logits"], ref["logits"]),
            prefix + "dlogits_gap": rel_gap(prog["dlogits"], ref["dlogits"]),
            prefix + "bev_gap": rel_gap(prog["bev"], ref["bev"]),
            prefix + grad: median_dir(prog["grad"], ref["grad"], moved(norms))}


def train_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, object]]:
    """({number: value}, {reading: value}) of one run: every number, and
    readings printed beside them (PERF.md says why): each step's loss gap
    and the worst parameters' gaps."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    names = list(ref["grad1"])
    keep = moved(ref["grad1"])
    numbers = step_numbers(prog["first"], ref["first"], grad="grad1_dir")
    numbers.update(grad1_gap=median_gap(prog["grad1"], ref["grad1"], keep),
                   change_gap=median_gap(prog["change"], ref["change"], keep),
                   **step_numbers(prog["after"], ref["after"], "after_"))
    readings = {"loss_gaps": gaps,
                "after_loss_gap": abs(prog["after"]["loss"] - ref["after"]["loss"])
                / abs(ref["after"]["loss"]),
                "grad1_worst": leaf_gap(prog["grad1"], ref["grad1"], names),
                "change_worst": leaf_gap(prog["change"], ref["change"], keep)}
    return numbers, readings
