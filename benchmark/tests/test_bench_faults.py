"""The check itself: a run whose timed path is broken underneath comes out
not correct under the cell's own limits, once for each fault the cell can
have, with the chip's look skipped and everything else of a run driven
(on the CPU, at the tiny size): a training state left unchanged; half of
each batch left out of the loss, from the first step, and from the fourth
on, after the steps that set-up checks, which only the step after the
window sees; a served answer altered. And the control, the reference in
the next precision down put in the program's place, fails the limits at a
size a test run can hold."""

import pytest
import torch

from benchmark import compare
from benchmark.drivers import serve, train
from benchmark.harness import judge
from benchmark.reference import lss


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "late_half_batch"])
@pytest.mark.parametrize("workload,traffic,work", [
    ("b0-fast-train", "simbev-fixture", {"bsz": 2, "nworkers": 2}),
    ("stretch-train", "staged-3pct", {"bsz": 2})])
def test_training_faults_are_not_correct(tiny_cell, workload, traffic, work, fault):
    run = train.run(tiny_cell(workload, traffic, fault=fault,
                              compute_dtype="float32", **work))
    assert not judge(run.checks), run.checks


def test_serving_answer_altered_is_not_correct(tiny_cell):
    run = serve.run(tiny_cell("b0-serve-overload", "poisson-overload", seconds=1.0,
                              fault="answer_altered"))
    assert not judge(run.checks), run.checks


@pytest.mark.parametrize("workload,traffic,work", [
    ("b0-fast-train", "simbev-fixture", {"bsz": 2, "nworkers": 2}),
    ("stretch-train", "staged-3pct", {"bsz": 2})])
def test_training_control_is_not_correct(tiny_cell, workload, traffic, work):
    """fp8 e4m3 convolution operands in the program's place, against the
    limits of a bf16 cell, with the B0 trunk (the slim one is too shallow
    to amplify fp8's rounding as the cells' trunks do)."""
    cell = tiny_cell(workload, traffic, seconds=0.0, **work)
    cell.config["variant"] = "b0"
    run = train.run(cell)
    chk = run.layer["check"]
    control = train.reference(cell, torch.device("cpu"), chk["checked"], chk["masks"],
                              chk["after"], lss.fp8_e4m3)
    numbers, _ = compare.train_numbers(control, chk["ref"])
    limits = {k: v for k, v in cell.work["limits"].items() if k != "image_levels"}
    assert not judge({k: (numbers[k], v) for k, v in limits.items()}), numbers


def test_serving_control_is_not_correct(tiny_cell):
    """bf16 convolution operands in the program's place, against the
    limits of the f32 serving cell."""
    cell = tiny_cell("b0-serve-overload", "poisson-overload", seconds=1.0)
    run = serve.run(cell)
    chk = run.layer["check"]
    control = serve.reference_answers(cell, torch.device("cpu"), chk["ids"],
                                      (lss.rounded(torch.bfloat16),))[0]
    numbers = serve.logit_numbers(chk["ids"], [control[int(i)] for i in chk["ids"]],
                                  chk["want"], chk["scale"])
    numbers["unanswered"] = 0.0
    assert not judge({k: (numbers[k], v) for k, v in cell.work["limits"].items()}), numbers
