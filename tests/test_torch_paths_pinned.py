"""The paths the benchmark's existing cells run, pinned: the operators that
the B0 serving program, the B0 and B4 train forwards and the B0 default
train step dispatch on the CPU, each against the sequence recorded at the
commit before the BEVFusion model came in (``tests/pinned_paths.py``
wrote ``tests/pinned_paths.json`` there). A model added beside LSS must
leave what these paths execute as it was; and ``make_train_step``'s
default loss is still ``SimpleLoss``'s weighted BCE. Imports no JAX."""

import json
from pathlib import Path

import pytest
import torch

from lss_carla_torch.training.loss import SimpleLoss
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step

import pinned_paths as P

PINNED = json.loads((Path(__file__).parent / "pinned_paths.json").read_text())


@pytest.mark.parametrize("path", sorted(P.PATHS))
def test_the_path_dispatches_the_pinned_operators(path):
    want = P.unpack(PINNED, path)
    got = P.PATHS[path]()
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
    assert got == want, (f"{path}: {len(got)} operators against {len(want)}; first "
                         f"difference at {first}: {got[first:first + 3]} against "
                         f"{want[first:first + 3]}")


def test_the_default_loss_is_simple_loss():
    """An LSS model names no loss: the step takes the weighted BCE, and
    its loss is ``SimpleLoss(pos_weight)`` of the forward's logits."""
    m = P.model("b0")
    step = make_train_step(m, 2.13, device="cpu")
    assert step.loss == "bce" and not hasattr(m, "loss")
    state = create_train_state(m, lr=0.0)
    b = P.batch()
    torch.manual_seed(1)
    loss = float(step(state, b)["loss"])
    torch.manual_seed(1)
    logits = m.train()(*b[:6])
    assert loss == pytest.approx(float(SimpleLoss(2.13)(logits.detach(), b[6])), rel=1e-6)
