"""The plain reference agrees with lss_carla_torch at a slim size on the
same seeded weights: the eval forward on uint8 and float images, and three
training steps through the benchmark's own training driver in f32 (dropout
followed through the recorded masks)."""

import numpy as np
import pytest
import torch

from benchmark.drivers import train
from benchmark.fixture import rig
from benchmark.harness import judge
from benchmark.reference import lss
from benchmark.weights import make_weights
from conftest import TINY


def port_model(cfg, weights):
    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.models.lss import LiftSplatShoot
    model = LiftSplatShoot(GridConf(**{k: tuple(v) for k, v in cfg["grid"].items()}),
                           DataAugConf(final_dim=tuple(cfg["final_dim"])),
                           outC=cfg["outC"], variant=cfg["variant"])
    model.load_state_dict(weights)
    return model.eval()


def test_the_port_loads_the_benchmark_weights_by_name():
    w = make_weights(TINY, 1, "cpu")
    assert set(port_model(TINY, w).state_dict()) == set(w)


@pytest.mark.parametrize("uint8", [True, False])
def test_eval_forward_agrees(uint8):
    cfg = dict(TINY, outC=2)
    w = make_weights(cfg, 2 ** 31 + 1, "cpu", random_bn=True)
    rng = np.random.default_rng(0)
    imgs = (torch.from_numpy(rng.integers(0, 256, (2, 6, 3, 64, 128), dtype=np.uint8))
            if uint8 else torch.randn(2, 6, 3, 64, 128))
    batch = [imgs] + [torch.from_numpy(a) for a in rig(rng, 2, 6, (64, 128))]
    with torch.no_grad():
        got = port_model(cfg, w)(*batch)
        want = lss.forward(w, cfg, batch)
    assert got.shape == want.shape == (2, 2, 32, 32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_weights_are_seeded():
    a, b = make_weights(TINY, 9, "cpu"), make_weights(TINY, 9, "cpu")
    c = make_weights(TINY, 10, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not all(torch.equal(a[n], c[n]) for n in a)


def test_three_f32_steps_agree(tiny_cell):
    run = train.run(tiny_cell("b0-fast-train", "simbev-fixture", compute_dtype="float32",
                              bsz=2, nworkers=2))
    c = run.layer["check"]["numbers"]
    # f32 against f32: summation order only; the tiny batch of 2 puts the
    # train-mode BN near its f32 floor (gradients reached 3.7e-4 here)
    assert c["logits_gap"] < 1e-4 and c["grad1_gap"] < 5e-3 and c["change_gap"] < 5e-3, c
    assert c["dlogits_gap"] < 1e-4 and c["bev_gap"] < 1e-4 and c["grad1_dir"] < 5e-3, c
    # the step after the window, followed from the weights the program reached
    assert c["after_logits_gap"] < 1e-4 and c["after_dlogits_gap"] < 1e-4, c
    assert c["after_bev_gap"] < 1e-4 and c["after_grad_dir"] < 5e-3, c
    assert c["image_levels"] <= 2.0
    assert judge(run.checks)
