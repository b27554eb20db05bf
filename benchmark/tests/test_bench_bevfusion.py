"""The ``bevfusion-seg-train`` cell's driver, reference and readers on the
CPU, at a small size (2 cameras at 64 x 176, a 40 x 40 lift grid, a 30 x 30
output, BEVFusion's widths): three f32 steps of the port agree with the
plain reference through the driver's own check; the planted faults and
the fp8 control are not correct under the cell's limits; the FLOP count
at the published shapes; the two new readers."""

import json

import pytest
import torch

from benchmark.drivers import train_bevfusion as drv
from benchmark.harness import BENCH, Cell, judge, load_reader, process_start, read_json
from benchmark.reference import bevfusion as ref
from benchmark.reference.lss import fp8_e4m3


def tiny_config():
    cfg = read_json(BENCH / "configs" / "bevfusion-cam-seg.json")
    cfg = json.loads(json.dumps(cfg))
    cfg.update(image_size=[64, 176], ncams=2)
    cfg["vtransform"].update(xbound=[-8.0, 8.0, 0.4], ybound=[-8.0, 8.0, 0.4],
                             dbound=[1.0, 20.0, 2.0])
    cfg["head"].update(input_scope=[[-8.0, 8.0, 0.8]] * 2, output_scope=[[-7.5, 7.5, 0.5]] * 2)
    return cfg


def tiny_cell(fault=None, **work):
    torch.set_num_threads(4)
    w = dict(read_json(BENCH / "workloads" / "bevfusion-seg-train.json"), **{"bsz": 1, **work})
    t = dict(read_json(BENCH / "traffic" / "staged-map6.json"), batches=2,
             source_image=[180, 400], crop=[8, 22])
    return Cell("bevfusion-seg-train", 2 ** 31 + 11, 1.0, False, {}, tiny_config(), t, w,
                device="cpu", start=process_start(), fault=fault)


# AdamW's decay scales a weight by 1 - lr x 0.01, which float32 leaves at 1
# under lr ~6e-6 (the tiny cell's warm-up): the decay's fault is planted
# past a warm-up of one step, at lr 2e-4, as after the cell's window
PAST_WARMUP = dict(read_json(BENCH / "workloads" / "bevfusion-seg-train.json")["optimizer"],
                   warmup_steps=1)


@pytest.mark.parametrize("work", [{}, {"optimizer": PAST_WARMUP}], ids=["warm-up", "past"])
def test_three_f32_steps_agree(work):
    """f32 against f32, the draws followed: every compared number far
    under its limit (train-mode BN over one sample's planes puts the
    gradients' norms near 1e-3 of each other at most), in the warm-up and
    past it, where the decay's fault reads some 20 units."""
    run = drv.run(tiny_cell(compute_dtype="float32", **work))
    c = run.layer["check"]["numbers"]
    assert judge(run.checks), run.checks
    assert c["dlogits_gap"] < 1e-3 and c["bev_gap"] < 1e-4 and c["after_dlogits_gap"] < 1e-3
    assert c["grad1_gap"] < 1e-2 and c["change_gap"] < 1e-2
    # the step with no hook (eager here, as the window's steps): its
    # gradient by its redrawn draws, and its update within a float32 unit
    assert c["replay_grad_dir"] < 5e-2 and c["replay_update_ulps"] < 1.0
    assert run.layer["check"]["prog"]["after"]["redrawn"]
    assert run.layer["windows_per_forward"] == {"plain": 72, "shifted": 72}
    assert run.layer["attention_calls_per_forward"] == 12


@pytest.mark.parametrize("fault,work", [("state_unchanged", {}), ("half_batch", {}),
                                        ("late_half_batch", {}), ("late_lr_frozen", {}),
                                        ("late_no_decay", {"optimizer": PAST_WARMUP})],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_faults_are_not_correct(fault, work):
    run = drv.run(tiny_cell(fault=fault, compute_dtype="float32", bsz=2, **work))
    assert not judge(run.checks), run.checks


def test_redraw_follows_a_forwards_draws():
    """``redraw`` from the generator's state before a step gives the draws
    that the step's forward took, by module, in the Recorder's form."""
    cell = tiny_cell(compute_dtype="float32", bsz=2)
    dev = torch.device("cpu")
    model, state, step = drv.build(cell, dev)
    feed = drv.staged_feed(cell, dev)
    rec = drv.Recorder(model)
    rec.on = True
    start = drv.rng_state(dev)
    step(state, next(feed))
    drops = {n: m.p for n, m in model.named_modules() if n in rec.forwards[0]}
    order = [(n, keep.numel(), drops[n]) for n, keep in rec.forwards[0].items()]
    again = drv.redraw(order, 1, start, dev)[0]
    assert len(order) == 22 and list(again) == list(rec.forwards[0])
    assert all(torch.equal(again[n], rec.forwards[0][n]) for n in again)
    assert not all(bool(k.all()) for k in again.values())   # some samples dropped


def test_the_control_is_not_correct():
    """fp8 e4m3 in the program's place against the f32 reference fails
    the cell's limits."""
    cell = tiny_cell(compute_dtype="float32")
    run = drv.run(cell)
    chk = run.layer["check"]
    control = drv.reference(cell, torch.device("cpu"), chk["checked"], chk["masks"],
                            chk["after"], fp8_e4m3, chk["replay"])
    numbers, _ = drv.numbers(control, chk["ref"])
    assert not judge({k: (numbers[k], lim) for k, lim in cell.work["limits"].items()}), numbers


def test_flops_at_the_published_shapes():
    """The reference's forward and backward at bsz 4, counted on the meta
    device: Swin-T over 24 images at 256 x 704 and the BEV decoder and
    head, some 4 TFLOP."""
    cfg = read_json(BENCH / "configs" / "bevfusion-cam-seg.json")
    flops = drv.model_flops(cfg, 4)
    assert 2e12 < flops < 8e12, flops
    assert len(ref.param_shapes(cfg)) == 341


class FakeTrace:
    busy_s = 2.0

    def __init__(self, kernels):
        self.kernels = kernels

    def kernel(self, needle):
        hits = [s for n, s in self.kernels if needle in n]
        return sum(hits), len(hits)


def test_the_readers():
    per = {"plain": 9504, "shifted": 9504}
    run = {"trace": FakeTrace([("fmha_cutlassF_bf16", 0.1)] * 12 * 3
                              + [("fmha_cutlassB_bf16", 0.2)] * 12 * 3
                              + [("splat_kernel_segments", 0.001)] * 3),
           "forwards": 3, "traced_steps": 3, "windows_per_forward": per,
           "windows": {k: 3 * v for k, v in per.items()}, "attention_calls_per_forward": 12}
    assert load_reader("window_attention_pct.train")(run) == pytest.approx(100 * 10.8 / 2.0)
    assert load_reader("lift_splat_device_ms.train")(run) == pytest.approx(1.0)
    assert load_reader("window_attention_pct.train")(dict(run, windows=per)) is None
    # half the blocks on SDPA's math path: 6 fused launches a forward each
    # way, a multiple of the forwards all the same
    half = FakeTrace([("fmha_cutlassF_bf16", 0.1)] * 6 * 3 + [("fmha_cutlassB_bf16", 0.2)] * 6 * 3)
    assert load_reader("window_attention_pct.train")(dict(run, trace=half)) is None
    no_backward = FakeTrace([("fmha_cutlassF_bf16", 0.1)] * 12 * 3)
    assert load_reader("window_attention_pct.train")(dict(run, trace=no_backward)) is None
    assert load_reader("window_attention_pct.train")(
        {k: v for k, v in run.items() if k != "attention_calls_per_forward"}) is None
    assert load_reader("lift_splat_device_ms.train")(dict(run, forwards=2)) is None
    assert load_reader("window_attention_pct.train")({"trace": None}) is None
