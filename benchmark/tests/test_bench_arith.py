"""The yardstick's arithmetic on small shapes worked out by hand: FLOPs,
kernel byte bounds, the trace's busy union and idle gaps, the open-loop
schedule, latencies and the tail."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import openloop, roofline, trace
from benchmark.harness import judge
from benchmark.reference import lss
from conftest import TINY


def test_splat_bytes_by_hand():
    # 10 ids of 4 bytes, 6 in-grid points of 3 bf16 features, 2 x 5 slots out
    assert roofline.splat_bytes(6, 10, 3, 2, 2, 5) == 40 + 36 + 60
    assert roofline.splat_seconds(6, 10, 3, 2, 2, 5) == pytest.approx(136 / 3.35e12)


def test_dw_bytes_by_hand():
    # x 1x2x4x4, stride 2 -> y 1x2x2x2, k 3: (32 + 8) f32 + 2*9*4 + 2*2*4
    assert roofline.dw_bytes((1, 2, 4, 4), 3, 2, 4) == 160 + 72 + 16
    # the operations bound: 8 outputs x (2*9 + 3) over 67 TFLOP/s
    assert roofline.dw_seconds((1, 2, 4, 4), 3, 2, 4) == pytest.approx(
        max(248 / 3.35e12, 8 * 21 / 67e12))


def count(fn):
    c = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: roofline.conv_backward_flops})
    with c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("groups", [1, 4])
def test_conv_flops_forward_and_backward(groups):
    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    w = torch.randn(8, 8 // groups, 3, 3, requires_grad=True)
    out = {}
    fwd = count(lambda: out.setdefault("y", F.conv2d(x, w, padding=1, groups=groups)))
    # 2 per multiply-add: N * Cout * H * W * (Cin / groups) * k * k
    assert fwd == 2 * 2 * 8 * 36 * (8 // groups) * 9
    assert count(lambda: out["y"].sum().backward()) == 2 * fwd


def test_model_flops_of_the_tiny_model():
    cfg = dict(TINY)
    f = roofline.model_flops(cfg, 2, train=True)
    assert f["total"] == pytest.approx(3 * f["forward"], rel=0.05)
    # the BEV head alone, by hand: a 1x1 conv of 128 channels at 32 x 32
    assert f["forward"] > 2 * 2 * 1 * 32 * 32 * 128
    assert roofline.model_flops(cfg, 2, train=False)["forward"] == f["forward"]


def test_union_and_gaps():
    dev = [(0.0, 10.0, "a"), (5.0, 20.0, "b"), (30.0, 40.0, "a"), (90.0, 200.0, "c")]
    host = [(20.0, 30.0, "train_step", True), (0.0, 100.0, "loader.next", True),
            (40.0, 60.0, "aten::copy_", False)]
    s = trace.Summary(dev, host, (0.0, 100.0), 100e-6)
    assert s.busy_s == pytest.approx(40e-6)          # 0-20, 30-40, 90-100
    assert s.kernel("a") == (pytest.approx(20e-6), 2)
    assert s.gaps() == {"train_step": pytest.approx(10e-6),
                        "loader.next": pytest.approx(50e-6)}
    assert s.breakdown()["device_ops"][:2] == [["a", pytest.approx(20e-6)],
                                               ["b", pytest.approx(15e-6)]]


def test_active_names_picks_the_innermost():
    items = [(0, 10, "outer", 10), (2, 4, "inner", 2)]
    assert trace.active(items, [1, 3, 5, 11]) == ["outer", "inner", "outer", None]


def test_schedule_is_seeded_and_fixed_in_count():
    a, wa = openloop.schedule(2 ** 31 + 5, 90.0, 10.0, 64)
    b, wb = openloop.schedule(2 ** 31 + 5, 90.0, 10.0, 64)
    c, _ = openloop.schedule(2 ** 31 + 6, 90.0, 10.0, 64)
    assert np.array_equal(a, b) and np.array_equal(wa, wb)
    assert len(a) == len(c) == 900 and not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 10.0
    # arrivals of a Poisson process given its count: gaps about exponential
    gaps = np.diff(a)
    assert 0.8 < gaps.std() / gaps.mean() < 1.2
    # a traced run's traced part adds its own requests after the window's
    d, _ = openloop.schedule(2 ** 31 + 5, 90.0, 10.0, 64, extra_s=6.0)
    assert np.array_equal(d[:900], a)
    assert (d < 10.0).sum() == 900 and len(d) == 900 + 540


def test_latency_from_due_time_and_timeouts():
    due = np.array([0.0, 0.1, 0.2, 0.3])
    end = np.array([0.05, 0.6, 6.0, np.nan])     # the second waited behind a stall
    status = np.array([200, 200, 200, 0])
    lat = openloop.tail_latencies(due, end, status)
    assert lat == pytest.approx([50.0, 500.0, 5000.0, 5000.0])
    assert openloop.percentile(lat, 50) == 500.0
    assert openloop.percentile(list(range(1, 101)), 95) == 95


def test_judge():
    assert judge({"a": (0.1, 0.2)}) and not judge({"a": (0.3, 0.2)})
    assert not judge({"a": (float("nan"), 1.0)}) and not judge({})


def test_quantizers_round_and_pass_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    for q in (lss.rounded(torch.bfloat16), lss.fp8_e4m3):
        y = q(x)
        assert 0 < (y - x).abs().max() < 0.2
        y.sum().backward()
        assert torch.equal(x.grad, torch.ones_like(x))
        x.grad = None
