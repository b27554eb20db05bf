"""The CUDA kernels (splat, depthwise conv + BN moments) and the port's
model on the card. These need a GPU and nvcc (they build
lss_carla_torch/csrc/*.cu); without a GPU they skip. This file imports no
JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import mbconv as M
from lss_carla_torch.ops import mbconv_cuda
from lss_carla_torch.ops import splat as S
from lss_carla_torch.ops import splat_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the splat kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 6])  # 4-wide vector path and scalar path
def test_kernel_matches_plain_version(cuda, dtype, C):
    g = torch.Generator(device="cuda").manual_seed(0)
    B, P, num_slots = 3, 5000, 700
    pts = torch.randn(B, P, C, generator=g, device=cuda).to(dtype)
    ids = torch.randint(0, num_slots + 1, (B, P), generator=g, device=cuda,
                        dtype=torch.int32)
    pts[ids == num_slots] = float("nan")  # sentinel points must not leak
    before = splat_cuda.launches
    got = splat_cuda.splat_forward(pts, ids, num_slots)
    torch.cuda.synchronize()
    assert splat_cuda.launches == before + 1
    want = S.splat_reference(pts, ids, num_slots)
    assert got.dtype == dtype and torch.isfinite(got).all()
    # ~7 points per slot, f32 sums in another order; bf16 rounds once more
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_kernel_refuses_what_it_does_not_take(cuda):
    pts = torch.zeros(1, 8, 4, device=cuda)
    ids = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        splat_cuda.splat_forward(pts.half(), ids, 4)
    with pytest.raises(TypeError):
        splat_cuda.splat_forward(pts, ids.long(), 4)
    with pytest.raises(ValueError):
        splat_cuda.splat_forward(pts.transpose(1, 2), ids, 4)
    with pytest.raises(ValueError):
        splat_cuda.splat_forward(pts, ids.cpu(), 4)


def test_tiny_model_on_card_matches_cpu(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    grid = GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                    zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 36.0, 8.0))
    aug = DataAugConf(H=64, W=128, final_dim=(32, 64))
    model = compile_model(grid, aug, variant="slim", device="cpu").eval()
    rng = np.random.default_rng(0)
    B, N = 2, 6
    x = torch.from_numpy(rng.normal(size=(B, N, 3, 32, 64)).astype(np.float32))
    eye = torch.eye(3).expand(B, N, 3, 3).contiguous()
    # cameras looking along ego x, 1.5 m up, so the frustums land in the grid
    rots = torch.tensor([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]]).expand(
        B, N, 3, 3).contiguous()
    trans = torch.zeros(B, N, 3)
    trans[..., 2] = 1.5
    intr = eye * 60.0
    intr[..., 2, 2] = 1.0
    intr[..., 0, 2], intr[..., 1, 2] = 32.0, 16.0
    zero = torch.zeros(B, N, 3)
    args = (x, rots, trans, intr, eye, zero)
    with torch.no_grad():
        want = model(*args)
        before = splat_cuda.launches
        got = model.to(cuda)(*(a.to(cuda) for a in args)).cpu()
    assert splat_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


# (N, C, H, W) per (k, s): odd and even sizes, so the asymmetric SAME
# padding lands on both sides; C 40 > one warp of channels
DW_SHAPES = [(3, 40, 17, 23), (2, 40, 16, 22), (4, 8, 64, 176)]


def _dw_tolerance(x, w, stride):
    """Kernel vs plain version: both sum the k*k taps of each output in f32
    in some order, within 2 k^2 u sum|x w| (u = 2^-24) of each other; bf16
    y rounds once more (one bf16 ulp, 2^-8 relative). The moments sum
    N*Ho*Wo f32 terms in other orders: 2 n u sum|y| (and y^2)."""
    k = w.shape[-1]
    absy = M.dw_conv_stats_reference(x.abs(), w.abs(), stride)[0].float()
    return 2 * k * k * 2.0 ** -24 * absy + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_kernel_matches_plain_version(cuda, dtype, k, s, shape):
    g = torch.Generator(device="cuda").manual_seed(k * 10 + s)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[1], 1, k, k, generator=g, device=cuda)
    before = mbconv_cuda.launches
    y, s1, s2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    torch.cuda.synchronize()
    assert mbconv_cuda.launches == before + 1
    ry, rs1, rs2 = M.dw_conv_stats_reference(x, w, s)
    assert y.shape == ry.shape and y.dtype == dtype
    assert torch.isfinite(y).all() and torch.isfinite(s1).all()
    bound = _dw_tolerance(x, w, s)
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * ry.float().abs()
    assert ((y.float() - ry.float()).abs() <= bound).all()
    n = ry.numel() // ry.shape[1]
    y32 = M.dw_conv_stats_reference(x, w, s)[0].float()
    tol1 = 2 * n * 2.0 ** -24 * y32.abs().sum((0, 2, 3)) + 1e-5
    assert ((s1 - rs1).abs() <= tol1).all()
    assert ((s2 - rs2).abs() <= 2 * n * 2.0 ** -24 * rs2.abs() + 1e-5).all()
    # bit-reproducible: no atomics
    y2, t1, t2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    assert torch.equal(y, y2) and torch.equal(s1, t1) and torch.equal(s2, t2)


@pytest.mark.parametrize("k,s", [(3, 2), (5, 1)])
def test_dw_function_gradients_match_plain_autograd(cuda, k, s):
    """dx, dw through the autograd Function (kernel forward) against
    autograd through the plain version, for a loss that reads y and both
    moments."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 24, 15, 18, generator=g, device=cuda)
    w = torch.randn(24, 1, k, k, generator=g, device=cuda)
    r = torch.randn(2, 24, -(-15 // s), -(-18 // s), generator=g, device=cuda)

    def loss(fn, xx, ww):
        y, s1, s2 = fn(xx, ww, s)
        return (y * r).sum() + s1.sum() * 0.3 + s2.sum() * 0.01

    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss(M.dw_conv_stats, xa, wa).backward()
    loss(M.dw_conv_stats_reference, xb, wb).backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-4, atol=1e-3)


def test_dw_kernel_odd_shapes_are_finite(cuda):
    for shape, k, s in (((1, 1, 1, 1), 3, 2), ((1, 3, 2, 5), 5, 1),
                        ((3, 5, 9, 1), 5, 2)):
        x = torch.randn(*shape, device=cuda)
        y, s1, s2 = mbconv_cuda.dw_conv_stats_forward(
            x, torch.randn(shape[1], 1, k, k, device=cuda), s)
        torch.cuda.synchronize()
        assert y.shape[2:] == (-(-shape[2] // s), -(-shape[3] // s))
        assert torch.isfinite(y).all() and torch.isfinite(s1).all()
        assert torch.isfinite(s2).all()


def test_dw_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 4, 8, 8, device=cuda)
    w = torch.zeros(4, 1, 3, 3, device=cuda)
    before = mbconv_cuda.launches
    with pytest.raises(TypeError):
        mbconv_cuda.dw_conv_stats_forward(x.half(), w, 1)
    with pytest.raises(ValueError):
        mbconv_cuda.dw_conv_stats_forward(x, torch.zeros(4, 1, 7, 7, device=cuda), 1)
    with pytest.raises(ValueError):
        mbconv_cuda.dw_conv_stats_forward(x, w, 3)
    with pytest.raises(ValueError):
        mbconv_cuda.dw_conv_stats_forward(x.transpose(2, 3), w, 1)
    with pytest.raises(ValueError):
        mbconv_cuda.dw_conv_stats_forward(x, w.cpu(), 1)
    with pytest.raises(TypeError):  # no fallback through the Function either
        M.dw_conv_stats(x.double(), w.double(), 1)
    assert mbconv_cuda.launches == before


def test_fused_trunk_launch_count(cuda):
    """A train-mode slim trunk with fused_dw launches the kernel once per
    MBConv block and forward; eval mode never."""
    from lss_carla_torch.models.efficientnet import EfficientNetTrunk, block_plan
    trunk = EfficientNetTrunk("slim", fused_dw=True).to(cuda)
    x = torch.randn(2, 3, 32, 64, device=cuda)
    before = mbconv_cuda.launches
    trunk.train()(x)
    assert mbconv_cuda.launches == before + len(block_plan("slim"))
    with torch.no_grad():
        trunk.eval()(x)
    assert mbconv_cuda.launches == before + len(block_plan("slim"))


def _splat_bound(pts, ids, num_slots):
    """Kernel vs plain version: each sums a slot's n points in f32 in some
    order, within (n - 1) u sum|x| of the exact sum (u = 2^-24); bf16
    rounds once more (2^-8 relative)."""
    count = S.splat_reference(torch.ones_like(pts[..., :1], dtype=torch.float32),
                              ids, num_slots)
    abs_sum = S.splat_reference(torch.nan_to_num(pts.float()).abs(), ids, num_slots)
    return 2 * count.clamp(min=1) * 2.0 ** -24 * abs_sum + 1e-6


@pytest.mark.parametrize("case", ["ragged_tiles", "one_id", "all_sentinel",
                                  "scalar_c6", "stretch_grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_tile_edges(cuda, case, dtype):
    """The tile-sorted kernel at its edges: P not a multiple of the tile,
    every point on one id (the worst contention), every point at the
    sentinel, C = 6 (the scalar path), and S = 160,000."""
    g = torch.Generator(device="cuda").manual_seed(3)
    B, P, C, num_slots = 2, 3 * splat_cuda.TILE + 77, 64, 700
    if case == "scalar_c6":
        C = 6
    if case == "stretch_grid":
        B, P, num_slots = 2, 43296, 160000
    pts = torch.randn(B, P, C, generator=g, device=cuda).to(dtype)
    ids = torch.randint(0, num_slots + 1, (B, P), generator=g, device=cuda,
                        dtype=torch.int32)
    if case == "one_id":
        ids.fill_(num_slots // 2)
    elif case == "all_sentinel":
        ids.fill_(num_slots)
    pts[ids == num_slots] = float("nan")
    got = splat_cuda.splat_forward(pts, ids, num_slots)
    torch.cuda.synchronize()
    want = S.splat_reference(pts, ids, num_slots)
    assert got.dtype == dtype and torch.isfinite(got).all()
    bound = _splat_bound(pts, ids, num_slots)
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.float().abs()
    assert ((got.float() - want.float()).abs() <= bound).all()
    if case == "all_sentinel":
        assert not got.any()


# (N, C, H, W): a plane cut into several bands; several images a block;
# W 11 and 177 (odd, not a multiple of 4)
DW_TILE_SHAPES = [(2, 8, 64, 176), (24, 16, 8, 22), (3, 5, 9, 11),
                  (2, 4, 13, 177)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("shape", DW_TILE_SHAPES)
def test_dw_kernel_tiles_match_plain_version(cuda, dtype, k, s, shape):
    plan = mbconv_cuda.plan_tiles(*shape, k, s)
    if shape[2] == 64:
        assert plan.bands > 1 or s == 2
    if shape[0] == 24:
        assert plan.pb > 1
    g = torch.Generator(device="cuda").manual_seed(k * 10 + s)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[1], 1, k, k, generator=g, device=cuda)
    y, s1, s2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    torch.cuda.synchronize()
    ry, rs1, rs2 = M.dw_conv_stats_reference(x, w, s)
    bound = _dw_tolerance(x, w, s)
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * ry.float().abs()
    assert ((y.float() - ry.float()).abs() <= bound).all()
    n = ry.numel() // ry.shape[1]
    y32 = M.dw_conv_stats_reference(x, w, s)[0].float()
    assert ((s1 - rs1).abs() <= 2 * n * 2.0 ** -24 * y32.abs().sum((0, 2, 3))
            + 1e-5).all()
    assert ((s2 - rs2).abs() <= 2 * n * 2.0 ** -24 * rs2.abs() + 1e-5).all()
    y2, t1, t2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    assert torch.equal(y, y2) and torch.equal(s1, t1) and torch.equal(s2, t2)


@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_dw_kernel_bf16_starting_mid_word(cuda, k, s):
    """bf16 x whose first element sits at an odd element address: the
    kernel copies whole 4-byte words and must pick the right halves."""
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (3, 6, 9, 11)
    store = torch.randn(int(np.prod(shape)) + 1, generator=g, device=cuda)
    x = store.to(torch.bfloat16)[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 4 == 2
    w = torch.randn(6, 1, k, k, generator=g, device=cuda)
    y, s1, s2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    ry, rs1, rs2 = M.dw_conv_stats_reference(x, w, s)
    bound = _dw_tolerance(x, w, s) + 2.0 ** -8 * ry.float().abs()
    assert ((y.float() - ry.float()).abs() <= bound).all()
    torch.testing.assert_close(s1, rs1, rtol=1e-4, atol=1e-3)


def test_dw_kernel_is_one_device_activity_a_call(cuda):
    """The wrapper puts exactly one kernel on the card a call: no weight
    cast, no scratch fill, no second (finalize) launch. The profiler may
    lose the activity records near a window's edges
    (``chip_smoke.profile_window``), so the calls sit between host sleeps,
    and a window that counts fewer than n is profiled again, up to three in
    all; in every window the device activity is the one kernel and at most
    n."""
    import time

    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(24, 96, 64, 176, device=cuda)
    w = torch.randn(96, 1, 3, 3, device=cuda)
    for _ in range(2):  # the scratch buffer is made on the first call
        mbconv_cuda.dw_conv_stats_forward(x, w, 2)
    torch.cuda.synchronize()
    n, keys, counts = 5, set(), []
    dev = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5)
            for _ in range(n):
                mbconv_cuda.dw_conv_stats_forward(x, w, 2)
            torch.cuda.synchronize()
            time.sleep(0.5)
        events = [e for e in prof.key_averages() if e.device_type == dev
                  and not getattr(e, "is_user_annotation", False)]
        keys |= {e.key for e in events}
        counts.append(sum(e.count for e in events))
        assert counts[-1] <= n, [(e.key, e.count) for e in events]
        if counts[-1] == n:
            break
    assert len(keys) == 1 and "dw_conv_stats_kernel" in keys.pop(), keys
    assert max(counts) > 0, counts


def _b4_dw_shapes(N=24, H=64, W=176):
    """{(k, s, (N, C, H, W)): blocks} of the B4 trunk's depthwise convs
    from the stem's output (6 cameras at 128 x 352 -> 64 x 176)."""
    from lss_carla_torch.models.efficientnet import block_plan
    shapes = {}
    for i, a in enumerate(block_plan("b4")):
        key = (a["kernel"], a["stride"], (N, a["cin"] * a["expand"], H, W))
        shapes.setdefault(key, []).append(i)
        H, W = -(-H // a["stride"]), -(-W // a["stride"])
    return shapes


# the first, a stride-2 band case, and the widest late planes (C 1,632 and
# 2,688 at 4 x 11: several images packed a block)
B4_DW_CASES = [(3, 1, (24, 48, 64, 176)), (5, 2, (24, 960, 8, 22)),
               (5, 1, (24, 1632, 4, 11)), (3, 1, (24, 2688, 4, 11))]


@pytest.mark.parametrize("k,s,shape", B4_DW_CASES)
def test_dw_kernel_b4_shapes_bf16(cuda, k, s, shape):
    """The kernel in bf16 at B4's shapes against its plain version, with
    the launch counted as bf16."""
    assert (k, s, shape) in _b4_dw_shapes()
    g = torch.Generator(device="cuda").manual_seed(shape[1])
    x = torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    w = 0.3 * torch.randn(shape[1], 1, k, k, generator=g, device=cuda)
    before = dict(mbconv_cuda.launches_by_dtype)
    y, s1, s2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    torch.cuda.synchronize()
    assert mbconv_cuda.launches_by_dtype["bfloat16"] == before["bfloat16"] + 1
    assert mbconv_cuda.launches_by_dtype["float32"] == before["float32"]
    ry, rs1, rs2 = M.dw_conv_stats_reference(x, w, s)
    bound = _dw_tolerance(x, w, s) + 2.0 ** -8 * ry.float().abs()
    assert y.dtype == torch.bfloat16
    assert ((y.float() - ry.float()).abs() <= bound).all()
    n = ry.numel() // ry.shape[1]
    y32 = M.dw_conv_stats_reference(x, w, s)[0].float()
    assert ((s1 - rs1).abs() <= 2 * n * 2.0 ** -24 * y32.abs().sum((0, 2, 3))
            + 1e-5).all()
    assert ((s2 - rs2).abs() <= 2 * n * 2.0 ** -24 * rs2.abs() + 1e-5).all()


def test_launch_counters_by_dtype(cuda):
    """Each wrapper counts its launches by input dtype beside the total;
    reset_launches zeroes both."""
    for mod in (splat_cuda, mbconv_cuda):
        mod.reset_launches()
        assert mod.launches == 0 and set(mod.launches_by_dtype.values()) == {0}
    ids = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    x = torch.randn(2, 4, 8, 8, device=cuda)
    w = torch.randn(4, 1, 3, 3, device=cuda)
    for dtype in (torch.float32, torch.bfloat16, torch.bfloat16):
        splat_cuda.splat_forward(torch.ones(1, 8, 4, device=cuda, dtype=dtype), ids, 4)
        mbconv_cuda.dw_conv_stats_forward(x.to(dtype), w, 1)
    for mod in (splat_cuda, mbconv_cuda):
        assert mod.launches == 3
        assert mod.launches_by_dtype == {"float32": 1, "bfloat16": 2}


def test_bf16_model_launches_bf16_kernels(cuda):
    """A bf16 slim LSS with fused_dw, one train step on the card: every
    kernel launch is bf16, one depthwise launch a block and one splat."""
    from lss_carla_torch.models.efficientnet import block_plan
    from lss_carla_torch.training.state import create_train_state
    from lss_carla_torch.training.step import make_train_step
    grid = GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                    zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 36.0, 8.0))
    aug = DataAugConf(H=64, W=128, final_dim=(32, 64))
    model = compile_model(grid, aug, variant="slim", fused_dw=True,
                          compute_dtype="bfloat16", device=cuda)
    B, N = 2, 6
    eye = torch.eye(3, device=cuda).expand(B, N, 3, 3).contiguous()
    intr = eye * 60.0
    intr[..., 2, 2] = 1.0
    batch = (torch.randn(B, N, 3, 32, 64, device=cuda), eye,
             torch.zeros(B, N, 3, device=cuda), intr, eye,
             torch.zeros(B, N, 3, device=cuda),
             (torch.rand(B, 1, 16, 16, device=cuda) < 0.2).float())
    for mod in (splat_cuda, mbconv_cuda):
        mod.reset_launches()
    metrics = make_train_step(model, device=cuda)(create_train_state(model), batch)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert mbconv_cuda.launches_by_dtype == {"float32": 0,
                                             "bfloat16": len(block_plan("slim"))}
    assert splat_cuda.launches_by_dtype == {"float32": 0, "bfloat16": 1}
