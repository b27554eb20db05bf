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
