"""The CUDA splat kernel and the port's model on the card. These need a
GPU and nvcc (they build lss_carla_torch/csrc/splat.cu); without a GPU
they skip. This file imports no JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
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
