"""lss_carla_torch model modules against their JAX counterparts, in eval
mode, on the same numpy-seeded inputs and weights (JAX random init with
numpy-randomised BN, carried across by the port's converter). Tolerances
atol 2e-4, rtol 1e-3, as in test_full_model_parity.py: XLA:CPU and
PyTorch's CPU convs sum in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.models import bevencode as JB
from lss_carla_tpu.models import camencode as JC
from lss_carla_tpu.models import efficientnet as JE
from lss_carla_tpu.ops import geometry as JG
from lss_carla_tpu.ops import image as JI

from lss_carla_torch.models.bevencode import BevEncode
from lss_carla_torch.models.camencode import CamEncode
from lss_carla_torch.models.efficientnet import (
    EfficientNetTrunk, MBConvBlock, endpoint_channels)
from lss_carla_torch.ops import geometry as G
from lss_carla_torch.ops import image as I
from lss_carla_torch.utils import convert as C

from test_torch_convert import load_port, randomize_variables

TOL = dict(atol=2e-4, rtol=1e-3)


def _jax_run(module, x, rng):
    """Init ``module`` on x (jitted: eager init costs seconds of op-by-op
    compiles), randomise its BN, apply it in eval mode. Returns (variables,
    output)."""
    init = jax.jit(module.init, static_argnums=2)
    variables = randomize_variables(
        init(jax.random.PRNGKey(int(rng.integers(1 << 30))), jnp.asarray(x),
             False), rng)
    out = jax.jit(module.apply, static_argnums=2)(variables, jnp.asarray(x),
                                                  False)
    return variables, out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# (expand, kernel, stride, cin, cout, H, W): k 3 and 5, stride 1 and 2, odd
# and even sizes, so XLA's asymmetric SAME padding is exercised both ways
MBCONV_CASES = [
    (1, 3, 1, 8, 8, 9, 10),
    (6, 3, 1, 8, 8, 8, 8),
    (6, 3, 2, 8, 16, 9, 11),
    (6, 3, 2, 8, 16, 10, 12),
    (6, 5, 1, 8, 16, 7, 8),
    (6, 5, 2, 8, 16, 11, 9),
    (6, 5, 2, 8, 16, 12, 16),
]


@pytest.mark.parametrize("expand,k,s,cin,cout,H,W", MBCONV_CASES)
def test_mbconv_block(rng, expand, k, s, cin, cout, H, W):
    x = rng.normal(size=(2, H, W, cin)).astype(np.float32)
    jm = JE.MBConvBlock(expand=expand, kernel=k, stride=s, cin=cin, cout=cout)
    variables, want = _jax_run(jm, x, rng)
    want = np.asarray(want)
    tm = load_port(MBConvBlock(expand, k, s, cin, cout), variables,
                   C.mbconv_name_map(expand))
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-H // s), -(-W // s), cout)
    np.testing.assert_allclose(got, want, **TOL)


def test_slim_trunk_endpoints(rng):
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    jm = JE.EfficientNetTrunk(variant="slim")
    variables, want = _jax_run(jm, x, rng)
    tm = load_port(EfficientNetTrunk("slim"), variables,
                   C.trunk_name_map("slim"))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert list(got) == list(want) == [f"reduction_{i}" for i in range(1, 6)]
    chans = endpoint_channels("slim")
    for name, w in want.items():
        g = got[name].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape and g.shape[-1] == chans[name]
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)


def test_camencode(rng):
    D, Cc = 4, 16
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    jm = JC.CamEncode(D=D, C=Cc, variant="slim")
    variables, (want, want_depth) = _jax_run(jm, x, rng)
    tm = load_port(CamEncode(D, Cc, "slim"), variables,
                   C.camencode_name_map("slim"))
    with torch.no_grad():
        got, depth = tm(_nchw(x))
    assert got.shape == want.shape == (2, D, 2, 4, Cc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(depth.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_depth), **TOL)


def test_bevencode(rng):
    x = rng.normal(size=(2, 16, 16, 12)).astype(np.float32)  # (B, X, Y, inC)
    jm = JB.BevEncode(outC=2)
    variables, want = _jax_run(jm, x, rng)
    want = np.asarray(want)
    tm = load_port(BevEncode(12, 2), variables, C.bevencode_name_map())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_get_geometry(rng):
    B, N = 2, 3
    frustum = JG.create_frustum((32, 64), 16, (4.0, 36.0, 8.0))
    rots = np.linalg.qr(rng.normal(size=(B, N, 3, 3)))[0].astype(np.float32)
    trans = rng.normal(size=(B, N, 3)).astype(np.float32)
    intrins = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intrins[..., 0, 0] = intrins[..., 1, 1] = rng.uniform(50, 80, (B, N))
    intrins[..., 0, 2], intrins[..., 1, 2] = 32.0, 16.0
    post_rots = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    post_rots[..., :2, :2] *= rng.uniform(0.8, 1.2, (B, N, 1, 1))
    post_trans = rng.normal(0, 3, size=(B, N, 3)).astype(np.float32)
    post_trans[..., 2] = 0
    args = (rots, trans, intrins, post_rots, post_trans)
    want = np.asarray(JG.get_geometry(jnp.asarray(frustum),
                                      *map(jnp.asarray, args)))
    got = G.get_geometry(torch.from_numpy(frustum),
                         *map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == (B, N, 4, 2, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_frustum_and_grid_constants_are_copies():
    for got, want in zip(G.gen_dx_bx((-50, 50, 0.5), (-50, 50, 0.5), (-10, 10, 20)),
                         JG.gen_dx_bx((-50, 50, 0.5), (-50, 50, 0.5), (-10, 10, 20))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(G.create_frustum((128, 352), 16, (4, 45, 1)),
                                  JG.create_frustum((128, 352), 16, (4, 45, 1)))


def test_image_ops(rng):
    u8 = rng.integers(0, 256, size=(2, 3, 5, 7), dtype=np.uint8)
    want = JI.normalize_img(u8.transpose(0, 2, 3, 1))
    got = I.normalize_uint8(torch.from_numpy(u8)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)  # NHWC
    want = np.asarray(JI.upsample_align_corners(jnp.asarray(x), 4))
    got = I.upsample_align_corners(_nchw(x), 4).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 12, 20, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
