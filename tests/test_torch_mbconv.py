"""lss_carla_torch/ops/mbconv.py (depthwise conv + BN batch moments) and
the fused MBConv path against the JAX package: its Pallas kernel run in
interpret mode, as its own tests run it on the CPU. On the CPU the port
takes the kernel's plain version (``dw_conv_stats_reference``); the CUDA
kernel itself is held against that on the card (test_torch_cuda.py,
chip_smoke.py). Inputs are seeded numpy arrays handed to both.

Tolerances: y and the per-output sums differ only in the order of k^2 f32
products (1e-5); the moments sum N*Ho*Wo of them (1e-5 relative, 1e-4
absolute); gradients pass BN and swish in f32 on both sides (3e-4, the
JAX package's own fused-vs-XLA tolerance); whole train-mode blocks and
trunks chain several such layers (1e-4 on outputs and statistics; 1e-3
relative on parameter gradients, plus 1e-4 of the module's largest
gradient entry for gradients that are 0 up to rounding)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lss_carla_tpu.models import efficientnet as JE
from lss_carla_tpu.ops import mbconv_pallas as JM

from lss_carla_torch.models.efficientnet import EfficientNetTrunk, MBConvBlock
from lss_carla_torch.ops import mbconv as M
from lss_carla_torch.ops import mbconv_cuda
from lss_carla_torch.utils import convert as C

from test_torch_convert import randomize_variables


@pytest.fixture(scope="module")
def rng():
    """This file's own generator: the session one in conftest.py stays the
    JAX tests' alone, so their draws do not depend on which port files share
    their worker."""
    return np.random.default_rng(0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _w(w_kkc):
    """JAX (k, k, C) depthwise taps -> the port's (C, 1, k, k)."""
    return torch.from_numpy(np.ascontiguousarray(w_kkc.transpose(2, 0, 1)[:, None]))


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("H,W", [(8, 12), (9, 11)])
def test_dw_conv_stats_matches_jax_kernel(rng, k, s, H, W):
    x = rng.normal(size=(2, H, W, 6)).astype(np.float32)
    w = rng.normal(size=(k, k, 6)).astype(np.float32)
    jy, js, jss = JM.dw_conv_stats(jnp.asarray(x), jnp.asarray(w), s, True)
    y, s1, s2 = M.dw_conv_stats(_nchw(x), _w(w), s)
    assert y.shape == (2, 6, -(-H // s), -(-W // s))
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(jss), rtol=1e-5, atol=1e-4)


def test_same_padding_offsets():
    """The kernel's low-side pads are XLA's total // 2, asymmetric at
    stride 2 on even sizes."""
    assert mbconv_cuda.same_pad_amounts(64, 3, 2) == (0, 1)
    assert mbconv_cuda.same_pad_amounts(32, 5, 2) == (1, 2)
    assert mbconv_cuda.same_pad_amounts(11, 5, 1) == (2, 2)
    assert mbconv_cuda.same_pad_amounts(9, 3, 2) == (1, 1)


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_fused_dw_bn_swish_and_gradients_match_jax(rng, k, s):
    H, W, Cc = (12, 16, 8) if k == 5 else (9, 16, 8)
    x = rng.normal(size=(2, H, W, Cc)).astype(np.float32)
    w = rng.normal(size=(k, k, Cc)).astype(np.float32)
    g = rng.normal(size=(Cc,)).astype(np.float32)
    b = rng.normal(size=(Cc,)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jnp.square(JM.fused_dw_bn_swish(*a, s, 1e-3, True)[0]))

    jout, jmean, jvar = JM.fused_dw_bn_swish(*map(jnp.asarray, (x, w, g, b)),
                                            s, 1e-3, True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, w, g, b)))

    ts = [_nchw(x), _w(w), torch.from_numpy(g), torch.from_numpy(b)]
    ts = [t.clone().requires_grad_() for t in ts]
    out, mean, var = M.fused_dw_bn_swish(*ts, stride=s, eps=1e-3)
    out.square().sum().backward()
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(jvar),
                               rtol=1e-5, atol=1e-5)
    got = [_nhwc(ts[0].grad), ts[1].grad.numpy()[:, 0].transpose(1, 2, 0),
           ts[2].grad.numpy(), ts[3].grad.numpy()]
    for a, r, name in zip(got, jgrads, ("dx", "dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(a, np.asarray(r), rtol=3e-4, atol=3e-4,
                                   err_msg=name)


def test_plain_composition_matches_fused(rng):
    """xla_dw_bn_swish (conv, then moments, then BN and swish) computes
    what fused_dw_bn_swish computes, outputs and gradients."""
    x = torch.from_numpy(rng.normal(size=(2, 6, 9, 10)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(6, 1, 5, 5)).astype(np.float32))
    g, b = torch.rand(6) + 0.5, torch.randn(6)
    outs, grads = [], []
    for fn in (M.fused_dw_bn_swish, M.xla_dw_bn_swish):
        xx = x.clone().requires_grad_()
        out, mean, var = fn(xx, w, g, b, 2)
        out.sum().backward()
        outs.append((out.detach(), mean, var))
        grads.append(xx.grad)
    for a, r in zip(outs[0], outs[1]):
        torch.testing.assert_close(a, r, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(grads[0], grads[1], rtol=3e-4, atol=3e-4)


def _jax_train_step(jm, variables, args, r):
    """Train-mode apply of a JAX module (its Pallas kernel interpreted):
    (outputs, new batch_stats, param grads of sum(out * r))."""
    def loss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            *args, True, mutable=["batch_stats"])
        outs = out if isinstance(out, dict) else {"out": out}
        return sum(jnp.sum(outs[k] * r[k]) for k in r), (outs, mut)

    with pltpu.force_tpu_interpret_mode():
        (_, (outs, mut)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    np_tree = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    return np_tree(outs), np_tree(mut["batch_stats"]), np_tree(grads)


def _port_train_step(module, x, r):
    module.train()
    out = module(_nchw(x))
    outs = out if isinstance(out, dict) else {"out": out}
    sum((outs[k] * _nchw(r[k])).sum() for k in r).backward()
    return {k: _nhwc(v) for k, v in outs.items()}


def _check_against_jax(module, jm, names, x, rng, tol):
    jx = jnp.asarray(x)
    variables = randomize_variables(
        jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0), jx, False), rng)
    shapes = jax.eval_shape(lambda: jm.apply(variables, jx, False))
    shapes = shapes if isinstance(shapes, dict) else {"out": shapes}
    r = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in shapes.items()}
    jouts, jstats, jgrads = _jax_train_step(jm, variables, (jx,), r)

    module.load_state_dict(C.variables_to_state_dict(variables, names))
    outs = _port_train_step(module, x, r)
    for k in r:
        np.testing.assert_allclose(outs[k], jouts[k], err_msg=k, **tol)
    want = C.variables_to_state_dict({"params": jgrads, "batch_stats": jstats},
                                     names)
    state = module.state_dict()
    params = dict(module.named_parameters())
    # some gradients are 0 up to rounding (a bias ahead of a train-mode BN):
    # absolute slack is 1e-4 of the largest gradient entry of the module
    gscale = max(np.abs(want[k].numpy()).max() for k in params)
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k, **tol)
        elif k in params:
            np.testing.assert_allclose(params[k].grad.numpy(), v.numpy(),
                                       rtol=1e-3, atol=1e-4 * gscale, err_msg=k)


@pytest.mark.parametrize("expand,stride", [(6, 2), (6, 1), (1, 1)])
def test_fused_mbconv_block_train_step_matches_jax(rng, expand, stride):
    x = rng.normal(size=(2, 8, 16, 8)).astype(np.float32)
    kw = dict(expand=expand, kernel=3, stride=stride, cin=8, cout=8)
    _check_against_jax(MBConvBlock(**kw, fused_dw=True),
                       JE.MBConvBlock(**kw, fused_dw=True),
                       C.mbconv_name_map(expand), x, rng,
                       dict(rtol=1e-4, atol=1e-4))


def test_fused_slim_trunk_train_step_matches_jax(rng):
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    _check_against_jax(
        EfficientNetTrunk("slim", drop_connect_rate=0.0, fused_dw=True),
        JE.EfficientNetTrunk("slim", drop_connect_rate=0.0, fused_dw=True),
        C.trunk_name_map("slim"), x, rng, dict(rtol=1e-4, atol=1e-4))


def test_one_jax_tree_serves_fused_and_plain(rng):
    """One JAX variable tree loads (strict) into the trunk with fused_dw on
    and off; in train mode the two give the same endpoints and running
    stats, and in eval mode fused_dw changes nothing."""
    jm = JE.EfficientNetTrunk("slim")
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    variables = randomize_variables(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(1), jnp.asarray(x), False), rng)
    sd = C.variables_to_state_dict(variables, C.trunk_name_map("slim"))
    trunks = [EfficientNetTrunk("slim", drop_connect_rate=0.0, fused_dw=f)
              for f in (True, False)]
    for t in trunks:
        t.load_state_dict(sd, strict=True)
    assert list(trunks[0].state_dict()) == list(trunks[1].state_dict())
    with torch.no_grad():
        ev = [t.eval()(_nchw(x)) for t in trunks]
        tr = [t.train()(_nchw(x)) for t in trunks]
    for k in ev[0]:
        torch.testing.assert_close(ev[0][k], ev[1][k], rtol=0, atol=0)
        torch.testing.assert_close(tr[0][k], tr[1][k], rtol=1e-4, atol=1e-4)
    s0, s1 = trunks[0].state_dict(), trunks[1].state_dict()
    for k in s0:
        torch.testing.assert_close(s0[k], s1[k], rtol=1e-5, atol=1e-6)
