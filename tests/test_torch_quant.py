"""lss_carla_torch/ops/quant.py against the JAX package's ops/quant.py on the
CPU: the quantisers bit-equal, the int32 accumulators of ``conv_int8``
exactly equal, the set of convs ``quantize_model`` swaps equal to the calls
JAX's interceptor quantizes (at three thresholds), the slim LSS model's
int8 logits against ``quantized_apply`` on converted weights, the int8
artifact round trip, ``eval_model_iou(quantize=True)`` against JAX's
quantized validation, and the refusals."""

import numpy as np
import pytest
import torch
from torch import nn as tnn

import jax.numpy as jnp
import optax
from flax import linen as nn
from jax import lax

from lss_carla_tpu.configs import DataAugConf as JAug
from lss_carla_tpu.configs import GridConf as JGrid
from lss_carla_tpu.data import loader as JLd
from lss_carla_tpu.data import simbev as JS
from lss_carla_tpu.models.lss import compile_model as jax_compile_model
from lss_carla_tpu.ops import quant as JQ
from lss_carla_tpu.training import state as JState
from lss_carla_tpu.training.loop import get_val_info as jax_get_val_info
from lss_carla_tpu.training.step import make_eval_step as jax_make_eval_step

from lss_carla_torch import explore
from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import quant as Q
from lss_carla_torch.serving import export_predict, load_predict
from lss_carla_torch.utils.convert import jax_variables_to_state_dict, name_map

from test_torch_explore import AUG, GRID, KW, _port_model, _save
from test_torch_lss import rig
from test_torch_variants import random_variables
from util import tiny_aug, tiny_grid

# the slim LSS in int8, port against JAX: both quantize the same way, but
# a float difference upstream (~1e-6, the two frameworks' conv orders) can
# move one activation across a rounding edge and flip one quantum. Twice
# the largest reading of the six seeds below (1.461e-3 at seed 0; the other
# five 2.6e-7-7.9e-7)
INT8_TOL = 3e-3            # x max(1, max |logit|)
SEEDS = range(6)


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's workers share the cores; these tiny models need one
    intra-op thread each (a full-width pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_bit_equal_jax(dtype):
    """Per-channel weights (one loud channel) and per-tensor activations:
    the int8 tensors bit-equal, the scales within 1 ulp."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)   # HWIO
    w[..., 0] *= 100.0
    x = (rng.normal(size=(2, 5, 6, 8)) * 3.0).astype(np.float32)  # NHWC
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    jw, jws = JQ.quantize_weight(jnp.asarray(w, jdt))
    tw, tws = Q.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)).to(tdt))
    assert tw.dtype == torch.int8 and tws.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).transpose(3, 2, 0, 1))
    np.testing.assert_array_max_ulp(tws.numpy(), np.asarray(jws), maxulp=1)

    jx, jxs = JQ.quantize_activation(jnp.asarray(x, jdt))
    tx, txs = Q.quantize_activation(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(tdt))
    assert tx.dtype == torch.int8 and txs.ndim == 0
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx).transpose(0, 3, 1, 2))
    np.testing.assert_array_max_ulp(txs.numpy(), np.asarray(jxs), maxulp=1)


# (kernel, stride, padding, cout, bias)
CONV_CASES = [(3, 1, 1, 64, True), (3, 2, 1, 64, False), (1, 2, 0, 64, True),
              (1, 1, 0, 105, True), (3, 1, 1, 105, False)]


@pytest.mark.parametrize("k,stride,pad,cout,bias", CONV_CASES)
def test_conv_int8_matches_jax(k, stride, pad, cout, bias):
    """The int32 accumulators exactly equal to ``lax.conv_general_dilated(
    ..., preferred_element_type=int32)`` on JAX's own int8 tensors; the
    dequantised outputs of ``conv_int8`` and of an ``Int8Conv2d`` within
    1e-6 relative of JAX's ``conv_int8``. M = 2 x Ho x Wo stays under 17
    at stride 2 and cout 105 is no multiple of 8, so the padding runs."""
    rng = np.random.default_rng(k * 10 + stride + cout)
    x = rng.normal(size=(2, 7, 9, 24)).astype(np.float32) * 2.0     # NHWC
    w = (rng.normal(size=(k, k, 24, cout)) * 0.1).astype(np.float32)  # HWIO
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32) if bias else None
    jpad = ((pad, pad), (pad, pad))

    jx_i8, jxs = JQ.quantize_activation(jnp.asarray(x))
    jw_i8, jws = JQ.quantize_weight(jnp.asarray(w))
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    want_acc = np.asarray(lax.conv_general_dilated(
        jx_i8, jw_i8, (stride, stride), jpad, dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    want = np.asarray(JQ.conv_int8(jnp.asarray(x), jnp.asarray(w),
                                   None if b is None else jnp.asarray(b),
                                   (stride, stride), jpad))

    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    tb = None if b is None else torch.from_numpy(b)
    x_i8, _ = Q.quantize_activation(tx)
    w_i8, w_scale = Q.quantize_weight(tw)
    acc = Q.conv_int8_acc(x_i8, Q.pad_weight(w_i8), cout, (k, k), stride, pad)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)

    conv = tnn.Conv2d(24, cout, k, stride=stride, padding=pad, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(tw)
        if bias:
            conv.bias.copy_(tb)
    outs = (Q.conv_int8(tx, w_i8, w_scale, tb, stride, pad),
            Q.Int8Conv2d(conv)(tx))
    for got in outs:
        got = got.numpy().transpose(0, 2, 3, 1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_int_mm_padding_shapes():
    """The padded shapes meet ``_int_mm``'s CUDA limits (M > 16, K and N
    multiples of 8) and change nothing that needs none."""
    assert Q.mm_shape(6, 112, 672) == (17, 112, 672)
    assert Q.mm_shape(4096, 60, 105) == (4096, 64, 112)
    assert Q.mm_shape(17, 8, 8) == (17, 8, 8)
    a = torch.randint(-127, 128, (5, 12), dtype=torch.int8)
    w = torch.randint(-127, 128, (7, 12, 1, 1), dtype=torch.int8)
    got = Q.int_mm_padded(a, Q.pad_weight(w), 7)
    want = a.long() @ w.reshape(7, 12).long().t()
    assert got.shape == (5, 7)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# --- the slim LSS model ------------------------------------------------


def _slim(seed):
    """JAX slim LSS, random variables (randomised BN stats) and a batch of
    6 cameras at 32 x 64 from ``seed``."""
    rng = np.random.default_rng(seed)
    jm = jax_compile_model(tiny_grid(), tiny_aug(), outC=1, variant="slim")
    imgs = rng.normal(size=(2, 6, 3, 32, 64)).astype(np.float32)
    args = (imgs, *rig(rng, 2, 6, (32, 64)))
    variables = random_variables(jm, tuple(map(jnp.asarray, args)), rng)
    port = compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                         DataAugConf.from_dict(tiny_aug().to_dict()), outC=1,
                         variant="slim", device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(variables, "slim"))
    return jm, variables, port.eval(), args


def _jax_quantized(jm, variables, args, min_channels):
    """JAX ``quantized_apply``'s logits, and the flax paths of the convs
    its interceptor quantized: a conv call that does not reach the next
    function was replaced by ``conv_int8``."""
    icpt, paths = JQ.make_conv_interceptor(min_channels), []

    def spy(next_fun, a, k, context):
        reached = []

        def next_spy(*aa, **kk):
            reached.append(True)
            return next_fun(*aa, **kk)

        out = icpt(next_spy, a, k, context)
        if (isinstance(context.module, nn.Conv)
                and context.method_name == "__call__" and not reached):
            paths.append(tuple(context.module.path))
        return out

    with nn.intercept_methods(spy):
        logits = jm.apply(variables, *map(jnp.asarray, args), train=False)
    return np.asarray(logits), paths


def _port_logits(model, args):
    with torch.no_grad():
        return model(*map(torch.from_numpy, args)).numpy()


@pytest.mark.parametrize("min_channels", [8, 64, 4096])
def test_gate_swaps_what_jax_quantizes(min_channels):
    """``quantize_model``'s swapped modules are exactly the convs JAX's
    interceptor quantizes on the slim LSS model, names mapped through
    ``utils/convert.py``; at 4096 nothing swaps and the logits are
    bit-equal to float."""
    jm, variables, port, args = _slim(0)
    _, paths = _jax_quantized(jm, variables, args, min_channels)
    module_of = {path[:-1]: torch_name[:-len(".weight")]
                 for torch_name, (path, _) in name_map("slim").items()
                 if path[-1] == "kernel"}
    qmodel, swapped = Q.quantize_model(port, min_channels)
    assert sorted(swapped) == sorted({module_of[p] for p in paths})
    assert len(swapped) == len(set(swapped))
    if min_channels == 4096:
        assert swapped == []
        np.testing.assert_array_equal(_port_logits(qmodel, args),
                                      _port_logits(port, args))
    else:
        assert swapped and all(isinstance(qmodel.get_submodule(n), Q.Int8Conv2d)
                               for n in swapped)


@pytest.mark.parametrize("seed", SEEDS)
def test_slim_int8_logits_match_jax_quantized_apply(seed):
    """The port's int8 slim LSS against JAX ``quantized_apply`` on the
    converted weights, at min_channels 64, within ``INT8_TOL``; and JAX's
    own int8-against-float bounds (``tests/test_quant.py``) on the port:
    max |Δ| under 0.1 of max |logit|, signs agreeing on more than 97 %."""
    jm, variables, port, args = _slim(seed)
    want, _ = _jax_quantized(jm, variables, args, 64)
    qmodel, swapped = Q.quantize_model(port, 64)
    got = _port_logits(qmodel, args)
    assert got.shape == want.shape == (2, 1, 16, 16)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= INT8_TOL * scale
    ref = _port_logits(port, args)
    assert np.abs(got - ref).max() < 0.1 * np.abs(ref).max()
    assert ((got > 0) == (ref > 0)).mean() > 0.97
    assert not np.array_equal(got, ref)  # the int8 convs ran


def test_quantize_model_refuses_train_mode_and_leaves_the_model():
    _, _, port, args = _slim(1)
    with pytest.raises(ValueError, match="eval mode"):
        Q.quantize_model(port.train())
    port.eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    qmodel, swapped = Q.quantize_model(port)
    assert qmodel is not port and swapped
    assert all(isinstance(port.get_submodule(n), tnn.Conv2d) for n in swapped)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="4-D"):
        qmodel.get_submodule(swapped[0])(torch.zeros(64, 4, 4))


def test_int8_artifact_round_trip(tmp_path):
    """An artifact exported with ``quantize`` holds the int8 program: one
    ``_int_mm`` a swapped conv, and ``load_predict`` serves the live
    quantized model (1e-5, as JAX's ``test_export_quantized_roundtrip``);
    without it, the float model."""
    from lss_carla_torch.serving import read_meta
    _, _, port, args = _slim(2)
    path = str(tmp_path / "lss_int8.pt2")
    export_predict(port, path, bsz=2, quantize=True)
    meta = read_meta(path)
    assert meta["quantize"] is True and meta["quant_min_channels"] == 64
    qmodel, swapped = Q.quantize_model(port)
    served = load_predict(path, device="cpu")
    int_mm = [n for n in served.program.graph.nodes
              if n.target is torch.ops.aten._int_mm.default]
    assert swapped and len(int_mm) == len(swapped)
    np.testing.assert_allclose(served(*args).numpy(), _port_logits(qmodel, args),
                               atol=1e-5, rtol=1e-5)
    export_predict(port, path, bsz=2)
    np.testing.assert_array_equal(load_predict(path, device="cpu")(*args).numpy(),
                                  _port_logits(port, args))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                            samples_per_scene=3, H=64, W=128, grid=16, seed=5)


def test_eval_model_iou_quantize_matches_jax(fixture_root, tmp_path):
    """``eval_model_iou(quantize=True)`` on a port checkpoint against the
    JAX package's validation under ``quantized_context`` (its
    ``eval_model_iou --quantize``) with the same converted weights and
    fixture: loss and IoU as the float eval is held (quantum flips aside,
    these inputs sit on none), and the int8 loss differs from the float."""
    rng = np.random.default_rng(51)
    jm = jax_compile_model(JGrid(**GRID), JAug(**AUG), outC=1, variant="slim")
    sample = (jnp.zeros((1, 6, 3, 32, 64)), jnp.tile(jnp.eye(3), (1, 6, 1, 1)),
              jnp.zeros((1, 6, 3)), jnp.tile(jnp.eye(3), (1, 6, 1, 1)),
              jnp.tile(jnp.eye(3), (1, 6, 1, 1)), jnp.zeros((1, 6, 3)))
    variables = random_variables(jm, sample, rng)
    # the native decoder on both sides (the port's loader default)
    jds = JS.SegmentationData(fixture_root, False, JAug(**AUG), JGrid(**GRID),
                              use_native=True)
    assert jds._native
    valloader = JLd.DataLoader(jds, 2, pad_last=True, num_workers=0)
    jstate = JState.TrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=optax.identity(),
        batch_stats=variables["batch_stats"])
    with JQ.quantized_context():
        want = jax_get_val_info(jax_make_eval_step(jm, pos_weight=2.13),
                                jstate, valloader)

    port = _port_model()
    port.load_state_dict(jax_variables_to_state_dict(variables, "slim"))
    _save(tmp_path / "ckpts", port)
    args = dict(best=True, variant="slim", bsz=2, **KW)
    got = explore.eval_model_iou(fixture_root, str(tmp_path / "ckpts"),
                                 quantize=True, **args)
    flt = explore.eval_model_iou(fixture_root, str(tmp_path / "ckpts"), **args)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert abs(got["iou"] - want["iou"]) <= 1e-3, (got, want)
    assert got["loss"] != flt["loss"]


def test_export_cli_quantize(tmp_path, capsys):
    """``python -m lss_carla_torch.serving --quantize`` writes an int8
    artifact that serves the live quantized model."""
    from lss_carla_torch.serving import _main as export_cli
    _, _, _, args = _slim(4)
    port = compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                         DataAugConf.from_dict(tiny_aug().to_dict()),
                         device="cpu").eval()
    ckpt, art = tmp_path / "model.pt", tmp_path / "int8.pt"
    torch.save({"model_state_dict": port.state_dict()}, ckpt)
    export_cli(["--checkpoint", str(ckpt), "--out", str(art), "--quantize",
                "--bsz", "2", "--H", "64", "--W", "128",
                "--final_dim", "32", "64", "--xbound", "-40", "40", "5",
                "--ybound", "-40", "40", "5", "--dbound", "4", "36", "8",
                "--device", "cpu"])
    assert "int8" in capsys.readouterr().out
    np.testing.assert_allclose(load_predict(str(art), device="cpu")(*args).numpy(),
                               _port_logits(Q.quantize_model(port)[0], args),
                               atol=1e-5, rtol=1e-5)
