"""``compute_dtype="bfloat16"`` in the port, on the CPU: the dtype at each
boundary (exact), the model's logits against the JAX package's bf16 model,
and the fused MBConv block in bf16 through the kernels' plain versions
against the JAX block (its Pallas kernel interpreted).

bf16 tolerances, measured here and fixed above the readings: the two
frameworks round to bf16 at other places (XLA fuses, PyTorch rounds each
op's output), so each model is 2^-8 per op from its f32 self. On a slim
LSS at 6 x 32 x 64 with random weights, three seeds put the port's bf16
logits 1.1e-2-1.6e-2 x max|logit| from the f32 logits and the JAX bf16
model 0.9e-2-1.2e-2; the two bf16 models 1.2e-2-1.9e-2 apart. The limits
are 3e-2 against f32 and 4e-2 between them. The port's f32 logits stay
within 1e-5 of JAX's (2.6e-6 measured)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lss_carla_tpu.models import efficientnet as JE
from lss_carla_tpu.models.lss import compile_model as jax_compile_model

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.efficientnet import MBConvBlock
from lss_carla_torch.models.layers import BatchNorm2d, Conv2d
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import library
from lss_carla_torch.utils import convert as C

from test_torch_convert import randomize_variables, tiny_confs
from test_torch_lss import rig
from test_torch_variants import random_variables
from util import tiny_aug, tiny_grid

BF16, F32 = torch.bfloat16, torch.float32


def _inputs(rng, B=2, N=6):
    imgs = rng.normal(size=(B, N, 3, 32, 64)).astype(np.float32)
    return (imgs, *rig(rng, B, N, (32, 64)))


def _slim(dtype, fused_dw=False):
    grid, aug = tiny_confs()
    return compile_model(grid, aug, outC=2, variant="slim", fused_dw=fused_dw,
                         compute_dtype=dtype, device="cpu",
                         generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("fused_dw", [False, True])
def test_dtype_at_each_boundary(monkeypatch, fused_dw):
    """One train-mode forward and backward of a bf16 slim LSS: every conv
    but the head and every BN returns bf16; the kernels' plain versions get
    bf16 (the depthwise one only with fused_dw); the depth softmax runs in
    f32 and the lift is bf16; the head and the logits are f32; parameters,
    their gradients and the running stats stay f32."""
    model = _slim("bfloat16", fused_dw)
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen.setdefault(name, set()).add((args[0].dtype, out.dtype))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, (Conv2d, BatchNorm2d, torch.nn.Conv2d)):
            m.register_forward_hook(record(name))
    kernels = {}
    for fn in ("splat_reference", "dw_conv_stats_reference"):
        real = getattr(library, fn)  # the ops' CPU implementations

        def spy(x, *a, _real=real, _fn=fn):
            kernels.setdefault(_fn, set()).add(x.dtype)
            return _real(x, *a)
        monkeypatch.setattr(library, fn, spy)
    softmax_in = []
    real_softmax = torch.softmax
    monkeypatch.setattr(torch, "softmax", lambda x, dim: (
        softmax_in.append(x.dtype), real_softmax(x, dim))[1])

    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(0))]
    logits = model.train()(*args)
    logits.square().mean().backward()
    assert logits.dtype == F32
    head = "bevencode.up2.4"
    assert seen.pop(head) == {(F32, F32)}
    assert all(v == {(BF16, BF16)} for v in seen.values()), {
        k: v for k, v in seen.items() if v != {(BF16, BF16)}}
    assert kernels == ({"splat_reference": {BF16},
                        "dw_conv_stats_reference": {BF16}} if fused_dw
                       else {"splat_reference": {BF16}})
    assert softmax_in == [F32]
    with torch.no_grad():
        lifted, depth = model.camencode(args[0].flatten(0, 1))
    assert lifted.dtype == depth.dtype == BF16
    voxels = model.get_voxels(*args)
    assert voxels.dtype == BF16
    for k, p in model.named_parameters():
        assert p.dtype == F32 and p.grad is not None and p.grad.dtype == F32, k
    for k, b in model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            assert b.dtype == F32, k
    assert model.config()["compute_dtype"] == "bfloat16"


def test_eval_mode_and_unknown_dtype():
    model = _slim("bfloat16").eval()
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(1))]
    with torch.no_grad():
        assert model(*args).dtype == F32
    grid, aug = tiny_confs()
    with pytest.raises(ValueError, match="compute_dtype"):
        compile_model(grid, aug, variant="slim", compute_dtype="float16",
                      device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_logits_match_jax_bf16_model(seed):
    """Eval logits of the slim LSS in bf16, port against JAX, beside both
    models' f32 logits, from one numpy-drawn variable tree (limits in the
    module note)."""
    rng = np.random.default_rng(seed)
    args = _inputs(rng)
    jargs = tuple(map(jnp.asarray, args))
    out, variables = {}, None
    for dtype in ("float32", "bfloat16"):
        jm = jax_compile_model(tiny_grid(), tiny_aug(), outC=1, variant="slim",
                               compute_dtype=dtype)
        if variables is None:
            variables = random_variables(jm, jargs, rng)
        out["jax", dtype] = np.asarray(jax.jit(jm.apply, static_argnames="train")(
            variables, *jargs, train=False))
        grid, aug = (GridConf.from_dict(tiny_grid().to_dict()),
                     DataAugConf.from_dict(tiny_aug().to_dict()))
        port = compile_model(grid, aug, outC=1, variant="slim",
                             compute_dtype=dtype, device="cpu")
        port.load_state_dict(C.jax_variables_to_state_dict(variables, "slim"))
        with torch.no_grad():
            logits = port.eval()(*map(torch.from_numpy, args))
        assert logits.dtype == F32
        out["port", dtype] = logits.numpy()
    ref = out["jax", "float32"]
    scale = np.abs(ref).max()
    assert scale > 1.0

    def gap(a, b):
        return np.abs(out[a] - out[b]).max() / scale

    assert gap(("port", "float32"), ("jax", "float32")) <= 1e-5
    assert gap(("port", "bfloat16"), ("jax", "float32")) <= 3e-2
    assert gap(("jax", "bfloat16"), ("jax", "float32")) <= 3e-2
    assert gap(("port", "bfloat16"), ("jax", "bfloat16")) <= 4e-2
    # bf16 really ran: the gap is far above the f32 one
    assert gap(("port", "bfloat16"), ("port", "float32")) > 1e-4


@pytest.mark.parametrize("expand,stride", [(6, 2), (6, 1)])
def test_fused_block_bf16_matches_jax(expand, stride):
    """A train-mode fused MBConv block in bf16: the port through the
    kernel's plain version on the CPU, JAX through its Pallas kernel in
    interpret mode. Outputs are bf16 on both (rounded at other places:
    held to 2^-6 of the largest output), the running stats f32 (moments of
    bf16 activations that differ by those roundings: 2e-2 relative, 1e-3
    absolute)."""
    rng = np.random.default_rng(3 + stride)
    # the block's input is bf16 in a bf16 trunk: round it once for both
    xt = torch.from_numpy(rng.normal(size=(2, 8, 8, 16)).astype(np.float32)).to(BF16)
    jx = jnp.asarray(xt.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
    kw = dict(expand=expand, kernel=3, stride=stride, cin=8, cout=8)
    jm = JE.MBConvBlock(**kw, fused_dw=True, dtype=jnp.bfloat16)
    variables = randomize_variables(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jx, False), rng)
    with pltpu.force_tpu_interpret_mode():
        jout, mut = jax.jit(lambda v, a: jm.apply(v, a, True, mutable=["batch_stats"]))(
            variables, jx)
    names = C.mbconv_name_map(expand)
    port = MBConvBlock(**kw, fused_dw=True)
    port.load_state_dict(C.variables_to_state_dict(variables, names))
    with torch.no_grad():
        out = port.train()(xt)
    assert out.dtype == BF16 and jout.dtype == jnp.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    got = out.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    stats = C.variables_to_state_dict(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.array, mut["batch_stats"])},
        names)
    state = port.state_dict()
    for k in names:
        if k.endswith(("running_mean", "running_var")):
            assert state[k].dtype == F32
            np.testing.assert_allclose(state[k].numpy(), stats[k].numpy(),
                                       rtol=2e-2, atol=1e-3, err_msg=k)
