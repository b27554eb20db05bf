"""lss_carla_torch/utils/convert.py: JAX variables and reference state dicts
into the port's modules. Also holds the helpers the other test_torch_*
files use to carry JAX weights into the port."""

import numpy as np
import pytest
import torch

import jax

from lss_carla_tpu.utils.convert import variables_to_torch_state_dict

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.utils import convert as C


@pytest.fixture(scope="module")
def rng():
    """This file's own generator: the session one in conftest.py stays the
    JAX tests' alone, so their draws do not depend on which port files share
    their worker."""
    return np.random.default_rng(0)


def randomize_variables(variables, rng):
    """JAX variables with numpy-random BN stats and affine params, so eval
    mode and the BN transplant are real tests. Returns numpy nested dicts."""
    def f32(shape, draw, *a):
        return draw(*a, size=shape).astype(np.float32)

    def walk(params, stats):  # in place, on the numpy copies below
        for k, s in stats.items():
            if "mean" in s:   # a BatchNorm: {"mean", "var"} + {"scale", "bias"}
                s["mean"] = f32(s["mean"].shape, rng.normal, 0, 0.3)
                s["var"] = f32(s["var"].shape, rng.uniform, 0.5, 1.5)
                p = params[k]
                p["scale"] = f32(p["scale"].shape, rng.uniform, 0.5, 1.5)
                p["bias"] = f32(p["bias"].shape, rng.normal, 0, 0.1)
            else:
                walk(params[k], s)

    to_np = lambda t: jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), t)
    params, stats = to_np(variables["params"]), to_np(variables["batch_stats"])
    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def load_port(module, variables, names):
    """Load converted JAX variables into a port module (strict) in eval."""
    module.load_state_dict(C.variables_to_state_dict(variables, names))
    return module.eval()


def tiny_confs():
    """The port's copies of tests/util.py's tiny_grid() / tiny_aug()."""
    return (GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                     zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 36.0, 8.0)),
            DataAugConf(H=64, W=128, final_dim=(32, 64)))


@pytest.mark.parametrize("variant", ["b0", "slim"])
def test_name_map_covers_the_state_dict(variant):
    """Every port tensor has a map entry and every entry a tensor."""
    grid, aug = tiny_confs()
    model = compile_model(grid, aug, variant=variant, device="cpu")
    want = {k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")}
    assert set(C.name_map(variant)) == want


def test_name_map_b0_equals_jax_package_map():
    """At B0 the port's names are exactly the reference names the JAX
    converter builds (lss_carla_tpu/utils/convert.py::build_name_map)."""
    from lss_carla_tpu.utils.convert import build_name_map
    assert set(C.name_map("b0")) == set(build_name_map())


def test_jax_converter_matches_jax_package_export(rng):
    """jax_variables_to_state_dict == the JAX package's own
    variables_to_torch_state_dict, tensor by tensor, on B0."""
    import jax.numpy as jnp
    from lss_carla_tpu.models.lss import compile_model as jax_compile
    from util import tiny_aug, tiny_grid

    model = jax_compile(tiny_grid(), tiny_aug(), outC=1)
    B, N = 1, 1
    args = (jnp.zeros((B, N, 3, 32, 64)), jnp.tile(jnp.eye(3), (B, N, 1, 1)),
            jnp.zeros((B, N, 3)), jnp.tile(jnp.eye(3), (B, N, 1, 1)),
            jnp.tile(jnp.eye(3), (B, N, 1, 1)), jnp.zeros((B, N, 3)))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, train=False))
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    variables = {"params": variables["params"],
                 "batch_stats": variables["batch_stats"]}
    got = C.jax_variables_to_state_dict(variables, "b0")
    want = variables_to_torch_state_dict(variables)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert all(got[k].item() == 0 for k in got
               if k.endswith("num_batches_tracked"))


def test_reference_state_dict_loads_strict():
    """A reference-format state dict (trunk head, geometry constants, no
    num_batches_tracked) loads into the port with strict=True."""
    grid, aug = tiny_confs()
    src = compile_model(grid, aug, variant="slim", device="cpu",
                        generator=torch.Generator().manual_seed(3))
    ref = {k: v.numpy() for k, v in src.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ref["camencode.trunk._conv_head.weight"] = np.zeros((4, 4, 1, 1))
    ref["camencode.trunk._bn1.weight"] = np.zeros(4)
    ref["camencode.trunk._fc.bias"] = np.zeros(4)
    for k in ("dx", "bx", "nx", "frustum"):
        ref[k] = np.zeros(3)
    dst = compile_model(grid, aug, variant="slim", device="cpu",
                        generator=torch.Generator().manual_seed(4))
    dst.load_state_dict(C.reference_state_dict(ref))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
