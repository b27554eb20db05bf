"""The serving artifact (``serving.py``): a ``torch.export`` program of
the eval forward that loads without the model code, and the two kernels
as registered operators (``ops/library.py``), on the CPU.

- ``torch.library.opcheck`` on ``lss::splat`` and ``lss::dw_conv_stats``
  in f32 and bf16: schema, fake (meta) implementation, autograd
  registration, and the AOT-dispatch trace of forward and backward.
- The exported program against the live model (the same ops on the same
  inputs: bit-equal) and against JAX's ``load_predict`` of its own export
  of the same weights (converted by ``utils/convert.py``), f32 and uint8
  image signatures, on the slim LSS with JAX's initial weights at 64 x 128
  images (``tests/test_torch_parallel.py``'s): rtol and atol 1e-5, the
  limits of the port's predict against JAX's there; bf16 against the
  live bf16 model, bit-equal.
- A fresh interpreter loads the artifact, runs it, and has imported no
  module of ``lss_carla_torch.models``; its logits equal the live model's
  within 1e-6 (another process may pick other CPU kernels).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lss_carla_tpu import serving as jserving

from lss_carla_torch.ops import library
from lss_carla_torch.serving import (example_args, export_predict,
                                     load_predict, read_meta)

from test_torch_parallel import _payload, setup
from test_torch_quant import _port_logits, _slim
from torch_parallel_ranks import build

REPO = Path(__file__).resolve().parent.parent

assert setup  # the module-scoped fixture, shared with this module


def _opcheck_args(op, dtype, gen):
    if op == "splat":
        pts = torch.randn(2, 50, 8, generator=gen).to(dtype).requires_grad_()
        ids = torch.randint(-3, 40, (2, 50), generator=gen, dtype=torch.int32)
        return library.splat, (pts, ids, 37)
    x = torch.randn(2, 4, 9, 7, generator=gen).to(dtype).requires_grad_()
    w = torch.randn(4, 1, 3, 3, generator=gen).requires_grad_()
    return library.dw_conv_stats, (x, w, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["splat", "dw_conv_stats"])
def test_opcheck(op, dtype):
    fn, args = _opcheck_args(op, dtype, torch.Generator().manual_seed(0))
    result = torch.library.opcheck(fn, args)
    assert set(result.values()) == {"SUCCESS"}, result


class _State:
    """What JAX's ``export_predict`` reads of a train state."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.batch_stats = variables["batch_stats"]


@pytest.mark.parametrize("uint8", [False, True])
def test_program_matches_live_model_and_jax_load_predict(setup, tmp_path,
                                                         uint8):
    jm, variables, batch = setup
    port = build(_payload(setup)).eval()
    args = batch[:6]
    if uint8:
        rng = np.random.default_rng(3)
        args = (rng.integers(0, 256, args[0].shape, dtype=np.uint8),) + args[1:]
    path = str(tmp_path / "lss.pt2")
    export_predict(port, path, bsz=4, uint8_images=uint8)
    served = load_predict(path, device="cpu")
    assert served.moved_from is None and read_meta(path)["device"] == "cpu"
    got = served(*args).numpy()
    np.testing.assert_array_equal(got, _port_logits(port, args))
    jpath = str(tmp_path / "lss.bin")
    jserving.export_predict(jm, _State(variables), jpath, bsz=4,
                            uint8_images=uint8)
    want = np.asarray(jserving.load_predict(jpath)(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_program_matches_live_model(tmp_path):
    _, _, port, args = _slim(4)
    bf16 = type(port)(port.grid_conf, port.data_aug_conf,
                      variant="slim", compute_dtype="bfloat16")
    bf16.load_state_dict(port.state_dict())
    bf16.eval()
    path = str(tmp_path / "bf16.pt2")
    export_predict(bf16, path, bsz=2)
    assert read_meta(path)["config"]["compute_dtype"] == "bfloat16"
    np.testing.assert_array_equal(load_predict(path, device="cpu")(*args).numpy(),
                                  _port_logits(bf16, args))


LOADER = """
import json, sys
import numpy as np
from lss_carla_torch.serving import example_args, load_predict, read_signature
path, out = sys.argv[1], sys.argv[2]
predict = load_predict(path, device="cpu")
logits = predict(*example_args(read_signature(path))).numpy()
np.save(out, logits)
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("lss_carla_torch"))))
"""


def test_program_loads_without_the_model_code(tmp_path):
    _, _, port, _ = _slim(5)
    path = str(tmp_path / "lss.pt2")
    export_predict(port, path, bsz=2, uint8_images=True)
    out = tmp_path / "logits.npy"
    proc = subprocess.run([sys.executable, "-c", LOADER, path, str(out)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "lss_carla_torch.ops.library" in loaded
    assert not [m for m in loaded if m.startswith("lss_carla_torch.models")]
    want = _port_logits(port, example_args(read_meta(path)["signature"]))
    np.testing.assert_allclose(np.load(out), want, rtol=1e-6, atol=1e-6)
