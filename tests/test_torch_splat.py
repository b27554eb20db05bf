"""lss_carla_torch/ops/splat.py against the JAX package's splat: voxel ids,
the plain version and voxel_pooling against the Pallas kernel (interpret
mode on the CPU) and the XLA scatter, the backward against jax.grad, and
the CPU dispatch that never reaches the CUDA kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.ops import geometry as JG
from lss_carla_tpu.ops import splat as JS
from lss_carla_tpu.ops.splat_pallas import splat_pallas_batched

from lss_carla_torch.ops import _nvcc
from lss_carla_torch.ops import splat as S
from lss_carla_torch.ops import splat_cuda

GRIDS = {
    "tiny": ((-2, 2, 0.5), (-2, 2, 0.5), (-1, 1, 1.0)),
    "flagship": ((-50.0, 50.0, 0.5), (-50.0, 50.0, 0.5), (-10.0, 10.0, 20.0)),
}


@pytest.fixture(scope="module")
def rng():
    """This file's own generator: the session one in conftest.py stays the
    JAX tests' alone, so their draws do not depend on which port files share
    their worker."""
    return np.random.default_rng(0)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_voxel_indices_exact(rng, grid):
    dx, bx, nx = JG.gen_dx_bx(*GRIDS[grid])
    span = 1.3 * np.abs(np.array([b[0] for b in GRIDS[grid]]))
    geom = rng.uniform(-span, span, size=(2, 3, 5, 7, 3)).astype(np.float32)
    # non-finite and huge coordinates (a singular camera matrix): NaN
    # quantises to 0, +-inf and 1e20 fall out of range, as in XLA
    geom[0, 0, 0, :4] = [[np.nan, 0.1, 0.1], [np.inf, 0.1, 0.1],
                         [0.1, -np.inf, 0.1], [1e20, -1e20, 0.1]]
    geom[0, 0, 1, 0] = np.nan
    want_ids, want_valid = JS.voxel_indices(jnp.asarray(geom), dx, bx, nx)
    got_ids, got_valid = S.voxel_indices(torch.from_numpy(geom), dx, bx, nx)
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert 0 < got_valid.float().mean() < 1  # both branches exercised


def _ids(rng, B, P, S_, sentinel_share=0.1):
    ids = rng.integers(0, S_, size=(B, P)).astype(np.int32)
    ids[rng.uniform(size=(B, P)) < sentinel_share] = S_
    return ids


def test_splat_reference_matches_pallas(rng):
    B, P, C, num_slots = 2, 300, 8, 64
    pts = rng.normal(size=(B, P, C)).astype(np.float32)
    ids = _ids(rng, B, P, num_slots)
    want = np.asarray(splat_pallas_batched(
        jnp.asarray(pts), jnp.asarray(ids), num_slots, True))
    got = S.splat_reference(torch.from_numpy(pts), torch.from_numpy(ids),
                            num_slots)
    assert got.shape == (B, num_slots, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_splat_reference_bf16_accumulates_in_f32(rng):
    """bf16 features (the JAX op sends those to the XLA scatter) sum in
    f32 and come back as bf16: equal to the f32 sum of the bf16 values,
    rounded once."""
    B, P, C, num_slots = 1, 512, 4, 8   # ~57 points per slot
    pts = torch.from_numpy(rng.normal(size=(B, P, C)).astype(np.float32))
    ids = torch.from_numpy(_ids(rng, B, P, num_slots))
    got = S.splat_reference(pts.to(torch.bfloat16), ids, num_slots)
    want = S.splat_reference(pts.to(torch.bfloat16).float(), ids, num_slots)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("method", ["pallas", "scatter"])
def test_voxel_pooling_matches_jax(rng, method):
    dx, bx, nx = JG.gen_dx_bx(*GRIDS["tiny"])
    geom = rng.uniform(-3, 3, size=(2, 2, 3, 2, 3, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 2, 3, 2, 3, 5)).astype(np.float32)
    want = JS.voxel_pooling(jnp.asarray(geom), jnp.asarray(feats), dx, bx,
                            nx, method=method)
    got = S.voxel_pooling(torch.from_numpy(geom), torch.from_numpy(feats),
                          dx, bx, nx, method=method)
    assert got.shape == want.shape == (2, 8, 8, 2 * 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_voxel_pooling_bf16_within_jax_rounding(rng):
    """bf16 features: JAX's voxel_pooling scatter-adds in bf16 (a rounding
    each add), the port sums in f32 and rounds once, so a slot of n points
    differs by at most (n + 1) bf16 ulps of its sum of magnitudes; and the
    port's is the f32 sum of the bf16 values rounded once, exactly."""
    dx, bx, nx = JG.gen_dx_bx(*GRIDS["tiny"])
    geom = rng.uniform(-2.2, 2.2, size=(2, 2, 3, 4, 5, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 2, 3, 4, 5, 6)).astype(np.float32)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    want = JS.voxel_pooling(jnp.asarray(geom), jnp.asarray(fb.float().numpy(),
                            dtype=jnp.bfloat16), dx, bx, nx, method="scatter")
    got = S.voxel_pooling(torch.from_numpy(geom), fb, dx, bx, nx)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    exact = S.voxel_pooling(torch.from_numpy(geom), fb.float(), dx, bx, nx)
    assert torch.equal(got, exact.to(torch.bfloat16))
    ones = torch.ones(*feats.shape[:-1], 1)
    count = S.voxel_pooling(torch.from_numpy(geom), ones, dx, bx, nx)
    mag = S.voxel_pooling(torch.from_numpy(geom), fb.float().abs(), dx, bx, nx)
    n = count.repeat_interleave(feats.shape[-1], -1)
    diff = (got.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
    assert (count > 1).any()  # several points share a slot
    assert (diff <= (n + 1) * 2.0 ** -8 * mag + 1e-6).all()


@pytest.mark.parametrize("case", ["random_ids", "heavy_segment"])
def test_segment_kernel_emulation_matches_pallas(case):
    """The bf16 splat's kernel (csrc/splat.cu's segment kernel), emulated
    step for step in tests/test_torch_kernel_plans.py, against the JAX
    package's Pallas kernel (interpret mode) on the same f32 inputs,
    segments cut into chunks included."""
    from test_torch_kernel_plans import emulate_splat, splat_case
    pts, ids, num_slots = splat_case(case, 8)
    sums = emulate_splat(pts, ids, num_slots)[0]
    want = np.asarray(splat_pallas_batched(
        jnp.asarray(np.nan_to_num(pts)), jnp.asarray(ids), num_slots, True))
    np.testing.assert_allclose(sums, want, rtol=1e-5, atol=1e-5)


def test_voxel_pooling_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown splat method"):
        S.voxel_pooling(torch.zeros(1, 1, 1, 1, 1, 3),
                        torch.zeros(1, 1, 1, 1, 1, 2), *JG.gen_dx_bx(
                            *GRIDS["tiny"]), method="bogus")


def test_backward_matches_jax_grad(rng):
    B, P, C, num_slots = 2, 128, 4, 32
    pts = rng.normal(size=(B, P, C)).astype(np.float32)
    ids = _ids(rng, B, P, num_slots, sentinel_share=0.2)
    cot = rng.normal(size=(B, num_slots, C)).astype(np.float32)

    want = np.asarray(jax.grad(lambda x: jnp.sum(splat_pallas_batched(
        x, jnp.asarray(ids), num_slots, True) * cot))(jnp.asarray(pts)))

    x = torch.from_numpy(pts).requires_grad_(True)
    (S.splat(x, torch.from_numpy(ids), num_slots)
     * torch.from_numpy(cot)).sum().backward()
    got = x.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    sentinel = ids == num_slots
    assert sentinel.any() and np.all(got[sentinel] == 0)


def test_cpu_dispatch_takes_plain_version(rng, monkeypatch):
    """A CPU tensor goes to splat_reference: the CUDA wrapper is never
    called and its launch counter stays at 0."""
    def no_kernel(*a, **k):
        raise AssertionError("CUDA wrapper called for a CPU tensor")

    monkeypatch.setattr(splat_cuda, "launches", 0)
    monkeypatch.setattr(splat_cuda, "splat_forward", no_kernel)
    dx, bx, nx = JG.gen_dx_bx(*GRIDS["tiny"])
    geom = torch.from_numpy(rng.uniform(-3, 3, size=(1, 1, 2, 2, 2, 3))
                            .astype(np.float32))
    feats = torch.randn(1, 1, 2, 2, 2, 4, requires_grad=True)
    S.voxel_pooling(geom, feats, dx, bx, nx, method="pallas").sum().backward()
    assert splat_cuda.launches == 0
    assert feats.grad is not None


def test_cuda_module_imports_without_nvcc_and_fails_only_on_build(
        tmp_path, monkeypatch):
    """Importing ops/splat_cuda.py needs no nvcc (it is imported above);
    asking it to build without nvcc raises, and the wrapper refuses CPU
    tensors instead of computing on the CPU."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        splat_cuda.build()
    assert not (tmp_path / "_build").exists()
    with pytest.raises(ValueError, match="CUDA tensors"):
        splat_cuda.splat_forward(torch.zeros(1, 4, 4),
                                 torch.zeros(1, 4, dtype=torch.int32), 4)
