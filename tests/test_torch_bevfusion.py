"""BEVFusion's camera-only map segmentation in the port
(``models/bevfusion.py``, ``models/swin.py``) against the plain reference
``benchmark/reference/bevfusion.py`` (plain torch; imports neither package),
on the CPU at a small size with seeded weights (Swin-T's widths, 2 cameras
at 64 x 176, a 40 x 40 lift grid and a 30 x 30 output): Swin blocks on a
map that needs padding, and planted faults that must fail; the whole
model's logits and its first step's gradients; the focal loss; AdamW; the
window counter and the spans. Card tests (``gpu``): the train step's CUDA
graph against the eager step at the ``bevfusion-seg-train`` cell's shapes,
and the splat at that cell's 8.0 M points:

    python -m pytest --noconftest tests/test_torch_bevfusion.py -m gpu
"""

import ast
import copy
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import bevfusion as R
from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.bevfusion import MAP_CLASSES, BEVFusionSeg, compile_bevfusion
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.models.swin import DropPath, ShiftWindowMSA, SwinBlock
from lss_carla_torch.ops import window_attention as WA
from lss_carla_torch.training.loss import sigmoid_focal_loss
from lss_carla_torch.training.state import make_optimizer
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent

SWIN_T = {"embed_dims": 96, "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24],
          "window_size": 7, "mlp_ratio": 4, "out_indices": [1, 2, 3]}


def cfg_of(drop_path=0.0, image=(64, 176), lift=(-8.0, 8.0, 0.4),
           out=(-7.5, 7.5, 0.5)):
    """The reference's configuration: BEVFusion's widths at a small image
    and grid (``benchmark/configs/bevfusion-cam-seg.json`` has the
    published ones)."""
    return {"image_size": list(image), "feature_stride": 8,
            "swin": dict(SWIN_T, drop_path_rate=drop_path),
            "neck": {"in_channels": [192, 384, 768], "out_channels": 256},
            "vtransform": {"in_channels": 256, "out_channels": 80, "xbound": list(lift),
                           "ybound": list(lift), "zbound": [-10.0, 10.0, 20.0],
                           "dbound": [1.0, 20.0, 2.0]},
            "decoder": {"blocks": [[2, 128, 2], [2, 256, 2], [2, 512, 1]],
                        "neck": {"in_indices": [-1, 0], "in_channels": [512, 128],
                                 "out_channels": 256, "scale_factor": 2}},
            "head": {"classes": list(MAP_CLASSES),
                     "input_scope": [[lift[0], lift[1], 2 * lift[2]]] * 2,
                     "output_scope": [list(out)] * 2, "gamma": 2.0}}


def port_of(cfg, weights=None, dtype="float32", device="cpu"):
    v = cfg["vtransform"]
    grid = GridConf(xbound=tuple(v["xbound"]), ybound=tuple(v["ybound"]),
                    zbound=tuple(v["zbound"]), dbound=tuple(v["dbound"]))
    H, W = cfg["image_size"]
    m = BEVFusionSeg(grid, DataAugConf(H=H, W=W, final_dim=(H, W)),
                     output_scope=cfg["head"]["output_scope"],
                     drop_path_rate=cfg["swin"]["drop_path_rate"], compute_dtype=dtype)
    if weights is not None:
        m.load_state_dict(weights)
    return m.to(device)


def rig(rng, B, N, H, W, f):
    """N level cameras around the ego at 1.5 m, focal length ``f``."""
    yaw = 2 * np.pi * np.arange(N) / N
    cam_to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rz = np.zeros((N, 3, 3), np.float32)
    rz[:, 0, 0], rz[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    rz[:, 1, 0], rz[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    rz[:, 2, 2] = 1
    rots = torch.from_numpy(np.broadcast_to(rz @ cam_to_ego, (B, N, 3, 3)).copy())
    trans = torch.from_numpy(rng.normal(0, 0.2, (B, N, 3)).astype(np.float32))
    trans[..., 2] += 1.5
    intrins = torch.eye(3).repeat(B, N, 1, 1)
    intrins[..., 0, 0] = intrins[..., 1, 1] = f
    intrins[..., 0, 2], intrins[..., 1, 2] = W / 2, H / 2
    return rots, trans, intrins, torch.eye(3).repeat(B, N, 1, 1), torch.zeros(B, N, 3)


def inputs(cfg, seed, B=1, N=2):
    """(uint8 images, the rig, labels at 20 % occupancy) of ``cfg``'s size."""
    rng = np.random.default_rng(seed)
    H, W = cfg["image_size"]
    lo, hi, step = cfg["head"]["output_scope"][0]
    X = int(round((hi - lo) / step))
    imgs = torch.from_numpy(rng.integers(0, 256, (B, N, 3, H, W), dtype=np.uint8))
    labels = torch.from_numpy(rng.uniform(size=(B, len(MAP_CLASSES), X, X)) < 0.2).float()
    return (imgs, *rig(rng, B, N, H, W, 60.0), labels)


def record_drop_paths(model):
    """{module name: the per-sample keep mask of its last draw} of every
    stochastic-depth module, filled by hooks that only read."""
    masks = {}
    handles = [mod.register_forward_hook(
        lambda m, i, o, name=name: masks.__setitem__(name, (o != 0).flatten(1).any(-1)))
        for name, mod in model.named_modules() if isinstance(mod, DropPath) and mod.p > 0]
    return masks, handles


def gap(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).norm()
                 / b.detach().double().norm().clamp_min(1e-300))


# --- Swin blocks ------------------------------------------------------------

H, W, DIM, HEADS = 10, 13, 24, 3          # padded to 14 x 14: 4 windows of 7 x 7


def block_pair(shifted, seed=0):
    """A port ``SwinBlock`` with weights spread wide enough (std 0.2) that
    the bias, the mask and the padding move the output, and its weights
    for the reference under the name "b"."""
    g = torch.Generator().manual_seed(seed)
    block = SwinBlock(DIM, HEADS, 4 * DIM, 7, shifted, 0.0)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.dim() == 1 and
                                                              p.shape[0] == DIM else 0.0))
    return block, {"b." + k: v.detach().clone().requires_grad_(True)
                   for k, v in block.state_dict().items()}


def block_gaps(shifted):
    """(output gap, worst parameter-gradient gap) of the port's block
    against the reference's on a seeded 10 x 13 map, both in f32."""
    block, p = block_pair(shifted)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, H * W, DIM, generator=g)
    cot = torch.randn(2, H * W, DIM, generator=g)
    y = block(x, (H, W))
    (y * cot).sum().backward()
    net = R.Net(p, {"swin": {"window_size": 7}}, True)
    want = net.swin_block(x, (H, W), "b", HEADS, 3 if shifted else 0, 0.0)
    names = sorted(p)
    grads = torch.autograd.grad((want * cot).sum(), [p[n] for n in names])
    mine = dict(block.named_parameters())
    return gap(y, want), max(gap(mine[n[2:]].grad, gi) for n, gi in zip(names, grads))


# f32 on both sides, the same products in other orders (SDPA against
# matmul and softmax): a few ulps, amplified by one softmax and one MLP
BLOCK_TOL = 1e-5


@pytest.mark.parametrize("shifted", [False, True], ids=["w_msa", "sw_msa"])
def test_swin_block_matches_the_reference(shifted):
    """W-MSA and SW-MSA on a 10 x 13 map (padded to whole 7 x 7 windows,
    padding attended, the shifted block's region mask): the output and
    every parameter's gradient."""
    out, grads = block_gaps(shifted)
    assert out <= BLOCK_TOL and grads <= 10 * BLOCK_TOL, (out, grads)


def _no_mask(block, mask):
    return torch.zeros_like(mask)


def _padding_masked(block, mask):
    """The shift mask with every padded key (rows >= H or columns >= W of
    the padded map, rolled by -shift as the windows see them) masked."""
    w, s = block.window, block.shift
    pad = torch.zeros(-(-H // w) * w, -(-W // w) * w)
    pad[H:], pad[:, W:] = 1, 1
    pad = torch.roll(pad, (-s, -s), (0, 1))
    keys = pad.view(pad.shape[0] // w, w, pad.shape[1] // w, w).permute(0, 2, 1, 3)
    return mask - 100.0 * keys.reshape(-1, 1, w * w)


@pytest.mark.parametrize("fault", [_no_mask, _padding_masked],
                         ids=["shift_mask_dropped", "padding_masked"])
def test_a_planted_swin_fault_fails(monkeypatch, fault):
    """The shifted block without its region mask, or with its padded keys
    masked (mmdetection attends them): each output sits orders of
    magnitude past the tolerance."""
    original = ShiftWindowMSA.mask
    monkeypatch.setattr(ShiftWindowMSA, "mask",
                        lambda self, Hp, Wp, device: fault(self, original(self, Hp, Wp, device)))
    out, _ = block_gaps(True)
    assert out > 100 * BLOCK_TOL, out


def test_relative_position_index_and_windows_follow_mmdetection():
    """mmdetection's ``double_step_seq`` table index, flipped, and the
    original Swin's coordinate form give the same index."""
    from lss_carla_torch.models.swin import relative_position_index
    w = 7
    seq = (torch.arange(0, 13 * w, 13)[:, None] + torch.arange(w)[None, :]).reshape(1, -1)
    mmdet = (seq + seq.T).flip(1)
    assert torch.equal(relative_position_index(w), mmdet)
    assert torch.equal(R.relative_index(w), mmdet)


# --- the whole model ------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = cfg_of(drop_path=0.2)
    return cfg, R.make_weights(cfg, 5, "cpu"), inputs(cfg, 1)


def test_the_train_forward_matches_the_reference(small):
    """Train mode, stochastic depth at 0.2 drawn by the port and followed
    by the reference: the logits and the focal loss. f32 on both sides;
    train-mode BN over one sample's small planes amplifies ulps to about
    2e-5 (read 1.5e-5 and 1.8e-5 with and without the draws)."""
    cfg, w, b = small
    m = port_of(cfg, w).train()
    masks, handles = record_drop_paths(m)
    torch.manual_seed(0)
    logits = m(*b[:6])
    for h in handles:
        h.remove()
    assert len(masks) == 22 and any(not k.all() for k in masks.values())
    p, _ = R._params(w)
    want = R.forward(p, cfg, b, train=True, masks=masks)
    assert gap(logits, want) <= 1e-4
    loss = sigmoid_focal_loss(logits, b[6])
    assert float(loss.detach()) == pytest.approx(float(R.focal(want, b[6])), rel=1e-5)


def test_the_first_steps_gradients_match_the_reference(small):
    """The focal loss's gradient of every parameter, in eval mode (BN from
    its running stats), where f32 is well conditioned: each within 1e-3.
    The two geometries round differently, so a frustum point within an
    ulp of a voxel's edge can land in the neighbour, which moves every
    gradient by about 1e-4 (read 2.0e-6 at most on one draw, 3.0e-4 on
    this one). In train mode at initialisation the reference
    itself moves by 0.5 % (median parameter) under a 1e-7 relative nudge
    of its weights, so the train-mode gradients are held to the median
    parameter's 2e-2."""
    cfg, w, b = small
    p, names = R._params(w)
    for mode in ("eval", "train"):
        m = port_of(cfg_of(), w).train(mode == "train")
        loss = sigmoid_focal_loss(m(*b[:6]), b[6])
        loss.backward()
        want = R.focal(R.forward(p, cfg_of(), b, train=mode == "train"), b[6])
        grads = torch.autograd.grad(want, [p[n] for n in names])
        mine = dict(m.named_parameters())
        gaps = [gap(mine[n].grad, g) for n, g in zip(names, grads)]
        if mode == "eval":
            assert max(gaps) <= 1e-3, max(gaps)
        else:
            assert statistics.median(gaps) <= 2e-2, statistics.median(gaps)


def test_the_reference_shapes_are_the_ports_state_dict():
    """The published configuration's parameters and BN stats, names,
    shapes and order, as the reference works them out and as the port's
    model holds them (built on the meta device)."""
    import json
    cfg = json.loads((ROOT / "benchmark/configs/bevfusion-cam-seg.json").read_text())
    with torch.device("meta"):
        m = port_of(cfg, device="meta")
    assert [(k, tuple(v.shape)) for k, v in m.state_dict().items()] == \
        [(k, tuple(s)) for k, s in R.param_shapes(cfg)]


def test_the_train_step_takes_the_models_loss():
    """``make_train_step`` reads the model's ``loss``: BEVFusion's focal,
    LSS's BCE by default; another name raises."""
    cfg = cfg_of()
    m = port_of(cfg, R.make_weights(cfg, 2, "cpu"))
    assert make_train_step(m, device="cpu").loss == "sigmoid_focal"
    lss = compile_model(GridConf(), DataAugConf(), device="cpu")
    assert make_train_step(lss, device="cpu").loss == "bce"
    lss.loss = "l2"
    with pytest.raises(ValueError):
        make_train_step(lss, device="cpu")


# --- loss and optimizer -----------------------------------------------------

def test_focal_loss_is_its_formula():
    """(1 - p_t)^2 x BCE, each class's mean, summed over the classes:
    against the formula written out per element in float64, and the
    reference's (f32 throughout; 1e-6 relative)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 6, 5, 7, generator=g) * 4
    targets = (torch.rand(2, 6, 5, 7, generator=g) < 0.3).float()
    x, y = logits.double(), targets.double()
    p = 1 / (1 + torch.exp(-x))
    ce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    p_t = y * p + (1 - y) * (1 - p)
    want = sum(float(((1 - p_t[:, c]) ** 2 * ce[:, c]).mean()) for c in range(6))
    got = float(sigmoid_focal_loss(logits, targets))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(float(R.focal(logits, targets)), rel=1e-6)


@pytest.mark.parametrize("kind,reference", [("adam", torch.optim.Adam),
                                            ("adamw", torch.optim.AdamW)])
def test_the_optimizer_is_torchs(kind, reference):
    """Four updates of the port's optimizer (optax's clip, the cosine
    schedule with warm-up) against torch's own after the same clip, with
    the same learning rates; "adamw" decouples the decay, "adam" folds it
    into the gradient, as before. Bit for bit (the same kernels)."""
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (7,), (2, 3, 3)]
    a = [torch.randn(s, generator=g).requires_grad_(True) for s in shapes]
    b = [t.detach().clone().requires_grad_(True) for t in a]
    opt = make_optimizer(a, lr=2e-3, weight_decay=0.01, max_grad_norm=1.0,
                         lr_schedule="cosine", warmup_steps=2, decay_steps=10,
                         optimizer=kind)
    ref = reference(b, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for count in range(4):
        grads = [torch.randn(s, generator=g) * 3 for s in shapes]
        for x, y, gr in zip(a, b, grads):
            x.grad, y.grad = gr.clone(), gr.clone()
        opt.step(count)
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in grads]))
        if norm >= 1.0:
            for y in b:
                y.grad = y.grad / norm * 1.0
        ref.param_groups[0]["lr"] = opt.schedule(count)
        ref.step()
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_adamw_decays_the_weights_apart_from_the_moments():
    """With a zero gradient AdamW scales each weight by 1 - lr x decay and
    its first moment stays 0; Adam's L2 term enters the moment."""
    w = torch.ones(3, requires_grad=True)
    opt = make_optimizer([w], lr=0.1, weight_decay=0.5, max_grad_norm=0.0,
                         optimizer="adamw")
    w.grad = torch.zeros(3)
    opt.step(0)
    assert torch.allclose(w.detach(), torch.full((3,), 0.95))
    assert not opt.adam.state[w]["exp_avg"].any()
    with pytest.raises(ValueError):
        make_optimizer([w], optimizer="sgd")


# --- counters and spans ---------------------------------------------------

def windows_of(cfg, images):
    """{kind: windows} a forward computes: every block's windows of 7 x 7
    over its stage's token map padded up, stage by stage."""
    h, w = cfg["image_size"][0] // 4, cfg["image_size"][1] // 4
    plain = shifted = 0
    for depth in cfg["swin"]["depths"]:
        n = -(-h // 7) * -(-w // 7) * images
        plain += n * ((depth + 1) // 2)
        shifted += n * (depth // 2)
        h, w = -(-h // 2), -(-w // 2)
    return {"plain": plain, "shifted": shifted}


def test_a_forward_counts_its_windows_and_spans(monkeypatch):
    """The wrapper counts each forward's windows by kind and its calls,
    one a Swin block; a replay adds what its capture recorded; under a
    profiler the forward's five spans enter the port's span table."""
    for name in ("windows", "captured", "replayed", "calls"):
        monkeypatch.setattr(WA, name, {k: 0 for k in WA.KINDS})
    cfg = cfg_of()
    m = port_of(cfg, R.make_weights(cfg, 3, "cpu")).eval()
    b = inputs(cfg, 2)
    trace.reset()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        m(*b[:6])
    spans = trace.table()
    for stage in ("trunk", "neck", "lift", "bev", "head"):
        assert spans[f"lss.bevfusion.{stage}"][0] == 1, stage
    want = windows_of(cfg, 2)
    assert want == {"plain": 72, "shifted": 72}
    assert WA.computed() == want
    assert WA.calls == {"plain": 6, "shifted": 6}
    WA.add_replayed({"plain": 5, "shifted": 7})
    assert WA.computed() == {"plain": 77, "shifted": 79}
    assert WA.calls == {"plain": 6, "shifted": 6}
    WA.reset_windows()
    assert WA.computed() == {"plain": 0, "shifted": 0}
    assert WA.calls == {"plain": 0, "shifted": 0}


def test_the_reference_imports_neither_package():
    """The plain reference imports torch and the standard library only:
    no JAX, no ``lss_carla_tpu``, nothing of the port."""
    tree = ast.parse((ROOT / "benchmark" / "reference" / "bevfusion.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert mods <= {"__future__", "math", "typing", "torch"}, mods


# --- on the card -------------------------------------------------------------

CELL = dict(final=(256, 704), image=(900, 1600), bsz=4, accum=1, ema=0.0,
            cells=(-50.0, 50.0, 0.5), outC=len(MAP_CLASSES), warmup=500, decay=17580)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the graph and the splat kernel run only there)")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def cell_model(device, seed=0):
    grid = GridConf(xbound=(-51.2, 51.2, 0.4), ybound=(-51.2, 51.2, 0.4),
                    zbound=(-10.0, 10.0, 20.0), dbound=(1.0, 60.0, 0.5))
    aug = DataAugConf(H=256, W=704, final_dim=(256, 704))
    return compile_bevfusion(grid, aug, device=device, compute_dtype="bfloat16",
                             generator=torch.Generator().manual_seed(seed))


@pytest.mark.gpu
def test_graph_step_equals_the_eager_step_at_the_cells_shapes(cuda):
    """Six AdamW steps of the cell's recipe (bf16, bsz 4, 256 x 704, 118
    depth bins, 256 x 256 lift, 200 x 200 x 6 output, focal loss, clip 35,
    stochastic depth 0.2), one capture and five replays, each from the
    eager path's state with the same draws, held as
    ``tests/test_torch_cuda_graph.py::check`` holds the other cells'; the
    replays add the windows their capture recorded."""
    import test_torch_cuda_graph as G
    from lss_carla_torch.training.state import create_train_state
    mg = cell_model(cuda)
    paths = []
    for m in (mg, copy.deepcopy(mg), copy.deepcopy(mg)):
        step = make_train_step(m, accum_steps=1, device=cuda, forward=None if m is mg else m)
        paths.append((step, create_train_state(m, lr=2e-4, weight_decay=0.01,
                                               max_grad_norm=35.0, lr_schedule="cosine",
                                               warmup_steps=500, decay_steps=17580,
                                               optimizer="adamw")))
    replica = create_train_state(copy.deepcopy(mg), lr=2e-4, weight_decay=0.01,
                                 max_grad_norm=35.0, lr_schedule="cosine", warmup_steps=500,
                                 decay_steps=17580, optimizer="adamw")
    step_g = paths[0][0]
    feed = G.batches(CELL, G.STEPS, 1, cuda)
    WA.reset_windows()
    rows = G.steps_against_eager(CELL, feed, 100, (*paths, replica))
    assert (step_g.graph.captures, step_g.graph.replays) == (1, G.STEPS - 1)
    per_forward = windows_of({"image_size": [256, 704], "swin": SWIN_T}, 24)
    assert step_g.graph.graph.windows == per_forward
    assert WA.replayed == {k: (G.STEPS - 1) * v for k, v in per_forward.items()}
    G.check(rows)


@pytest.mark.gpu
def test_the_splat_at_the_cells_points(cuda):
    """The bf16 segment splat at the cell's 4 x 6 x 118 x 32 x 88 = 7.97 M
    points of 80 channels onto 256 x 256 slots, on the voxel ids the cell's
    rig gives: two calls bit-equal, and bit-equal to the plain version
    on the CPU (f32 sums in point order)."""
    from benchmark.fixture import rig as frozen_rig
    from lss_carla_torch.ops import splat as S
    from lss_carla_torch.ops import splat_cuda
    from lss_carla_torch.ops.geometry import get_geometry
    m = cell_model(cuda)
    rng = np.random.default_rng(4)
    rots, trans, intrins, post_rots, post_trans = (torch.from_numpy(a).to(cuda) for a in
                                                   frozen_rig(rng, 4, 6, (900, 1600)))
    post_rots[..., :2, :2] *= 0.48
    post_trans[..., 0], post_trans[..., 1] = -32.0, -176.0
    geom = get_geometry(m.frustum, rots, trans, intrins, post_rots, post_trans)
    ids, valid = S.voxel_indices(geom, m.grid_dx, m.grid_bx, m.nx)
    ids = ids.reshape(4, -1).contiguous()
    assert ids.shape[1] * 4 == 7_974_912 and float(valid.float().mean()) > 0.5
    g = torch.Generator(device=cuda).manual_seed(0)
    pts = torch.randn(4, ids.shape[1], 80, generator=g, device=cuda).to(torch.bfloat16)
    plan = splat_cuda.plan_splat(4, ids.shape[1], 65536)
    got = splat_cuda.splat_forward(pts, ids, 65536)
    again = splat_cuda.splat_forward(pts, ids, 65536)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int16)
    assert torch.equal(bits(got), bits(again))
    want = S.splat_reference(pts.cpu(), ids.cpu(), 65536)
    assert torch.equal(bits(got.cpu()), bits(want)), plan
