"""The host-side logic of the port's two CUDA kernels, on the CPU.

The kernels run only on the card (test_torch_cuda.py, chip_smoke.py).
What surrounds them is plain Python and is held here:

* ``mbconv_cuda.plan_tiles``: emulating the kernel's decode of its block
  and thread indices, the planned tiles cover every output of every
  depthwise shape of B0-B4 exactly once, the staging walk writes every
  element of a block's bands once, and the bands fit shared memory;
* the staged bands: each planned input band, copied out of the input with
  the kernel's zero halo and convolved with ``F.conv2d``, equals the plain
  version's output on that tile exactly;
* the splat's tile-sort-and-reduce: sorting each tile's ids, dropping the
  sentinel and summing runs gives ``splat_reference`` within the
  summation-order bound.

No JAX here."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.efficientnet import block_plan
from lss_carla_torch.ops import geometry as G
from lss_carla_torch.ops import mbconv as M
from lss_carla_torch.ops import mbconv_cuda
from lss_carla_torch.ops import splat as S
from lss_carla_torch.ops import splat_cuda

STRIP = mbconv_cuda.STRIP


def depthwise_shapes(variant, final_dim, N):
    """(N, C, H, W, k, s) of every depthwise conv of the trunk, from the
    stem's stride-2 output."""
    H, W = -(-final_dim[0] // 2), -(-final_dim[1] // 2)
    out = []
    for a in block_plan(variant):
        out.append((N, a["cin"] * a["expand"], H, W, a["kernel"], a["stride"]))
        H, W = -(-H // a["stride"]), -(-W // a["stride"])
    return out


def _trunk_shapes():
    shapes = set()
    for variant in ("b0", "b1", "b2", "b3", "b4"):
        for final_dim in (DataAugConf().final_dim, (224, 480)):
            shapes.update(depthwise_shapes(variant, final_dim, 24))
    return sorted(shapes)


# odd sizes, W not a multiple of 4, planes taller and wider than a block
ODD_SHAPES = [(N, C, H, W, k, s) for (N, C, H, W) in
              ((1, 1, 1, 1), (3, 5, 9, 11), (2, 4, 13, 177), (5, 3, 301, 7),
               (2, 2, 7, 1030), (24, 16, 8, 22))
              for k in (3, 5) for s in (1, 2)]


def strips_of(plan, N):
    """Every strip the kernel computes, as arrays (tile, n, oh, ow, nout):
    the kernel's decode of blockIdx and threadIdx and its constant-step
    walk over (image, row), vectorised over tiles and threads."""
    t = np.arange(plan.tiles)
    tile_w = t % plan.tiles_w
    t = t // plan.tiles_w
    band = t % plan.bands
    n0 = (t // plan.bands) * plan.pb
    planes = np.minimum(plan.pb, N - n0)
    oh0 = band * plan.th
    rows = np.minimum(plan.th, plan.Ho - oh0)
    ow0 = tile_w * plan.tw
    cols = np.minimum(plan.tw, plan.Wo - ow0)

    tid = np.arange(plan.rg * plan.sw)
    strip = tid % plan.sw
    cr = tid // plan.sw
    p = np.broadcast_to(cr // plan.th, (plan.tiles, tid.size)).copy()
    r = np.broadcast_to(cr % plan.th, (plan.tiles, tid.size)).copy()
    dp, dr = plan.rg // plan.th, plan.rg % plan.th
    ow_rel = strip * STRIP
    nout = np.minimum(STRIP, cols[:, None] - ow_rel[None, :])
    found = []
    while (p < planes[:, None]).any():
        live = (p < planes[:, None]) & (r < rows[:, None]) & (nout > 0)
        ti, th = np.nonzero(live)
        found.append((ti, n0[ti] + p[ti, th], oh0[ti] + r[ti, th],
                      ow0[ti] + ow_rel[th], nout[ti, th]))
        r += dr
        p += dp
        carry = r >= plan.th
        r[carry] -= plan.th
        p[carry] += 1
    return [np.concatenate(a) for a in zip(*found)]


def staged_hits(plan, planes, ihb):
    """How often the kernel's staging walk writes each element of a block's
    (planes, ihb, pitch) bands: groups of L lanes (32, or the least power
    of two >= pitch) take band rows g, g + G, ... by constant steps of
    (image, row), and a group's lanes take columns col, col + L, ..."""
    pitch = plan.pitch
    L = 32 if pitch >= 32 else 1 << (pitch - 1).bit_length()
    G = plan.threads // L
    hits = np.zeros((planes, ihb, pitch), np.int64)
    for g in range(G):
        p, i = divmod(g, ihb)
        while p < planes:
            for col in range(L):
                hits[p, i, col:pitch:L] += 1
            i += G % ihb
            p += G // ihb
            if i >= ihb:
                i -= ihb
                p += 1
    return hits


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", _trunk_shapes() + ODD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dw_plan_covers_every_output_once(shape, bf16):
    N, C, H, W, k, s = shape
    plan = mbconv_cuda.plan_tiles(N, C, H, W, k, s, bf16)
    assert (plan.Ho, plan.Wo) == (-(-H // s), -(-W // s))
    # what the C launcher checks before it launches
    assert plan.tiles_w == -(-plan.Wo // plan.tw)
    assert plan.sw == -(-plan.tw // STRIP)
    assert plan.bands == -(-plan.Ho // plan.th)
    assert plan.groups == -(-N // plan.pb) and plan.tiles == plan.groups * plan.bands * plan.tiles_w
    assert plan.threads % 32 == 0 and plan.rg * plan.sw <= plan.threads <= 256
    assert plan.pb <= plan.threads  # one thread issues each image's copy
    last = (plan.sw - 1) * STRIP  # the last strip's first column
    if s == 1:  # a window of (STRIP - 1) + k columns, as float4s
        assert plan.pitch % 4 == 0
        assert plan.pitch >= last + -(-(STRIP - 1 + k) // 4) * 4
    else:  # even, then odd columns: two halves of hp, float4 aligned
        hp = plan.pitch // 2
        assert plan.pitch % 8 == 0 and hp >= last + 8
        assert 2 * hp >= (STRIP * plan.sw - 1) * s + k  # every padded column
        # the kernel's stride-2 windows, read from the split row, are the
        # columns 2 (ow + o) + kw of the row as staged in order
        logical = np.arange(plan.pitch)
        split = np.empty_like(logical)
        split[(logical >> 1) + (logical & 1) * hp] = logical
        n_even, n_odd = -(-(STRIP + (k - 1) // 2) // 4) * 4, -(-(STRIP + (k - 2) // 2) // 4) * 4
        for ow in range(0, plan.sw * STRIP, STRIP):
            even, odd = split[ow:ow + n_even], split[hp + ow:hp + ow + n_odd]
            assert len(even) == n_even and len(odd) == n_odd
            for o in range(STRIP):
                for kw in range(k):
                    got = odd[o + kw // 2] if kw & 1 else even[o + kw // 2]
                    assert got == 2 * (ow + o) + kw
    ihb = (plan.th - 1) * s + k
    if bf16:  # a raw slot for each image's input rows
        assert plan.rawstride % 16 == 0 and plan.rawstride >= ihb * W * 2 + 32
    else:
        assert plan.rawstride == 0
    assert plan.smem_bytes == plan.pb * (ihb * plan.pitch * 4 + plan.rawstride)
    assert plan.smem_bytes <= 227 * 1024
    assert C <= 65535 and plan.tiles < 2 ** 31

    _, n, oh, ow, nout = strips_of(plan, N)
    hits = np.zeros((N, plan.Ho, plan.Wo), np.int64)
    for o in range(STRIP):
        m = nout > o
        np.add.at(hits, (n[m], oh[m], ow[m] + o), 1)
    assert hits.min() == 1 and hits.max() == 1

    # the staging walk writes each element of a block's bands once, for a
    # full group of images and for the last (smaller) one
    for planes in {plan.pb, N - (plan.groups - 1) * plan.pb}:
        staged = staged_hits(plan, planes, ihb)
        assert staged.min() == 1 and staged.max() == 1


def stage_band(xp_full, plan, tile, N, k, s):
    """The kernel's shared-memory bands of one tile, all channels at once:
    pb images x ((th - 1) s + k) rows x pitch columns of x, with 0 where a
    row or column falls outside the input (the halo and the pitch's tail).
    ``xp_full`` is x zero-padded by MARGIN above and left, and far enough
    below and right."""
    tile_w = tile % plan.tiles_w
    t = tile // plan.tiles_w
    band, n0 = t % plan.bands, (t // plan.bands) * plan.pb
    planes = min(plan.pb, N - n0)
    ihb = (plan.th - 1) * s + k
    ih0 = band * plan.th * s - plan.pad_h
    iw0 = tile_w * plan.tw * s - plan.pad_w
    return (xp_full[n0:n0 + planes, :, MARGIN + ih0:MARGIN + ih0 + ihb,
                    MARGIN + iw0:MARGIN + iw0 + plan.pitch],
            n0, planes, band * plan.th, tile_w * plan.tw)


MARGIN = 4  # > the largest SAME low-side pad (2)


@pytest.mark.parametrize("shape", [
    (2, 3, 64, 176, 3, 1), (2, 3, 64, 176, 3, 2), (24, 4, 8, 22, 5, 1),
    (24, 4, 8, 22, 5, 2), (3, 5, 9, 11, 5, 2), (2, 4, 13, 177, 3, 1),
    (2, 2, 7, 1030, 5, 2), (5, 3, 301, 7, 3, 2)],
    ids=lambda s: "x".join(map(str, s)))
def test_dw_staged_bands_reproduce_the_plain_version(shape):
    N, C, H, W, k, s = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=(N, C, H, W)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(C, 1, k, k)).astype(np.float32))
    want = M.dw_conv_stats_reference(x, w, s)[0]
    plan = mbconv_cuda.plan_tiles(N, C, H, W, k, s)
    xp_full = F.pad(x, (MARGIN, plan.pitch + MARGIN, MARGIN,
                        plan.th * s + k + MARGIN))
    for tile in range(plan.tiles):
        bands, n0, planes, oh0, ow0 = stage_band(xp_full, plan, tile, N, k, s)
        assert bands.shape[2:] == ((plan.th - 1) * s + k, plan.pitch)
        got = F.conv2d(bands, w, stride=s, groups=C)
        rows, cols = min(plan.th, plan.Ho - oh0), min(plan.tw, plan.Wo - ow0)
        assert torch.equal(got[:, :, :rows, :cols],
                           want[n0:n0 + planes, :, oh0:oh0 + rows, ow0:ow0 + cols])


def tile_sort_reduce(pts, ids, num_slots, tile):
    """Test-only emulation of the splat kernel: each tile of ``tile``
    consecutive points of an item sorts its (id, point) keys, drops ids
    outside [0, S), and sums each run of equal ids in f32 in sorted order;
    the run sums are then added into the f32 accumulator."""
    B, P, C = pts.shape
    acc = np.zeros((B, num_slots, C), np.float32)
    for b in range(B):
        for p0 in range(0, P, tile):
            tid = ids[b, p0:p0 + tile].astype(np.int64)
            valid = (tid >= 0) & (tid < num_slots)
            keys = ((np.where(valid, tid, 2 ** 32 - 1).astype(np.uint64) << np.uint64(32))
                    | np.arange(tid.size, dtype=np.uint64))
            keys = np.sort(keys)[:int(valid.sum())]
            sid = (keys >> np.uint64(32)).astype(np.int64)
            rows = p0 + (keys & np.uint64(2 ** 32 - 1)).astype(np.int64)
            if sid.size == 0:
                continue
            heads = np.flatnonzero(np.r_[True, sid[1:] != sid[:-1]])
            ends = np.r_[heads[1:], sid.size]
            for h, e in zip(heads, ends):
                run = np.zeros(C, np.float32)
                for j in range(h, e):
                    run += pts[b, rows[j]]
                acc[b, sid[h]] += run
    return acc


def _splat_bound(pts, ids, num_slots):
    """Both sides sum a slot's n points in f32 in some order: within
    (n - 1) u sum|x| of the exact sum each (u = 2^-24)."""
    count = S.splat_reference(torch.ones_like(pts[..., :1]), ids, num_slots)
    abs_sum = S.splat_reference(torch.nan_to_num(pts).abs(), ids, num_slots)
    return 2 * count.clamp(min=1) * 2.0 ** -24 * abs_sum + 1e-7


def test_splat_tile_reduce_matches_reference_on_random_ids():
    rng = np.random.default_rng(0)
    B, P, C, num_slots = 2, 3 * splat_cuda.TILE + 45, 8, 40
    pts = rng.normal(size=(B, P, C)).astype(np.float32)
    ids = rng.integers(-3, num_slots + 3, size=(B, P)).astype(np.int32)
    pts[(ids < 0) | (ids >= num_slots)] = np.nan  # dropped points never read
    got = torch.from_numpy(tile_sort_reduce(pts, ids, num_slots, splat_cuda.TILE))
    tp, ti = torch.from_numpy(pts), torch.from_numpy(ids)
    want = S.splat_reference(tp, ti, num_slots)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= _splat_bound(tp, ti, num_slots)).all()


def test_splat_tile_reduce_matches_reference_on_voxel_ids():
    """Ids from voxel_indices at a tiny rig: consecutive points of one
    (camera, depth) slab share voxels, so runs are longer than 1."""
    grid = GridConf(xbound=(-10.0, 10.0, 1.0), ybound=(-10.0, 10.0, 1.0),
                    zbound=(-10.0, 10.0, 20.0), dbound=(2.0, 12.0, 2.0))
    final_dim, downsample, B, N = (32, 64), 8, 2, 3
    frustum = torch.from_numpy(G.create_frustum(final_dim, downsample, grid.dbound))
    dx, bx, nx = G.gen_dx_bx(grid.xbound, grid.ybound, grid.zbound)
    yaw = np.deg2rad([0.0, 120.0, -120.0])
    cam = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rz = np.stack([np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                             [0, 0, 1]], np.float32) for a in yaw])
    rots = torch.from_numpy(np.broadcast_to(rz @ cam, (B, N, 3, 3)).copy())
    trans = torch.zeros(B, N, 3)
    trans[..., 2] = 1.5
    intrins = torch.eye(3).repeat(B, N, 1, 1)
    intrins[..., 0, 0] = intrins[..., 1, 1] = 40.0
    intrins[..., 0, 2], intrins[..., 1, 2] = 32.0, 16.0
    geom = G.get_geometry(frustum, rots, trans, intrins, torch.eye(3).repeat(B, N, 1, 1),
                          torch.zeros(B, N, 3))
    ids, valid = S.voxel_indices(geom, dx, bx, nx)
    ids = ids.reshape(B, -1).contiguous()
    num_slots = int(nx[0] * nx[1] * nx[2])
    assert 0 < valid.float().mean() < 1
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(*ids.shape, 6)).astype(np.float32)
    got = torch.from_numpy(tile_sort_reduce(pts, ids.numpy(), num_slots,
                                            splat_cuda.TILE))
    tp = torch.from_numpy(pts)
    want = S.splat_reference(tp, ids, num_slots)
    assert ((got - want).abs() <= _splat_bound(tp, ids, num_slots)).all()
    # the source-side reduction has something to reduce: fewer runs (the
    # distinct in-grid ids of each tile) than in-grid points
    T = splat_cuda.TILE
    runs = sum(len(torch.unique(row[(row >= 0) & (row < num_slots)]))
               for item in ids for row in item.split(T))
    assert runs < int(((ids >= 0) & (ids < num_slots)).sum())


@pytest.mark.parametrize("shift", [0, 1, 7], ids=["aligned", "mid_word", "odd"])
@pytest.mark.parametrize("shape", [(3, 5, 9, 11, 5, 2), (2, 3, 7, 13, 3, 1),
                                   (24, 4, 8, 22, 5, 1), (2, 2, 5, 1030, 3, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dw_bf16_raw_runs_widen_to_the_input(shape, shift):
    """The bf16 staging's address arithmetic, with element numbers for
    values:
    each image's input rows [r_lo, r_hi) are one run of x; its 16-byte
    aligned cover is bulk-copied when it lies inside x (else the run is
    copied alone at the same offset), and the pad pass reads element
    lead / elem + (ih - r_lo) W + iw of the slot. Every in-plane element
    of every band must come back as itself, x starting on a 16-byte
    boundary or ``shift`` elements past one."""
    N, C, H, W, k, s = shape
    elem = 2
    plan = mbconv_cuda.plan_tiles(N, C, H, W, k, s, True)
    numel = N * C * H * W
    x_addr = 4096 + shift * elem
    x_end = x_addr + numel * elem
    ihb = (plan.th - 1) * s + k
    covers = 0
    for tile in range(plan.tiles):
        t = tile // plan.tiles_w
        band, n0 = t % plan.bands, (t // plan.bands) * plan.pb
        ih0 = band * plan.th * s - plan.pad_h
        r_lo, r_hi = max(ih0, 0), min(ih0 + ihb, H)
        run = max(r_hi - r_lo, 0) * W
        for c in (0, C - 1):
            for p in range(min(plan.pb, N - n0)):
                first = (((n0 + p) * C + c) * H + r_lo) * W  # element
                a = x_addr + first * elem
                a0 = a & ~15
                nbytes = -(-((a - a0) + run * elem) // 16) * 16
                assert nbytes <= plan.rawstride
                if run and a0 >= x_addr and a0 + nbytes <= x_end:
                    covers += 1
                    slot = {(a0 + b - x_addr) // elem: b for b in range(0, nbytes, elem)}
                else:  # the block copies the run itself, at the same offset
                    slot = {first + m: (a - a0) + m * elem for m in range(run)}
                lead = a - a0
                for ih in range(r_lo, r_hi):
                    for iw in range(W):
                        byte = lead + ((ih - r_lo) * W + iw) * elem
                        want = (((n0 + p) * C + c) * H + ih) * W + iw
                        assert slot.get(want) == byte
    assert covers > 0
