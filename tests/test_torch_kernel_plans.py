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
* the f32 splat's tile-sort-and-reduce: sorting each tile's ids, dropping
  the sentinel and summing runs gives ``splat_reference`` within the
  summation-order bound;
* the segment splat's plan (``splat_cuda.plan_splat``: segments, tile
  rounds, chunk queue, scratch and shared memory) and its four phases
  emulated step for step, which equal ``splat_reference`` bit for bit.

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
    ids, num_slots = voxel_ids(2)
    ids = torch.from_numpy(ids).contiguous()
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


R, K, ROUND, WARPS = (splat_cuda.SEG_SLOTS, splat_cuda.CHUNK_POINTS,
                      splat_cuda.THREADS, splat_cuda.WARPS)


def emulate_splat(pts, ids, num_slots, alloc_order=None):
    """Test-only numpy emulation of the splat kernel's four phases, step
    for step: the (tile, segment) ranks from each warp's groups, the scan
    table's per-segment scan over tiles, buckets reserved in
    ``alloc_order`` (the kernel's atomic allocator serves segments in
    whatever order its warps come), the scatter, then each work item's
    per-warp slot counts, slot offsets, chunk ownership, grouped points and
    point-order f32 sums. Returns (f32 sums (B, S, C), writes of each
    output row (B, S), chunks placing each point (B, P), chunks a
    segment (B, nseg))."""
    B, P, C = pts.shape
    S = num_slots
    plan = splat_cuda.plan_splat(B, P, S)
    nseg, tiles, tp = plan.nseg, plan.tiles, plan.rounds * ROUND

    # A: each round's warps publish (segment, count); a point's rank is
    # the column's count before the round, the earlier warps' and lanes'
    table = np.zeros((B, nseg, tiles), np.int64)
    rank = np.full((B, P), -1, np.int64)
    for b in range(B):
        for t in range(tiles):
            for r in range(plan.rounds):
                p0 = t * tp + r * ROUND
                pt = np.arange(p0, p0 + ROUND)
                idv = np.where(pt < P, ids[b, np.minimum(pt, P - 1)], -1)
                key = np.where((idv >= 0) & (idv < S), idv // R, -1)
                lists = []
                for w in range(WARPS):
                    k = key[32 * w:32 * w + 32]
                    groups = {}
                    for g in k[k >= 0]:
                        groups[g] = groups.get(g, 0) + 1
                    lists.append(groups)
                base = {g: table[b, g, t] for g in set(key[key >= 0].tolist())}
                for i in np.flatnonzero(key >= 0):
                    w, g = i // 32, key[i]
                    before = sum(lists[v].get(g, 0) for v in range(w))
                    lanes = int((key[32 * w:i] == g).sum())
                    rank[b, pt[i]] = base[g] + before + lanes
                for g, n0 in base.items():  # the first warp's leader writes
                    table[b, g, t] = n0 + sum(lst.get(g, 0) for lst in lists)

    # B: exclusive scan over tiles; buckets reserved in alloc_order
    count = table.sum(-1)
    offset = np.cumsum(table, -1) - table
    order = np.arange(B * nseg) if alloc_order is None else alloc_order
    start = np.zeros(B * nseg, np.int64)
    at = 0
    for s in order:
        start[s], at = at, at + count.reshape(-1)[s]
    start = start.reshape(B, nseg)
    chunks = np.where(count > K, -(-count // K), 1)

    # C: scatter
    bucket = np.full(B * P, -1, np.int64)
    for b in range(B):
        for p in range(P):
            if 0 <= ids[b, p] < S:
                g, t = ids[b, p] // R, p // tp
                pos = start[b, g] + offset[b, g, t] + rank[b, p]
                assert bucket[pos] == -1
                bucket[pos] = p

    # D: every (segment, chunk): per-warp slot counts, slot offsets, the
    # chunk's slots, its points grouped by slot, each run summed in point
    # order in f32 from 0 and its row written
    out = np.zeros((B, S, C), np.float32)
    writes = np.zeros((B, S), np.int64)
    placed = np.zeros((B, P), np.int64)
    for b in range(B):
        for g in range(nseg):
            n, st, m = count[b, g], start[b, g], chunks[b, g]
            seg_pts = bucket[st:st + n]
            slot = ids[b, seg_pts] - g * R
            per_warp = -(-n // WARPS)
            cnt = np.zeros((WARPS, R), np.int64)
            for w in range(WARPS):
                lo, hi = min(n, w * per_warp), min(n, w * per_warp + per_warp)
                np.add.at(cnt[w], slot[lo:hi], 1)
            total = cnt.sum(0)
            slot_start = np.cumsum(total) - total
            warp_base = np.cumsum(cnt, 0) - cnt
            slot_chunk = np.minimum(slot_start // K, m - 1)
            nslots = min(R, S - g * R)
            for j in range(m):
                grouped = np.full(n, -1, np.int64)
                cursor = warp_base.copy()
                for w in range(WARPS):
                    lo, hi = min(n, w * per_warp), min(n, w * per_warp + per_warp)
                    for i in range(lo, hi):
                        sl = slot[i]
                        if slot_chunk[sl] == j:
                            grouped[slot_start[sl] + cursor[w, sl]] = seg_pts[i]
                            cursor[w, sl] += 1
                            placed[b, seg_pts[i]] += 1
                for sl in range(nslots):
                    if slot_chunk[sl] != j:
                        continue
                    acc = np.zeros(C, np.float32)
                    for k in range(slot_start[sl], slot_start[sl] + total[sl]):
                        acc = acc + pts[b, grouped[k]]
                    out[b, g * R + sl] = acc
                    writes[b, g * R + sl] += 1
    return out, writes, placed, chunks


def voxel_ids(B, ncams=3):
    """Ids from voxel_indices at a tiny rig: consecutive points of one
    (camera, depth) slab share voxels."""
    grid = GridConf(xbound=(-10.0, 10.0, 1.0), ybound=(-10.0, 10.0, 1.0),
                    zbound=(-10.0, 10.0, 20.0), dbound=(2.0, 12.0, 2.0))
    final_dim, downsample, N = (32, 64), 8, ncams
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
    assert 0 < valid.float().mean() < 1
    return ids.reshape(B, -1).numpy(), int(nx[0] * nx[1] * nx[2])


def splat_case(case, C, seed=0):
    """(pts f32 numpy with NaN at dropped points, int32 ids, S)."""
    rng = np.random.default_rng(seed)
    if case == "voxel_ids":
        ids, num_slots = voxel_ids(2)
    elif case == "random_ids":  # a ragged last segment and tile
        num_slots = 3 * R + 45
        ids = rng.integers(-3, num_slots + 3, size=(2, 2 * ROUND + 77))
    elif case == "heavy_segment":  # 1,500 points on 2 segments: 3 chunks each
        num_slots = 4 * R
        ids = rng.integers(R, 3 * R, size=(2, 3000))
        ids[:, ::7] = 2 * R + 5  # one long run across chunk boundaries
    elif case == "sentinel_item":  # item 1 has no point in the grid
        num_slots = 2 * R
        ids = rng.integers(0, num_slots, size=(2, 700))
        ids[1] = num_slots
    ids = ids.astype(np.int32)
    pts = rng.normal(size=(*ids.shape, C)).astype(np.float32)
    pts[(ids < 0) | (ids >= num_slots)] = np.nan  # dropped points never read
    return pts, ids, num_slots


def bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [3, 64])
@pytest.mark.parametrize("case", ["random_ids", "voxel_ids", "heavy_segment",
                                  "sentinel_item"])
def test_splat_emulation_equals_reference_bit_for_bit(case, C, dtype):
    """The kernel's algorithm, emulated, against splat_reference on the
    CPU: bit for bit, since both sum each slot in f32 in point order from
    0 and round once (index_add_ on the CPU adds rows in index order).
    Every output row is written once, every in-grid point placed by one
    chunk, and where a segment holds more than K points it is cut into
    chunks."""
    pts, ids, num_slots = splat_case(case, C)
    x = torch.from_numpy(pts).to(dtype)
    sums, writes, placed, chunks = emulate_splat(x.float().numpy(), ids, num_slots)
    got = torch.from_numpy(sums).to(dtype)
    want = S.splat_reference(x, torch.from_numpy(ids), num_slots)
    assert torch.isfinite(got).all()
    assert torch.equal(bits(got), bits(want))
    assert (writes == 1).all()
    valid = (ids >= 0) & (ids < num_slots)
    assert (placed[valid] == 1).all() and (placed[~valid] == 0).all()
    assert (chunks > 1).any() == (case == "heavy_segment")
    if case == "sentinel_item":
        assert not got[1].any()


def test_splat_emulation_takes_several_rounds_a_tile(monkeypatch):
    """With a table budget this small the tiles grow to several 256-point
    rounds, whose counts carry from round to round; the result is the
    same bits."""
    monkeypatch.setattr(splat_cuda, "TABLE_BUDGET", 8)
    pts, ids, num_slots = splat_case("random_ids", 5)
    plan = splat_cuda.plan_splat(*ids.shape, num_slots)
    assert plan.rounds > 1 and plan.tiles < -(-ids.shape[1] // ROUND)
    sums, writes, _, _ = emulate_splat(pts, ids, num_slots)
    want = S.splat_reference(torch.from_numpy(pts), torch.from_numpy(ids), num_slots)
    assert torch.equal(bits(torch.from_numpy(sums)), bits(want))
    assert (writes == 1).all()


def test_splat_emulation_does_not_depend_on_bucket_order():
    """The kernel reserves buckets in whatever order its warps reach the
    allocator: any order gives the same bits."""
    pts, ids, num_slots = splat_case("heavy_segment", 8, seed=1)
    nseg = splat_cuda.plan_splat(*ids.shape, num_slots).nseg
    first = emulate_splat(pts, ids, num_slots)[0]
    order = np.random.default_rng(2).permutation(ids.shape[0] * nseg)
    again = emulate_splat(pts, ids, num_slots, alloc_order=order)[0]
    assert np.array_equal(first.view(np.int32), again.view(np.int32))


# (B, P, S): B0 and the stretch grid at their batch sizes, the nuScenes
# batches (5 and 6 cameras), a grid rank's half, tiny and ragged shapes,
# and the largest S the kernel takes
PLAN_SHAPES = [(8, 43296, 40000), (4, 43296, 160000), (4, 36080, 40000),
               (4, 43296, 40000), (2, 43296, 20000), (1, 1, 1), (3, 257, 257),
               (2, 5000, 700), (1, 1000, 2 ** 31 - 1), (64, 43296, 40000)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_splat_plan_covers_every_slot_and_point_once(shape):
    B, P, num_slots = shape
    plan = splat_cuda.plan_splat(B, P, num_slots)
    # segments: [g R, min(S, (g + 1) R)) for g < nseg cover [0, S) once
    assert (plan.nseg - 1) * R < num_slots <= plan.nseg * R
    if num_slots <= 10 ** 6:
        seg = np.arange(num_slots) // R
        assert np.array_equal(np.bincount(seg, minlength=plan.nseg),
                              [min(R, num_slots - g * R) for g in range(plan.nseg)])
    # tiles of whole rounds cover [0, P) once, and the table fits its budget
    tp = plan.rounds * ROUND
    assert (plan.tiles - 1) * tp < P <= plan.tiles * tp
    segs = B * plan.nseg
    assert segs * plan.tiles <= max(splat_cuda.TABLE_BUDGET, segs)
    assert plan.table_ints == 4 + segs * plan.tiles
    # the queue holds every chunk: segments of n > K points take
    # ceil(n / K) <= 2 n / K each
    assert plan.chunk_cap > 2 * B * P // K
    assert plan.work_ints == (2 * plan.chunk_cap + 2 * B * plan.nseg + 3 * B * P
                              + -(-B * P // 4))
    assert plan.smem_bytes <= splat_cuda.SMEM_LIMIT
    assert B * P < 2 ** 31 and B * plan.nseg < 2 ** 31


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
