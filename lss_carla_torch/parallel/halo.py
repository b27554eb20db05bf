"""Row exchanges along the BEV grid's X axis, for the grid-parallel decode
(``parallel/grid.py``): the hand-written counterpart of the halo exchanges
XLA's partitioner inserts into JAX's GSPMD program
(``lss_carla_tpu/parallel/grid.py``).

Ownership. An activation of the decode is held on the grid ranks of a
data row as contiguous slabs of its global X rows (dim 2 of NCHW, where
the BEV encoder's X is H). Who owns which rows follows from the
activation's global row count alone: a balanced split of its rows over
the grid ranks, the first ``rows % n_grid`` ranks one row more
(``owned``). Two activations with the same row count are owned alike, so
the layer-1 skip and the upsampled layer-3 output of ``Up`` meet on the
same rank and their concatenation stays local. A rank may own no row
(two rows over four ranks); it still takes part in every collective.

``fetch_rows`` gives each rank the global rows it asks for, with zero
rows outside the activation. Every rank computes every rank's request
from the same sizes, so the send and receive plans agree without a
message; one ``all_to_all_single`` over the grid group moves the rows.
Its backward is the transposed exchange: each gradient row goes back to
its owner and is added into that row. On it stand the two spatial ops of
the BEV encoder: ``conv2d`` (an output slab asks for the input rows its
window covers) and ``upsample`` (align_corners bilinear, whose source
rows come from the global sizes).

The code takes the same path, the same ops in the same order, on every
rank whatever its slab's size, so the autograd graphs of the ranks match
and their backward collectives meet in the same order.

Gloo and CUDA tensors: ranks that share one card run gloo
(``chip_smoke.py`` phase 22; NCCL refuses two ranks on one device).
Gloo's ``all_to_all_single`` takes CUDA tensors, uneven and empty splits
included (torch 2.11 on an H100, where phase 22 runs this module), and
copies them through the host itself, so the exchange needs no staging
of its own.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

Rows = Tuple[int, int]


def owned(n_rows: int, n_grid: int, index: int) -> Rows:
    """Global rows [lo, hi) of an ``n_rows``-row activation that grid rank
    ``index`` owns: a balanced split, the first ``n_rows % n_grid`` ranks
    one row more."""
    q, r = divmod(n_rows, n_grid)
    lo = index * q + min(index, r)
    return lo, lo + q + (index < r)


def _all_to_all(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
                group) -> torch.Tensor:
    """``x``'s dim-0 rows, ``send[h]`` of them to grid rank h in order;
    returns the ``recv[h]`` rows from each h, concatenated in rank order."""
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, list(recv), list(send), group=group)
    return out


class Exchange(torch.autograd.Function):
    """``_all_to_all`` with a gradient: the backward sends each received
    row's cotangent back to where the row came from."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _all_to_all(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.recv, ctx.send, ctx.group), None, None, None


def exchange(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
             group) -> torch.Tensor:
    """Differentiable dim-0 all-to-all over ``group`` (see ``Exchange``)."""
    return Exchange.apply(x, tuple(send), tuple(recv), group)


def _overlap(a: Rows, b: Rows) -> Rows:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, max(lo, hi))


class GridAxis:
    """A data row's grid ranks: their group, their number and this rank's
    index among them."""

    def __init__(self, group, n_grid: int, index: int):
        self.group, self.n, self.index = group, int(n_grid), int(index)

    def rows(self, n_rows: int, index: int = None) -> Rows:
        return owned(n_rows, self.n, self.index if index is None else index)

    def fetch_rows(self, x: torch.Tensor, n_rows: int,
                   need: Callable[[int], Rows]) -> torch.Tensor:
        """This rank's slab ``x`` (N, C, its rows of ``n_rows``, W) ->
        (N, C, hi - lo, W): the global rows [lo, hi) = ``need(index)``,
        zeros where they fall outside [0, n_rows). ``need(h)`` is grid rank
        h's request; every rank must pass the same function."""
        mine = self.rows(n_rows)
        rows = x.permute(2, 0, 1, 3)  # (rows, N, C, W): rows on dim 0
        send, pieces = [], []
        for h in range(self.n):
            a, b = _overlap(mine, _overlap(need(h), (0, n_rows)))
            pieces.append(rows[a - mine[0]:b - mine[0]])
            send.append(b - a)
        lo, hi = need(self.index)
        wanted = _overlap((lo, hi), (0, n_rows))
        recv = [(lambda r: r[1] - r[0])(_overlap(self.rows(n_rows, h), wanted))
                for h in range(self.n)]
        got = exchange(torch.cat(pieces), send, recv, self.group)
        top = min(max(0, -lo), hi - lo)
        bottom = hi - lo - top - sum(recv)
        return F.pad(got.permute(1, 2, 0, 3), (0, 0, top, bottom))

    def conv2d(self, x: torch.Tensor, n_rows: int, weight: torch.Tensor,
               bias=None, stride=(1, 1), padding=(0, 0)):
        """``F.conv2d`` of the global activation (``n_rows`` rows, zero
        padding ``padding``), on this rank's slab. Returns (this rank's
        output slab, the output's global row count). Output rows [j0, j1)
        need input rows [s j0 - p, s (j1 - 1) - p + k)."""
        k, (s, sw), (p, pw) = weight.shape[2], stride, padding
        n_out = (n_rows + 2 * p - k) // s + 1

        def need(h):
            j0, j1 = self.rows(n_out, h)
            return (s * j0 - p, s * (j1 - 1) - p + k) if j1 > j0 else (0, 0)

        j0, j1 = self.rows(n_out)
        xin = self.fetch_rows(x, n_rows, need)
        # an empty slab convolves k zero rows, so that every rank runs the
        # same ops, and keeps none of the result
        xin = F.pad(xin, (pw, pw, 0, 0 if j1 > j0 else k))
        y = F.conv2d(xin, weight, bias, stride=(s, sw))
        return y.narrow(2, 0, j1 - j0), n_out

    def upsample(self, x: torch.Tensor, n_rows: int, scale: int):
        """``F.interpolate(scale_factor=scale, mode="bilinear",
        align_corners=True)`` of the global activation, on this rank's
        slab; returns (slab, global rows). Each output row's two source
        rows and weights come from the global sizes."""
        n_out = n_rows * scale
        i0, i1, w = _source(n_rows, n_out)

        def need(h):
            j0, j1 = self.rows(n_out, h)
            return (int(i0[j0]), int(i1[j1 - 1]) + 1) if j1 > j0 else (0, 0)

        j0, j1 = self.rows(n_out)
        lo = need(self.index)[0]
        xin = self.fetch_rows(x, n_rows, need).to(torch.float32)
        # the Y lerp first, then the X lerp, as PyTorch's kernels nest them
        xin = _lerp(xin, 3, *_source(x.shape[3], x.shape[3] * scale))
        y = _lerp(xin, 2, i0[j0:j1] - lo, i1[j0:j1] - lo, w[j0:j1])
        return y.to(x.dtype), n_out


def _source(n_in: int, n_out: int):
    """align_corners=True sources of ``n_out`` outputs over ``n_in``
    inputs, on the host, as PyTorch's bilinear kernels take them: (i0, i1,
    weight of i1), the scale and the positions in f32."""
    scale = (torch.tensor(float(n_in - 1), dtype=torch.float32)
             / max(n_out - 1, 1))
    pos = scale * torch.arange(n_out, dtype=torch.float32)
    i0 = pos.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    return i0, i1, pos - i0


def _lerp(x: torch.Tensor, dim: int, i0, i1, w) -> torch.Tensor:
    """(1 - w) x[i0] + w x[i1] along ``dim``; host indices and weights."""
    shape = [1] * x.dim()
    shape[dim] = -1
    w = w.to(x.device).view(shape)
    return (x.index_select(dim, i0.to(x.device)) * (1.0 - w)
            + x.index_select(dim, i1.to(x.device)) * w)


def gather_rows(axis: GridAxis, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Every grid rank's slab of an ``n_rows``-row NCHW activation, put
    together on every rank (no gradient): (N, C, n_rows, W)."""
    mine = axis.rows(n_rows)
    rows = x.permute(2, 0, 1, 3).contiguous()
    send = [mine[1] - mine[0]] * axis.n
    recv = [b - a for a, b in (axis.rows(n_rows, h) for h in range(axis.n))]
    full = _all_to_all(torch.cat([rows] * axis.n), send, recv, axis.group)
    return full.permute(1, 2, 0, 3)


def pivot(axis: GridAxis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The lift-to-decode resharding of JAX's grid step, differentiable:
    each grid rank holds its own samples with every X row (``dim`` of
    ``x`` is X); it returns every grid rank's samples, in rank order, with
    this rank's X slab. One all-to-all over the row's grid group; the
    backward is the inverse exchange."""
    n_rows = x.shape[dim]
    mine = axis.rows(n_rows)
    xr = x.movedim(dim, 0)  # (X, b, ...)
    send = [b - a for a, b in (axis.rows(n_rows, h) for h in range(axis.n))]
    got = exchange(xr, send, [mine[1] - mine[0]] * axis.n, axis.group)
    got = got.view(axis.n, mine[1] - mine[0], *xr.shape[1:])
    got = got.movedim(1, dim + 1)  # (n, b, ..., slab, ...)
    return got.reshape(axis.n * x.shape[0], *got.shape[2:])


def gather_samples(axis: GridAxis, x: torch.Tensor) -> torch.Tensor:
    """Every grid rank's samples (dim 0), in rank order, on every rank; no
    gradient (the ``pad_last`` mask)."""
    out = _all_to_all(torch.stack([x] * axis.n), [1] * axis.n, [1] * axis.n,
                      axis.group)
    return out.reshape(axis.n * x.shape[0], *x.shape[1:])

