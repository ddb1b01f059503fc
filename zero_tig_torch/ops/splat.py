"""Forward interpolation of a flow on its own device: RAFT's warm start.

The reference's ``core/utils/utils.py::forward_interpolate`` (scipy; the
port's host copy is ``utils/misc.py::forward_interpolate``) without leaving
the device: grid point (x, y) of the flow moves to (x + dx, y + dy); the
points that land strictly inside the grid (0 < x1 < w, 0 < y1 < h) are the
sources, and every grid point takes the flow of its nearest source by
Euclidean distance, as scipy's ``griddata(method="nearest")`` does with a
k-d tree queried in float64. The distances here are float64 too, summed in
the tree's order ((gx - x1)^2 + (gy - y1)^2), so the nearest source is the
tree's, except where two sources lie at exactly the same distance from a
grid point: the lower index wins here, the tree's traversal order there.
Where no point is valid the result is zero, as in the reference.

A brute-force masked argmin over all (grid point, source) pairs, in blocks
of grid points of at most ``BLOCK`` pairs: a handful of launches a block,
no copy to the host and no synchronisation.
"""

from __future__ import annotations

import math

import torch

BLOCK = 1 << 24  # pairs a block: 128 MiB a float64 temporary


def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 2) f32 flow, x then y -> (B, h, w, 2) f32: each grid point
    holds the flow of the nearest point that the flow moves inside the grid."""
    b, h, w, _ = flow.shape
    dev = flow.device
    f = flow.float().reshape(b, h * w, 2)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
    gx, gy = xs.reshape(-1), ys.reshape(-1)
    x1 = gx + f[..., 0].double()  # (B, P)
    y1 = gy + f[..., 1].double()
    valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    x1 = x1.masked_fill(~valid, math.inf)  # an invalid source lies at an infinite distance
    step = max(1, BLOCK // (b * h * w))
    idx = []
    for s in range(0, h * w, step):
        d2 = (gx[s:s + step, None] - x1[:, None, :]).square_()  # (B, n, P)
        d2 += (gy[s:s + step, None] - y1[:, None, :]).square_()
        idx.append(d2.argmin(-1))  # the first of equal minima
    idx = torch.cat(idx, 1)
    out = torch.gather(f, 1, idx[..., None].expand(b, h * w, 2))
    out = torch.where(valid.any(1)[:, None, None], out, torch.zeros((), device=dev))
    return out.reshape(b, h, w, 2)
