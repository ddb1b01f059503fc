"""Bilinear sampling (``F.grid_sample`` semantics) and pixel-coordinate grids.

Port of ``zero_tig_tpu/ops/sampling.py::grid_sample`` (:290, bilinear, zeros
padding), ``grid_sample_pixel`` (:30-76) and ``coords_grid`` (:313). The TPU
block-gather formulations (:136-290) are a TPU layout and have no
counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(
    img: torch.Tensor, grid: torch.Tensor, *, align_corners: bool = False
) -> torch.Tensor:
    """Sample (B, H, W, C) at normalised (x, y) grid points (B, Hg, Wg, 2).

    The sample is taken in f32 and cast back to img's dtype, as the JAX
    package computes weights and sums in f32 for low-precision images."""
    out = F.grid_sample(
        img.permute(0, 3, 1, 2).float(), grid.float(), mode="bilinear",
        padding_mode="zeros", align_corners=align_corners,
    )
    return out.permute(0, 2, 3, 1).to(img.dtype).contiguous()


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """(B, H, W, 2) f32 grid of (x, y) pixel coordinates."""
    ys, xs = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1).expand(batch, ht, wd, 2).contiguous()


def grid_sample_pixel(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (B, H, W, C) at pixel coordinates x, y (B, ...) ->
    (B, ..., C) f32: ``F.grid_sample(align_corners=True, padding="zeros")``
    on a grid built from pixel coordinates, each of the four corners
    outside [0, W-1] x [0, H-1] weighing zero. The coordinates and weights
    are f32 whatever img's dtype (bf16 holds no pixel index above 256
    exactly). Differentiable in img and in the coordinates, through the
    weights, as the JAX function is."""
    b, h, w, c = img.shape
    x, y = x.float(), y.float()
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(b, h * w, c)

    def corner(xi, yi, weight):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        weight = torch.where(inside, weight, torch.zeros_like(weight))
        xi = xi.to(torch.int64).clamp(0, w - 1)
        yi = yi.to(torch.int64).clamp(0, h - 1)
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(*xi.shape, c)
        return vals.float() * weight[..., None]

    return (corner(x0, y0, wx0 * wy0) + corner(x1, y0, wx1 * wy0)
            + corner(x0, y1, wx0 * wy1) + corner(x1, y1, wx1 * wy1))
