"""Bilinear sampling (``F.grid_sample`` semantics) and pixel-coordinate grids.

Port of ``zero_tig_tpu/ops/sampling.py::grid_sample`` (:290, bilinear, zeros
padding) and ``coords_grid`` (:313). The TPU block-gather formulations
(:136-290) are a TPU layout and have no counterpart here.
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
