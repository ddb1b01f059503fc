"""Bilinear resize with ``F.interpolate`` semantics on NHWC tensors.

Port of ``zero_tig_tpu/ops/resize.py::resize_bilinear``, which reproduces
``F.interpolate(mode="bilinear")`` without antialiasing in both
``align_corners`` modes -- so here it is that call -- and of ``upflow8``
(:141-147).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(
    x: torch.Tensor, size: tuple[int, int], *, align_corners: bool = False
) -> torch.Tensor:
    """Resize (B, H, W, C) to (B, size[0], size[1], C)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """x8 bilinear flow upsample (B, H, W, 2) -> (B, 8H, 8W, 2),
    align_corners=True, values scaled by 8 (reference utils/utils.py:308-310)."""
    h, w = flow.shape[1], flow.shape[2]
    return 8.0 * resize_bilinear(flow, (8 * h, 8 * w), align_corners=True)
