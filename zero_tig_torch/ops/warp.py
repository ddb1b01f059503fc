"""Backward warp of the previous output by RAFT flow.

Port of ``zero_tig_tpu/ops/warp.py::warp_tensor`` (exact bilinear path),
including the reference's scale-swap quirk: ``map_x`` is multiplied by the
HEIGHT scale and ``map_y`` by the WIDTH scale (warp.py:51-53). Both are 3.0
at 1080p with of_scale=3, but the quirk changes the result on any frame
whose two scales differ. The port samples exactly in both precision modes.
"""

from __future__ import annotations

import torch

from .resize import resize_bilinear
from .sampling import coords_grid, grid_sample


def warp_tensor(flow: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Warp img (B, H, W, C) by flow (B, Hf, Wf, 2) given at flow resolution
    (the /8-padded RAFT size); (x, y) channel order."""
    b, hf, wf, _ = flow.shape
    h_dst, w_dst = img.shape[1], img.shape[2]
    h_scale = float(h_dst) / float(hf)
    w_scale = float(w_dst) / float(wf)
    base = coords_grid(b, hf, wf, device=flow.device)
    flow = flow.float()
    # reference quirk: h_scale on x, w_scale on y
    map_x = (base[..., 0] - flow[..., 0]) * h_scale
    map_y = (base[..., 1] - flow[..., 1]) * w_scale
    maps = resize_bilinear(
        torch.stack([map_x, map_y], dim=-1), (h_dst, w_dst), align_corners=False
    )
    grid = torch.stack(
        [
            maps[..., 0] / ((w_dst - 1) / 2.0) - 1.0,
            maps[..., 1] / ((h_dst - 1) / 2.0) - 1.0,
        ],
        dim=-1,
    )
    return grid_sample(img, grid, align_corners=False)
