"""All-pairs correlation pyramid and its windowed lookup.

Port of ``zero_tig_tpu/models/raft/corr.py`` (reference model/RAFT/corr.py).
The volume is one matrix product ``f1 . f2^T / sqrt(D)``; the pyramid
average-pools the second image's dims with floor semantics (a level whose
side reaches 0 stays empty and reads as zeros). The lookup samples a
(2r+1)^2 window bilinearly, zero outside, at each level. The reference's
window-transpose quirk is kept: window position (i, j) samples
(x + L[i], y + L[j]), so channel i*(2r+1)+j -- the layout RAFT's weights
expect.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def build_corr_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int, dtype: torch.dtype
) -> list[torch.Tensor]:
    """fmap1, fmap2 (B, H, W, D) -> levels (B*H*W, 1, H/2^i, W/2^i) in dtype
    (bf16 in fast mode halves the bytes each iteration re-reads)."""
    b, h, w, d = fmap1.shape
    f1 = fmap1.reshape(b, h * w, d).float()
    f2 = fmap2.reshape(b, h * w, d).float()
    corr = torch.matmul(f1, f2.transpose(1, 2)) / math.sqrt(d)
    corr = corr.reshape(b * h * w, 1, h, w).to(dtype)
    levels = [corr]
    for _ in range(num_levels - 1):
        hh, ww = corr.shape[-2] // 2, corr.shape[-1] // 2
        if hh and ww:
            corr = F.avg_pool2d(corr, 2, stride=2)
        else:
            corr = corr.new_zeros(corr.shape[0], 1, hh, ww)
        levels.append(corr)
    return levels


def lookup_corr(levels: list[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Windows around coords (B, H1, W1, 2) (pixel x, y at 1/8 resolution)
    -> (B, H1, W1, levels*(2r+1)^2) f32, level-major.

    Bilinear sampling is separable: with hat weights
    wx[q, a, x] = max(0, 1 - |x - (x_q / 2^i + L[a])|) (zero off the level),
    the window is wy @ (field @ wx^T), two batched matrix products."""
    b, h1, w1, _ = coords.shape
    q = b * h1 * w1
    n = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    cx = coords[..., 0].reshape(q, 1).float()
    cy = coords[..., 1].reshape(q, 1).float()
    out = []
    for i, level in enumerate(levels):
        h2, w2 = level.shape[-2:]
        if h2 == 0 or w2 == 0:
            out.append(coords.new_zeros(b, h1, w1, n * n, dtype=torch.float32))
            continue
        sx = cx / 2**i + offs
        sy = cy / 2**i + offs
        xs = torch.arange(w2, dtype=torch.float32, device=coords.device)
        ys = torch.arange(h2, dtype=torch.float32, device=coords.device)
        wx = torch.clamp(1.0 - (xs - sx[:, :, None]).abs(), min=0.0)  # (q, n, w2)
        wy = torch.clamp(1.0 - (ys - sy[:, :, None]).abs(), min=0.0)  # (q, n, h2)
        t = torch.bmm(level.reshape(q, h2, w2).float(), wx.transpose(1, 2))  # (q, h2, n_x)
        s = torch.bmm(wy, t)  # (q, n_y, n_x)
        out.append(s.transpose(1, 2).reshape(b, h1, w1, n * n))
    return torch.cat(out, dim=-1)
