"""Pyramidal Lucas-Kanade optical flow: the flow sidecar's model with no
weights.

Port of ``zero_tig_tpu/models/classical_flow.py`` (:30-156): gray frames, a
pyramid of 2x2 means (a level must hold twice the window), and per level,
coarse to fine, ``iters`` updates from the box-summed normal equations of
the warped second frame: central-difference gradients with the edges
replicated, a Shi-Tomasi gate (no update where the structure tensor's
smaller eigenvalue is at most 1e-5 per window pixel), steps clamped to +-2
px, and the flow clamped to the field of view. All f32, in either precision
mode. Flow convention as the learned models: img1(x) matches
img2(x + flow(x)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from ..ops.sampling import coords_grid, grid_sample_pixel


def _gray(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 255] -> (B, H, W, 1) gray in [0, 1]."""
    return torch.mean(img, dim=-1, keepdim=True) / 255.0


def _box(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box sum of (B, H, W, 1), zero outside, as separable shifted adds."""
    p = k // 2
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 0, 0, p, p))
    acc = xp[:, 0:h]
    for i in range(1, k):
        acc = acc + xp[:, i:i + h]
    xp = F.pad(acc, (0, 0, p, p))
    acc = xp[:, :, 0:w]
    for i in range(1, k):
        acc = acc + xp[:, :, i:i + w]
    return acc


def _grad_xy(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients of (B, H, W, 1), edges replicated."""
    gp = torch.cat([g[:, :, :1], g, g[:, :, -1:]], dim=2)
    ix = 0.5 * (gp[:, :, 2:] - gp[:, :, :-2])
    gp = torch.cat([g[:, :1], g, g[:, -1:]], dim=1)
    iy = 0.5 * (gp[:, 2:] - gp[:, :-2])
    return ix, iy


def _lk_refine(g1: torch.Tensor, g2: torch.Tensor, flow: torch.Tensor, iters: int, window: int) -> torch.Tensor:
    """``iters`` LK updates of (B, H, W, 2) ``flow`` at one pyramid level."""
    b, h, w, _ = g1.shape
    grid = coords_grid(b, h, w, device=g1.device)
    lam_tau = 1e-5 * (window * window)
    for _ in range(iters):
        pos = grid + flow
        g2w = grid_sample_pixel(g2, pos[..., 0], pos[..., 1])
        ix, iy = _grad_xy(g2w)
        it = g2w - g1
        sxx = _box(ix * ix, window)
        syy = _box(iy * iy, window)
        sxy = _box(ix * iy, window)
        sxt = _box(ix * it, window)
        syt = _box(iy * it, window)
        tr = sxx + syy
        disc = torch.sqrt(torch.square(sxx - syy) + 4.0 * torch.square(sxy))
        lam_min = 0.5 * (tr - disc)
        det = sxx * syy - sxy * sxy
        ok = (lam_min > lam_tau) & (torch.abs(det) > 1e-12)
        inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
        du = (sxy * syt - syy * sxt) * inv_det
        dv = (sxy * sxt - sxx * syt) * inv_det
        flow = flow + torch.clamp(torch.cat([du, dv], dim=-1), -2.0, 2.0)
    bound = torch.tensor([w, h], dtype=torch.float32, device=flow.device)
    return torch.minimum(torch.maximum(flow, -bound), bound)


def _down(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean of (B, H, W, 1), an odd last row or column dropped."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    return x[:, : 2 * h2, : 2 * w2].reshape(x.shape[0], h2, 2, w2, 2, 1).mean(dim=(2, 4))


class LucasKanade(nn.Module):
    """No parameters: a module so that the registry treats it as the others."""

    def forward(
        self, img1: torch.Tensor, img2: torch.Tensor, iters: int = 3, *,
        levels: int = 4, window: int = 11, dtype: torch.dtype = torch.float32,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(flow at the coarsest level, flow at full resolution) between
        (B, H, W, 3) frames in [0, 255]; ``iters`` updates a level. f32
        whatever ``dtype``."""
        del dtype
        pyr1, pyr2 = [_gray(img1.float())], [_gray(img2.float())]
        for _ in range(levels - 1):
            p1 = pyr1[-1]
            # a level must comfortably contain the window, or its structure
            # tensors are boundary-dominated noise that the upsampling amplifies
            if min(p1.shape[1] // 2, p1.shape[2] // 2) < 2 * window:
                break
            pyr1.append(_down(p1))
            pyr2.append(_down(pyr2[-1]))

        flow = pyr1[-1].new_zeros(*pyr1[-1].shape[:3], 2)
        flow_low = None
        for lvl in range(len(pyr1) - 1, -1, -1):
            p1, p2 = pyr1[lvl], pyr2[lvl]
            if flow.shape[1:3] != p1.shape[1:3]:
                scale = torch.tensor([p1.shape[2] / flow.shape[2], p1.shape[1] / flow.shape[1]],
                                     dtype=torch.float32, device=flow.device)
                flow = resize_bilinear(flow, (p1.shape[1], p1.shape[2]), align_corners=False) * scale
            flow = _lk_refine(p1, p2, flow, iters, window)
            if flow_low is None:
                flow_low = flow
        return flow_low, flow
