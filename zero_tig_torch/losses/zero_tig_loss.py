"""The Zero-TIG self-supervised objective: one weighted sum of 17 terms.

Port of ``zero_tig_tpu/losses/zero_tig_loss.py`` (:59-352; reference
``LossFunction``, loss.py:23-78, ``SmoothLoss`` :173-311, ``L_TV``
:139-152) on NHWC tensors, every weight, eps and clip kept, and the
reference's quirks with them:

  * the criterion gets the RAW frame plus 1e-9 (loss.py:24-25), not the
    forward's frame plus 1e-4, so the Res_1 targets sit 1e-4 off the
    forward's L11/L12;
  * the non-white-balance luminance puts 0.299 on channel 2 (loss.py:31);
  * SmoothLoss's yCbCr flattens the NCHW buffer into rows of three
    consecutive values before the colour matrix (loss.py:180-188), so it
    mixes neighbouring pixels of one channel;
  * its 24 shifted terms are 12 offsets, each counted twice;
  * ``weighted_diff2`` blends with H3_denoised1, not H3_denoised2 (loss.py:71).

With a ``Region`` (banded training, ``pipeline/spatial.py``) every tensor is
a row slice of the frame, and every mean becomes a sum over the rows the band
owns divided by the full frame's count, so the bands' losses sum to the
whole frame's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.layers import clip
from ..models.network import TrainOutputs
from ..ops.filters import calculate_local_variance, local_mean, pair_downsampler

EPS = 1e-9

# (dy, dx) of the 12 distinct SmoothLoss directions (loss.py:198-308)
SMOOTH_OFFSETS = (
    (1, 0), (0, 1), (1, 1), (1, -1),
    (2, 0), (0, 2), (2, 1), (2, -1),
    (1, 2), (1, -2), (2, 2), (2, -2),
)
YCBCR_MAT = ((0.257, -0.148, 0.439), (0.564, -0.291, -0.368), (0.098, 0.439, -0.071))
YCBCR_BIAS = (16.0 / 255.0, 128.0 / 255.0, 128.0 / 255.0)


class Region(NamedTuple):
    """The rows [own_start, own_end) of a ``full_h``-row frame that one band
    owns, on tensors that hold the rows [slice_start, slice_start + slice_h)
    (the band and its halo). Row bounds are multiples of 2, the scale of the
    pair-downsampled maps."""

    slice_start: int
    own_start: int
    own_end: int
    full_h: int

    def rows(self, map_h: int, slice_h: int, absolute_cap: int | None = None) -> slice:
        """The owned rows of a map ``map_h`` rows high cut from a slice
        ``slice_h`` rows high (its scale is slice_h // map_h); rows at or
        past ``absolute_cap`` (in the map's full-frame rows) are left out."""
        scale = max(slice_h // map_h, 1) if map_h else 1
        base = self.slice_start // scale
        hi = self.own_end // scale - base
        if absolute_cap is not None:
            hi = min(hi, absolute_cap - base)
        lo = max(self.own_start // scale - base, 0)
        return slice(lo, max(min(hi, map_h), lo))


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def _mse_region(a: torch.Tensor, b: torch.Tensor, region: Region | None, slice_h: int) -> torch.Tensor:
    if region is None:
        return _mse(a, b)
    rows = region.rows(a.shape[1], slice_h)
    scale = max(slice_h // a.shape[1], 1)
    denom = a.shape[0] * (region.full_h // scale) * a.shape[2] * a.shape[3]
    return torch.sum(torch.square(a[:, rows] - b[:, rows])) / denom


def rgb2ycbcr_scrambled(x: torch.Tensor) -> torch.Tensor:
    """The reference's rgb2yCbCr, flattening bug included, NHWC in and out.
    The 3x3 product is written out as f32 multiply-adds, so no TF32 setting
    can reach it (the JAX package asks for HIGHEST)."""
    b, h, w, c = x.shape
    flat = x.permute(0, 3, 1, 2).reshape(-1, 3)
    cols = [
        flat[:, 0] * YCBCR_MAT[0][j] + flat[:, 1] * YCBCR_MAT[1][j] + flat[:, 2] * YCBCR_MAT[2][j]
        + YCBCR_BIAS[j]
        for j in range(3)
    ]
    return torch.stack(cols, -1).reshape(b, c, h, w).permute(0, 2, 3, 1)


def _shift_pair(x: torch.Tensor, dy: int, dx: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The overlapping slices of NHWC x displaced by (dy, dx)."""
    h, w = x.shape[1], x.shape[2]
    a = x[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    b = x[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return a, b


def smooth_loss(
    input_rgb: torch.Tensor,
    output: torch.Tensor,
    region: Region | None = None,
    ycc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Edge-aware smoothness of ``output`` against the scrambled yCbCr of
    ``input_rgb`` (SmoothLoss, sigma 10, p 1).

    With ``region``, a shifted pair belongs to the owner of its row i (it
    pairs rows i + dy and i), and the full frame has no pair for its last dy
    rows. ``ycc`` is then required: the scrambled yCbCr of the FULL frame,
    sliced like ``input_rgb``, because its triplets run over the flattened
    (C, H, W) buffer, so a slice's own transform groups other pixels."""
    if region is not None and ycc is None:
        raise ValueError("region mode needs the full frame's scrambled yCbCr, sliced (ycc=)")
    if ycc is None:
        ycc = rgb2ycbcr_scrambled(input_rgb)
    slice_h = input_rgb.shape[1]
    sigma_color = -1.0 / (2.0 * 10.0 * 10.0)
    total = output.new_zeros((), dtype=torch.float32)
    for dy, dx in SMOOTH_OFFSETS:
        ia, ib = _shift_pair(ycc, dy, dx)
        wgt = torch.exp(torch.sum(torch.square(ia - ib), -1, keepdim=True) * sigma_color)
        oa, ob = _shift_pair(output, dy, dx)
        grad = wgt * torch.sum(torch.abs(oa - ob), -1, keepdim=True)
        if region is None:
            term = torch.mean(grad)
        else:
            rows = region.rows(grad.shape[1], slice_h, absolute_cap=region.full_h - dy)
            term = torch.sum(grad[:, rows]) / (grad.shape[0] * (region.full_h - dy) * grad.shape[2] * grad.shape[3])
        total = total + 2.0 * term
    return total


def tv_loss(x: torch.Tensor, region: Region | None = None) -> torch.Tensor:
    """Total variation (L_TV), NHWC. With ``region``, a vertical pair belongs
    to the owner of its top row, and the counts are the full frame's."""
    b, h, w, _ = x.shape
    dh = torch.square(x[:, 1:] - x[:, :-1])
    dw = torch.square(x[:, :, 1:] - x[:, :, :-1])
    if region is None:
        return 2.0 * (torch.sum(dh) / ((h - 1) * w) + torch.sum(dw) / (h * (w - 1))) / b
    full = region.full_h
    h_tv = torch.sum(dh[:, region.rows(h - 1, h, absolute_cap=full - 1)])
    w_tv = torch.sum(dw[:, region.rows(h, h)])
    return 2.0 * (h_tv / ((full - 1) * w) + w_tv / (full * (w - 1))) / b


def loss_factor(L2d: torch.Tensor, *, is_wb: bool = False) -> torch.Tensor:
    """The enhancement factor (loss.py:26-38) of the detached denoised
    frame: per channel with white balance, else from the luminance."""
    if is_wb:
        factor = 0.3 / (torch.mean(L2d, dim=(1, 2), keepdim=True) + EPS)
    else:
        luma = L2d[..., 2] * 0.299 + L2d[..., 1] * 0.587 + L2d[..., 0] * 0.144
        factor = 0.5 / (torch.mean(luma, dim=(1, 2))[:, None, None, None] + EPS)
    return clip(factor, 1.0, 25.0)


def zero_tig_loss(
    frame: torch.Tensor,
    o: TrainOutputs,
    *,
    is_wb: bool = False,
    region: Region | None = None,
    factor: torch.Tensor | None = None,
    ycc: torch.Tensor | None = None,
) -> torch.Tensor:
    """The weighted objective (LossFunction.forward) of one training frame:
    ``frame`` the raw (B, H, W, 3) input in [0, 1], ``o`` the forward's
    outputs. A 0-d f32 tensor.

    Banded (``region``): ``frame`` and ``o`` are a band's row slice, and the
    frame's two gradient-free global quantities come from the caller: the
    enhancement ``factor`` of the full frame's detached L2 and its scrambled
    yCbCr ``ycc``, sliced like ``frame``."""
    inp = frame + EPS
    slice_h = frame.shape[1]
    L2d = o.L2.detach()
    if factor is None:
        factor = loss_factor(L2d, is_wb=is_wb)
    elif region is None:
        raise ValueError("a factor is given only with a region (banded training)")
    adjustment = torch.pow(0.7, -factor) / factor

    normalized_low = clip(L2d / o.s2, EPS, 0.8)
    enhanced_brightness = torch.pow(L2d * factor, factor)
    clamped_brightness = clip(enhanced_brightness * adjustment, EPS, 1.0)
    clamped_adjusted = clip(L2d * factor, EPS, 1.0)

    def mse(a, b):  # the loss's means: over the owned rows only, with a region
        return _mse_region(a, b, region, slice_h)

    loss = frame.new_zeros((), dtype=torch.float32)
    # Enhance
    loss = loss + mse(o.s2, clamped_brightness) * 700.0
    loss = loss + mse(normalized_low, clamped_adjusted) * 1000.0
    loss = loss + smooth_loss(L2d, o.s2, region, ycc=ycc) * 5.0
    loss = loss + tv_loss(o.s2, region) * 1600.0
    # Res_1 (Neighbor2Neighbor stage 1)
    L11, L12 = pair_downsampler(inp)
    loss = loss + mse(L11, o.L_pred2) * 1000.0
    loss = loss + mse(L12, o.L_pred1) * 1000.0
    denoised1, denoised2 = pair_downsampler(o.L2)
    loss = loss + mse(o.L_pred1, denoised1) * 1000.0
    loss = loss + mse(o.L_pred2, denoised2) * 1000.0
    # Res_2 (stage 2)
    loss = loss + mse(o.H3_pred, torch.cat([o.H12, o.s22], -1).detach()) * 1000.0
    loss = loss + mse(o.H4_pred, torch.cat([o.H11, o.s21], -1).detach()) * 1000.0
    H3_denoised1, H3_denoised2 = pair_downsampler(o.H3)
    loss = loss + mse(o.H3_pred[..., 0:3], H3_denoised1) * 1000.0
    loss = loss + mse(o.H4_pred[..., 0:3], H3_denoised2) * 1000.0
    # Color
    loss = loss + mse(o.H2_blur.detach(), o.H3_blur) * 10000.0
    # Ill
    loss = loss + mse(o.s2.detach(), o.s3) * 1000.0
    # Inter: the texture-gated local mean
    d = o.H3_denoised1_H3_denoised2_diff
    weighted_diff1 = (1.0 - d) * local_mean(H3_denoised1) + H3_denoised1 * d
    weighted_diff2 = (1.0 - d) * local_mean(H3_denoised2) + H3_denoised1 * d
    loss = loss + mse(H3_denoised1, weighted_diff1) * 10000.0
    loss = loss + mse(H3_denoised2, weighted_diff2) * 10000.0
    # Var
    noise_var = calculate_local_variance(o.H3 - o.H2)
    loss = loss + mse(calculate_local_variance(o.H2), noise_var) * 1000.0
    return loss
