"""Window and filter ops of the training forward and loss, on NHWC tensors.

Port of ``zero_tig_tpu/ops/filters.py`` (reference utils/utils.py and
loss.py). The padding modes are the reference's and differ on purpose:
**reflect** for the blur and the texture statistics (``local_mean``,
``local_stddev``), **zero** for ``calculate_local_variance``. Windows are
depthwise convolutions and average pools on an NCHW view of the NHWC
tensor, so on the card they run as library kernels in channels_last memory.
The TPU's W-minor twins of these filters are a layout and are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pair_downsampler(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbor2Neighbor diagonal pairs (utils/utils.py:15-24): (B, H, W, C)
    -> two (B, H//2, W//2, C), ((2i, 2j+1) + (2i+1, 2j)) / 2 and
    ((2i, 2j) + (2i+1, 2j+1)) / 2; an odd last row or column is dropped."""
    h2, w2 = img.shape[1] // 2, img.shape[2] // 2
    a = img[:, 0:2 * h2:2, 0:2 * w2:2]
    b = img[:, 0:2 * h2:2, 1:2 * w2:2]
    c = img[:, 1:2 * h2:2, 0:2 * w2:2]
    d = img[:, 1:2 * h2:2, 1:2 * w2:2]
    return 0.5 * (b + c), 0.5 * (a + d)


def gauss_kernel(kernlen: int = 21, nsig: float = 3.0) -> np.ndarray:
    """The reference's erf Gaussian (utils/utils.py:29-39), float32 numpy:
    sqrt(outer(k1d, k1d)) normalised, k1d the erf differences over a
    float32 linspace. ``blur`` uses nsig=1."""
    from scipy.special import erf

    interval = (2 * nsig + 1.0) / kernlen
    x = np.linspace(-nsig - interval / 2.0, nsig + interval / 2.0, kernlen + 1, dtype=np.float32)
    kern1d = np.diff(0.5 * (1.0 + erf(x / math.sqrt(2.0))))
    kernel_raw = np.sqrt(np.outer(kern1d, kern1d))
    return (kernel_raw / kernel_raw.sum()).astype(np.float32)


_SQRT_TAPS: np.ndarray | None = None


def _sqrt_taps() -> np.ndarray:
    """The separable factor s of the 21x21 nsig=1 kernel: outer(s, s) == k."""
    global _SQRT_TAPS
    if _SQRT_TAPS is None:
        k2d = gauss_kernel(21, 1.0).astype(np.float64)
        row = k2d[10]
        _SQRT_TAPS = (row / np.sqrt(row[10])).astype(np.float32)
    return _SQRT_TAPS


def _depthwise(x: torch.Tensor, taps: torch.Tensor, vertical: bool) -> torch.Tensor:
    """Valid depthwise 1-D window along H (vertical) or W of an NCHW tensor."""
    c = x.shape[1]
    shape = (c, 1, taps.numel(), 1) if vertical else (c, 1, 1, taps.numel())
    return F.conv2d(x, taps.reshape(shape[1:]).expand(shape), groups=c)


def blur(x: torch.Tensor) -> torch.Tensor:
    """21x21 Gaussian blur, nsig=1, reflect padding 10 (utils/utils.py:52-58),
    as two separable 21-tap passes, H then W, like the JAX package."""
    s = torch.as_tensor(_sqrt_taps(), dtype=x.dtype, device=x.device)
    xp = F.pad(_nchw(x), (10, 10, 10, 10), mode="reflect")
    return _nhwc(_depthwise(_depthwise(xp, s, True), s, False))


def _box_mean(x_nchw: torch.Tensor, k: int, padding: int = 0) -> torch.Tensor:
    """k x k window mean; zero padding counted in the divisor."""
    return F.avg_pool2d(x_nchw, k, stride=1, padding=padding, count_include_pad=True)


def local_mean(x: torch.Tensor, patch_size: int = 5) -> torch.Tensor:
    """5x5 window mean with reflect padding (utils/utils.py:41-50)."""
    p = patch_size // 2
    return _nhwc(_box_mean(F.pad(_nchw(x), (p, p, p, p), mode="reflect"), patch_size))


def local_stddev(x: torch.Tensor, patch_size: int = 5, eps: float = 1e-9) -> torch.Tensor:
    """Window stddev with reflect padding (loss.py:123-131):
    sqrt(max(E[x^2] - E[x]^2, 0) + eps) over the same window."""
    p = patch_size // 2
    xp = F.pad(_nchw(x), (p, p, p, p), mode="reflect")
    m = _box_mean(xp, patch_size)
    ex2 = _box_mean(xp * xp, patch_size)
    return _nhwc(torch.sqrt(torch.clamp(ex2 - m * m, min=0.0) + eps))


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """torch ``nn.AvgPool2d`` (count_include_pad=True) on NHWC."""
    return _nhwc(F.avg_pool2d(_nchw(x), kernel, stride, padding, count_include_pad=True))


def calculate_local_variance(x: torch.Tensor) -> torch.Tensor:
    """Local variance against the 5x5 average-pool mean, ZERO padding
    (utils/utils.py:66-79): the zero-padded 5x5 mean of (x - avg)^2."""
    xc = _nchw(x)
    d2 = (xc - _box_mean(xc, 5, padding=2)) ** 2
    return _nhwc(_box_mean(d2, 5, padding=2))


def texture_difference(
    img1: torch.Tensor,
    img2: torch.Tensor,
    *,
    patch_size: int = 5,
    constant_c: float = 1e-5,
    threshold: float = 0.975,
) -> torch.Tensor:
    """Binary texture-similarity mask (loss.py:99-136): (B, H, W, 3) ->
    (B, H, W, 1) in {0, 1}, without gradient (a step function). The grey
    level keeps the reference's 0.144/0.587/0.299 on channels 0/1/2."""

    def gray(im):
        return 0.144 * im[..., 0:1] + 0.5870 * im[..., 1:2] + 0.299 * im[..., 2:3]

    with torch.no_grad():
        s1 = local_stddev(gray(img1), patch_size)
        s2 = local_stddev(gray(img2), patch_size)
        diff = (2.0 * s1 * s2) / (s1 * s1 + s2 * s2 + constant_c)
        return (diff > threshold).to(img1.dtype)
