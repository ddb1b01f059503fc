"""Evaluation metrics with the reference's semantics, in numpy.

Port of ``zero_tig_tpu/eval/metrics.py`` (:1-110; reference evals.py:76-103):
  * PSNR: cv2.PSNR on uint8 arrays (10*log10(255^2 / MSE)),
  * SSIM: skimage.metrics.structural_similarity with channel_axis=2,
    data_range=255 on uint8 (win_size=7, uniform filter, sample-covariance
    normalization, border crop), written out here,
  * histogram matching: skimage.exposure.match_histograms with NO
    channel_axis (one joint CDF over all channels, as evals.py:101 calls it),
  * LPIPS (VGG) is ``eval/lpips.py``; it needs converted weights.
They run on the host, per frame.
"""

from __future__ import annotations

import numpy as np


def psnr_uint8(img: np.ndarray, gt: np.ndarray) -> float:
    """cv2.PSNR semantics on uint8 arrays (R=255)."""
    diff = img.astype(np.float64) - gt.astype(np.float64)
    mse = float(np.mean(diff * diff))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)


def _uniform_filter_valid(x: np.ndarray, win: int) -> np.ndarray:
    """Mean filter evaluated where the window fits (valid region), 2-D."""
    c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), axis=0), axis=1)
    s = (
        c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]
    )
    return s / (win * win)


def ssim_uint8(
    img: np.ndarray, gt: np.ndarray, *, win_size: int = 7, data_range: float = 255.0
) -> float:
    """skimage structural_similarity(channel_axis=2, data_range=255).

    skimage crops `pad = (win-1)//2` border pixels from the SSIM map before
    averaging, which makes every remaining window fully interior -- so a
    valid-mode mean filter reproduces it exactly.
    """
    assert img.ndim == 3 and img.shape == gt.shape
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    np_win = win_size * win_size
    cov_norm = np_win / (np_win - 1)  # sample covariance

    vals = []
    for ch in range(img.shape[2]):
        x = img[..., ch].astype(np.float64)
        y = gt[..., ch].astype(np.float64)
        ux = _uniform_filter_valid(x, win_size)
        uy = _uniform_filter_valid(y, win_size)
        uxx = _uniform_filter_valid(x * x, win_size)
        uyy = _uniform_filter_valid(y * y, win_size)
        uxy = _uniform_filter_valid(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1 = 2.0 * ux * uy + c1
        a2 = 2.0 * vxy + c2
        b1 = ux * ux + uy * uy + c1
        b2 = vx + vy + c2
        vals.append(np.mean((a1 * a2) / (b1 * b2)))
    return float(np.mean(vals))


def match_histograms(out: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """skimage.exposure.match_histograms WITHOUT channel_axis: one joint
    cumulative distribution over every value in the array (evals.py:100-103).
    """
    src_values, src_inverse, src_counts = np.unique(
        out.ravel(), return_inverse=True, return_counts=True
    )
    tmpl_values, tmpl_counts = np.unique(gt.ravel(), return_counts=True)
    src_quantiles = np.cumsum(src_counts) / out.size
    tmpl_quantiles = np.cumsum(tmpl_counts) / gt.size
    interp = np.interp(src_quantiles, tmpl_quantiles, tmpl_values)
    return interp[src_inverse].reshape(out.shape).astype(out.dtype, copy=False)


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """The reference's float->uint8 for metrics: np.round(x*255) (evals.py:83)."""
    return np.round(np.clip(img01, 0.0, 1.0) * 255.0).astype(np.uint8)


def frame_metrics(
    out01: np.ndarray, gt01: np.ndarray, lpips_fn=None
) -> dict[str, float | None]:
    """PSNR/SSIM(/LPIPS) for one frame pair in [0, 1] float."""
    img = to_uint8(out01)
    gt = to_uint8(gt01)
    res: dict[str, float | None] = {
        "psnr": psnr_uint8(img, gt),
        "ssim": ssim_uint8(img, gt),
        "lpips": None,
    }
    if lpips_fn is not None:
        res["lpips"] = float(lpips_fn(out01, gt01))
    return res
