"""Evaluation metrics: PSNR, SSIM, histogram matching and LPIPS."""

from .lpips import LPIPSScorer, lpips_distance
from .metrics import frame_metrics, match_histograms, psnr_uint8, ssim_uint8, to_uint8

__all__ = [
    "LPIPSScorer",
    "frame_metrics",
    "lpips_distance",
    "match_histograms",
    "psnr_uint8",
    "ssim_uint8",
    "to_uint8",
]
