"""Evaluation metrics: PSNR, SSIM, histogram matching, LPIPS, and the VMAF hook."""

from .lpips import LPIPSScorer, lpips_distance
from .metrics import frame_metrics, match_histograms, psnr_uint8, ssim_uint8, to_uint8
from .vmaf import score_sequences, vmaf_available

__all__ = [
    "LPIPSScorer",
    "frame_metrics",
    "lpips_distance",
    "match_histograms",
    "psnr_uint8",
    "score_sequences",
    "ssim_uint8",
    "to_uint8",
    "vmaf_available",
]
