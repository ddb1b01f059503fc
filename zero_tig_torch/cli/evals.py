"""Inference + metric scoring CLI: ``python -m zero_tig_torch.cli.evals``.

Port of ``zero_tig_tpu/cli/evals.py`` (:1-145; reference evals.py). Per
frame: PSNR / SSIM (/LPIPS when weights are given), the histogram-matched
``_HM`` variants, image dumps of the first 20 frames, and Metrics.json with
the six aggregates (evals.py:184-192); LPIPS is null when not measured.
Ground truth decodes through the port's PNG codec; a ground truth of
another size is resized with ``F.interpolate(mode="bicubic")`` on f32, which
is OpenCV's ``INTER_CUBIC`` on float input (a = -0.75, edges replicated, no
antialiasing).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..core.config import Config, add_config_args, config_from_args
from ..core.device import resolve_device
from ..data import create_dataset, device_prefetch, gt_path_for
from ..eval import LPIPSScorer, frame_metrics, match_histograms, to_uint8
from ..models import build_model
from ..pipeline.steps import init_carry, predict_step
from .common import load_state_dict, setup_logging, write_png


def resize_cubic(img01: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W, 3) float32 -> (hw[0], hw[1], 3): cv2.resize(INTER_CUBIC) on floats."""
    t = torch.from_numpy(np.ascontiguousarray(img01, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(hw), mode="bicubic", align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


def run_evals(
    config: Config,
    *,
    lpips_weights: str | None = None,
    device=None,
) -> dict:
    """Score every test frame of ``config``'s dataset against its ground
    truth; returns the Metrics.json dict. ``device`` None means the card
    (and raises without one)."""
    device = resolve_device(device)
    setup_logging(config.save)
    log = logging.getLogger()
    log.info("Model path = %s", str(config.model_pretrain))

    model = build_model(load_state_dict(config), device=device, precision=config.precision)
    lpips_fn = LPIPSScorer.maybe_load(lpips_weights, device)
    if lpips_fn is None:
        log.warning("LPIPS weights unavailable: LPIPS reported as null")

    size = (config.frame_width, config.frame_height)
    test_ds = create_dataset(config.dataset, config.lowlight_images_path, "test", size=size)
    print("Total image number: ", str(len(test_ds)))

    totals = {k: 0.0 for k in ("psnr", "ssim", "lpips", "psnr_hm", "ssim_hm", "lpips_hm")}
    num_img = 0
    carry = None
    for i, rec in enumerate(device_prefetch(test_ds.iter_u8(), depth=config.prefetch_depth, device=device)):
        if carry is None:
            carry = init_carry(model, tuple(rec.image.shape))
        (H2, H3, _s3), carry = predict_step(
            model, rec.image, carry, rec.is_new_seq,
            of_scale=config.of_scale, raft_iters=config.raft_iters, enh_scale=config.enh_scale,
        )
        gt_path = gt_path_for(rec.path)
        if not os.path.exists(gt_path):
            log.warning("missing GT for %s -> skipped", rec.path)
            continue
        gt01 = native.read_rgb(gt_path).astype(np.float32) / 255.0
        out01 = H3[0].cpu().numpy()
        if gt01.shape != out01.shape:
            gt01 = resize_cubic(gt01, out01.shape[:2])

        m = frame_metrics(out01, gt01, lpips_fn)
        num_img += 1
        for k in ("psnr", "ssim", "lpips"):
            if m[k] is not None:
                totals[k] += m[k]
        print(
            f"NUM: {num_img}, PSNR: {m['psnr']:.3f}, SSIM: {m['ssim']:.3f}, "
            f"LPIPS: {m['lpips'] if m['lpips'] is not None else float('nan'):.3f}"
        )

        hm01 = match_histograms(out01, gt01)
        mh = frame_metrics(hm01, gt01, lpips_fn)
        for k in ("psnr", "ssim", "lpips"):
            if mh[k] is not None:
                totals[k + "_hm"] += mh[k]
        print(f"NUM: {num_img}, PSNR_HM: {mh['psnr']:.3f}, SSIM_HM: {mh['ssim']:.3f}")

        if i < 20:
            splits = rec.path.split(os.sep)
            save_dir = os.path.join(config.save, splits[-3], splits[-2])
            os.makedirs(save_dir, exist_ok=True)
            write_png(os.path.join(save_dir, rec.name + "_denoise.png"), out01)
            write_png(os.path.join(save_dir, rec.name + "_enhance.png"), H2[0])
            native.write_png(os.path.join(save_dir, rec.name + "_denoise_hm.png"), to_uint8(hm01))

    n = max(num_img, 1)
    # LPIPS is null, not 0.0, when never measured: "perfect" and "not
    # measured" must stay apart for whoever reads the file
    measured_lpips = lpips_fn is not None and num_img > 0
    metrics = {
        "Total_PSNR": totals["psnr"] / n,
        "Total_SSIM": totals["ssim"] / n,
        "Total_LPIPS": totals["lpips"] / n if measured_lpips else None,
        "Total_PSNR_HM": totals["psnr_hm"] / n,
        "Total_SSIM_HM": totals["ssim_hm"] / n,
        "Total_LPIPS_HM": totals["lpips_hm"] / n if measured_lpips else None,
    }
    with open(os.path.join(config.save, "Metrics.json"), "w") as f:
        json.dump(metrics, f)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser("ZERO-IG")
    add_config_args(parser)
    parser.add_argument("--lpips_weights", type=str, default=None)
    args = parser.parse_args(argv)
    run_evals(config_from_args(args), lpips_weights=args.lpips_weights)


if __name__ == "__main__":
    main()
