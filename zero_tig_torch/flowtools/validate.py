"""Flow validation: EPE, Fl-all, px1 and WAUC over consecutive frame pairs
with per-pair CSVs, and single-pair inference with an optional ground truth.

Port of ``zero_tig_tpu/flowtools/validate.py`` (:27-117; reference
ptlflow_scripts/validate.py and infer.py). Frames are read with the port's
codec and resized with ``F.interpolate`` (bilinear, half-pixel centres, no
antialiasing, rounded to uint8) where JAX uses OpenCV. The JAX quirk is
kept: RAFT's flow is at the /8-padded size, so against a ground truth of
another size the flow is resized to it and scaled by the size ratio.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np
import torch

from .. import native
from ..core.device import resolve_device
from ..ops.resize import resize_bilinear
from ..utils.flow_io import read_gen, write_flo
from ..utils.flow_viz import flow_to_image
from ..utils.misc import resize_u8
from .metrics import flow_metrics
from .registry import get_flow_model


def _load_image(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """An image as (H, W, 3) f32 in [0, 255]; ``size`` = (W, H), OpenCV's order."""
    img = native.read_rgb(path)
    if size is not None:
        img = resize_u8(img, (size[1], size[0]))
    return img.astype(np.float32)


def infer_pair(
    model_name: str,
    model: torch.nn.Module,
    img1_path: str,
    img2_path: str,
    *,
    iters: int | None = None,
    size: tuple[int, int] | None = None,
    gt_flow_path: str | None = None,
    save_dir: str | None = None,
    device: str | torch.device | None = None,
    precision: str = "highest",
) -> dict:
    """Flow for one frame pair on ``device`` (the card unless the CPU is
    named; the model must be there); optionally scored against a ground
    truth and saved as ``.flo`` and a ``_viz.png``."""
    device = resolve_device(device)
    fm = get_flow_model(model_name)
    iters = iters or fm.default_iters
    i1 = torch.from_numpy(_load_image(img1_path, size)[None]).to(device)
    i2 = torch.from_numpy(_load_image(img2_path, size)[None]).to(device)
    _, flow_up = fm.forward_fn(model, i1, i2, iters, precision)

    result: dict = {"img1": img1_path, "img2": img2_path}
    if gt_flow_path:
        gt = read_gen(gt_flow_path)
        if gt.shape[:2] != tuple(flow_up.shape[1:3]):
            sx = gt.shape[1] / flow_up.shape[2]
            sy = gt.shape[0] / flow_up.shape[1]
            flow_r = resize_bilinear(flow_up, gt.shape[:2]) * torch.tensor([sx, sy], device=device)
        else:
            flow_r = flow_up
        result.update(flow_metrics(flow_r[0].cpu().numpy(), np.asarray(gt)))

    if save_dir:
        flow = flow_up[0].cpu().numpy()
        os.makedirs(save_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(img2_path))[0]
        write_flo(os.path.join(save_dir, f"{stem}.flo"), flow)
        native.write_png(os.path.join(save_dir, f"{stem}_viz.png"), flow_to_image(flow))
    return result


def validate_folder(
    model_name: str,
    model: torch.nn.Module,
    image_dir: str,
    flow_dir: str,
    *,
    image_ext: str = "png",
    flow_ext: str = "flo",
    iters: int | None = None,
    csv_path: str | None = None,
    device: str | torch.device | None = None,
    precision: str = "highest",
) -> dict:
    """Validate consecutive pairs in ``image_dir`` against ground-truth flows
    named by the FIRST frame's stem in ``flow_dir``; the mean of each
    metric over the pairs, and ``num_pairs``."""
    frames = sorted(glob.glob(os.path.join(image_dir, f"*.{image_ext}")))
    rows = []
    for f1, f2 in zip(frames[:-1], frames[1:]):
        stem = os.path.splitext(os.path.basename(f1))[0]
        gt_path = os.path.join(flow_dir, f"{stem}.{flow_ext}")
        if not os.path.exists(gt_path):
            continue
        r = infer_pair(model_name, model, f1, f2, iters=iters, gt_flow_path=gt_path,
                       device=device, precision=precision)
        r["name"] = stem
        rows.append(r)
    if csv_path and rows:
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=sorted(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    if not rows:
        return {}
    agg = {
        k: float(np.mean([r[k] for r in rows]))
        for k in ("epe", "fl_all", "px1", "wauc")
        if all(k in r for r in rows)
    }
    agg["num_pairs"] = len(rows)
    return agg
