"""Benchmark-format flow submissions: Middlebury ``.flo`` per frame for
MPI-Sintel, 16-bit KITTI PNGs for KITTI 2012/2015.

Port of ``zero_tig_tpu/flowtools/submit.py`` (:22-86; reference
ptlflow_scripts/test.py:240-295). Frames are read and flows written with
the port's codec; the flow is written at the size the model gives (the
padded size, for RAFT), as JAX writes it.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .. import native
from ..core.device import resolve_device
from ..utils.flow_io import write_flo, write_flow_kitti
from .registry import get_flow_model


def _flow_fn(model_name: str, model, iters: int | None, device, precision: str):
    fm = get_flow_model(model_name)
    iters = iters or fm.default_iters
    device = resolve_device(device)

    def flow(f1: str, f2: str) -> np.ndarray:
        i1 = torch.from_numpy(native.read_rgb(f1).astype(np.float32)[None]).to(device)
        i2 = torch.from_numpy(native.read_rgb(f2).astype(np.float32)[None]).to(device)
        return fm.forward_fn(model, i1, i2, iters, precision)[1][0].cpu().numpy()

    return flow


def write_sintel_submission(
    model_name: str,
    model: torch.nn.Module,
    frames_root: str,
    out_root: str,
    *,
    iters: int | None = None,
    device: str | torch.device | None = None,
    precision: str = "highest",
) -> int:
    """frames_root/<scene>/frame_NNNN.png -> out_root/<scene>/frame_NNNN.flo.
    Returns the number of flow files written."""
    flow = _flow_fn(model_name, model, iters, device, precision)
    count = 0
    for scene in sorted(os.listdir(frames_root)):
        sdir = os.path.join(frames_root, scene)
        if not os.path.isdir(sdir):
            continue
        frames = sorted(glob.glob(os.path.join(sdir, "*.png")))
        odir = os.path.join(out_root, scene)
        os.makedirs(odir, exist_ok=True)
        for f1, f2 in zip(frames[:-1], frames[1:]):
            stem = os.path.splitext(os.path.basename(f1))[0]
            write_flo(os.path.join(odir, f"{stem}.flo"), flow(f1, f2))
            count += 1
    return count


def write_kitti_submission(
    model_name: str,
    model: torch.nn.Module,
    image2_dir: str,
    out_dir: str,
    *,
    iters: int | None = None,
    device: str | torch.device | None = None,
    precision: str = "highest",
) -> int:
    """KITTI layout: image_2/NNNNNN_10.png + _11.png pairs ->
    out_dir/NNNNNN_10.png 16-bit flow. Returns pairs written."""
    flow = _flow_fn(model_name, model, iters, device, precision)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for f1 in sorted(glob.glob(os.path.join(image2_dir, "*_10.png"))):
        f2 = f1.replace("_10.png", "_11.png")
        if not os.path.exists(f2):
            continue
        write_flow_kitti(os.path.join(out_dir, os.path.basename(f1)), flow(f1, f2))
        count += 1
    return count
