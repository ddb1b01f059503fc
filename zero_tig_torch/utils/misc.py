"""Utility helpers: parameter counts, checkpoint copies, drop_path, the
experiment directory, contact sheets, forward interpolation of flow and a
flow overlay.

Port of ``zero_tig_tpu/utils/misc.py`` (:17-128; reference utils/utils.py).
Images are written with the port's PNG codec and resized with
``F.interpolate`` where the JAX file uses OpenCV; ``drop_path`` draws from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import native
from .flow_viz import flow_to_image


def count_parameters_in_mb(tree: nn.Module | dict, *, exclude_substr: str = "auxiliary") -> float:
    """Millions of parameters (the reference divides by 1e6 and calls it MB,
    utils/utils.py:81-82), skipping names that contain ``exclude_substr``.
    Over a module each parameter counts once, a shared one too (the
    Enhancer's block is one module under four names); over a state dict
    every entry counts, as every leaf of a JAX tree does."""
    if isinstance(tree, nn.Module):
        named = tree.named_parameters()
    else:
        named = tree.items()
    return sum(t.numel() for name, t in named if not (exclude_substr and exclude_substr in name)) / 1e6


def save_checkpoint(state_bytes: bytes, is_best: bool, save_dir: str) -> str:
    """Write ``save_dir/checkpoint.pt`` and, when ``is_best``, a copy as
    ``model_best.pt`` (utils/utils.py:86-91)."""
    os.makedirs(save_dir, exist_ok=True)
    filename = os.path.join(save_dir, "checkpoint.pt")
    with open(filename, "wb") as f:
        f.write(state_bytes)
    if is_best:
        shutil.copyfile(filename, os.path.join(save_dir, "model_best.pt"))
    return filename


def drop_path(x: torch.Tensor, drop_prob: float, generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth over the batch dim (utils/utils.py:101-107): each
    sample is kept with probability 1 - drop_prob and scaled by its inverse;
    the draws come from ``generator`` (on x's device)."""
    if drop_prob <= 0.0:
        return x
    keep = 1.0 - drop_prob
    probs = torch.full((x.shape[0],) + (1,) * (x.dim() - 1), keep, device=x.device)
    return x / keep * torch.bernoulli(probs, generator=generator).to(x.dtype)


def create_exp_dir(path: str, scripts_to_save: list[str] | None = None) -> str:
    """Experiment dir + script snapshot (utils/utils.py:109-118)."""
    os.makedirs(path, exist_ok=True)
    print(f"Experiment dir : {path}")
    if scripts_to_save:
        sdir = os.path.join(path, "scripts")
        os.makedirs(sdir, exist_ok=True)
        for script in scripts_to_save:
            shutil.copyfile(script, os.path.join(sdir, os.path.basename(script)))
    return path


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def resize_u8(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (size[0], size[1], C) uint8: bilinear, half-pixel
    centres, no antialiasing, rounded (OpenCV's INTER_LINEAR, which weighs
    in 11-bit fixed point, lands within one level of it)."""
    t = torch.from_numpy(np.ascontiguousarray(img)).float().permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(size), mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def show_pic(pics, names, path: str, *, grid=(5, 6)) -> None:
    """Contact sheet of (B, H, W, C) images in [0, 1] -> one PNG
    (utils/utils.py:120-142; the names are not drawn, as in the JAX port)."""
    del names
    tiles = []
    for img in pics:
        arr = _numpy(img)
        if arr.ndim == 4:
            arr = arr[0]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        tiles.append(np.clip(arr * 255.0, 0, 255).astype(np.uint8))
    if not tiles:
        return
    h = max(t.shape[0] for t in tiles)
    w = max(t.shape[1] for t in tiles)
    rows, cols = grid
    sheet = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, t in enumerate(tiles[: rows * cols]):
        r, c = divmod(i, cols)
        sheet[r * h : r * h + t.shape[0], c * w : c * w + t.shape[1]] = t
    native.write_png(path, sheet)


def forward_interpolate(flow) -> np.ndarray:
    """Forward-splat a (2, H, W) flow onto the regular grid (RAFT's warm
    start; utils/utils.py:254-282): scipy's nearest-neighbour ``griddata``
    over the points the flow moves inside the frame -> (2, H, W) f32."""
    from scipy import interpolate as sp_interpolate

    flow = _numpy(flow)
    dx, dy = flow[0], flow[1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    if not np.any(valid):
        return np.zeros_like(np.asarray(flow, np.float32))
    flow_x = sp_interpolate.griddata(
        (x1[valid], y1[valid]), dxf[valid], (x0, y0), method="nearest", fill_value=0,
    )
    flow_y = sp_interpolate.griddata(
        (x1[valid], y1[valid]), dyf[valid], (x0, y0), method="nearest", fill_value=0,
    )
    return np.stack([flow_x, flow_y], axis=0).astype(np.float32)


def viz_flow_overlay(img, flow, path: str) -> None:
    """The first frame of (B, H, W, 3) ``img`` in [0, 1] above the colour
    wheel image of the first (B, h, w, 2) ``flow``, resized to the frame,
    as one PNG (utils/utils.py:163-176, saved instead of shown)."""
    im = np.clip(_numpy(img)[0] * 255.0, 0, 255).astype(np.uint8)
    flo = flow_to_image(_numpy(flow)[0])
    if flo.shape[:2] != im.shape[:2]:
        flo = resize_u8(flo, im.shape[:2])
    native.write_png(path, np.concatenate([im, flo], axis=0))
