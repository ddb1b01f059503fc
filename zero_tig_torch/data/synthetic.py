"""Synthetic mini-dataset fixture: 2 scenes x N frames in BVI-RLV layout.

Port of ``zero_tig_tpu/data/synthetic.py`` (:17-86): the same frames from
the same seed, written through the port's PNG codec. Frames are dim, noisy,
slowly translating gradients, enough signal for the flow, warp and enhance
paths to do real work. The occluder's ``cv2.GaussianBlur((3, 3), 0)`` is
its separable [1/4, 1/2, 1/4] kernel (OpenCV's table for a 3-tap kernel
with sigma 0) under OpenCV's default border, BORDER_REFLECT_101, in numpy.
"""

from __future__ import annotations

import os

import numpy as np

from ..native import write_png


def _blur3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) on (H, W, C) float32: rows, then columns."""
    k = np.float32([0.25, 0.5, 0.25])
    p = np.pad(img, ((0, 0), (1, 1), (0, 0)), mode="reflect")  # numpy's reflect is REFLECT_101
    rows = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
    p = np.pad(rows, ((1, 1), (0, 0), (0, 0)), mode="reflect")
    return (k[0] * p[:-2] + k[1] * p[1:-1] + k[2] * p[2:]).astype(np.float32)


def make_rlv_fixture(
    root: str,
    *,
    scenes: tuple[str, ...] = ("S01", "S02"),
    frames_per_scene: int = 3,
    size: tuple[int, int] = (64, 48),  # (W, H)
    brightness: float = 0.15,
    seed: int = 2,
    occluder: bool = False,
) -> str:
    """Write a tiny BVI-RLV-layout dataset under `root`; returns `root`.

    Layout: input/<scene>/low_light_10/NNN.png + gt/<scene>/normal_light_10/
    plus train_list.txt / test_list.txt listing all scenes.

    occluder=True overlays a textured square patch translating 5 px/frame
    over the slowly panning background, creating real flow discontinuities
    (>2 px across a 2x2 block at the patch boundary). This is the content
    that stresses the fast-mode block-gather warp's clamping bound
    (ops/sampling.grid_sample_pixel_block) -- the smooth pan alone never
    leaves its exact regime.
    """
    rng = np.random.default_rng(seed)
    w, h = size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    occ_h, occ_w = max(h // 4, 8), max(w // 4, 8)
    # dedicated rng: the base fixture must be bit-identical with and
    # without the occluder overlay
    occ_tex = (
        np.random.default_rng(seed + 101)
        .uniform(0.2, 1.0, (occ_h, occ_w, 3))
        .astype(np.float32)
    )
    occ_tex = _blur3(occ_tex)

    for scene_i, scene in enumerate(scenes):
        base_phase = rng.uniform(0, 2 * np.pi)
        for f in range(frames_per_scene):
            shift = 1.5 * f  # slow horizontal pan
            clean = np.stack(
                [
                    0.5 + 0.5 * np.sin(0.15 * (xs - shift) + base_phase),
                    0.5 + 0.5 * np.cos(0.11 * (ys + 0.3 * shift) + base_phase),
                    0.5 + 0.5 * np.sin(0.09 * (xs + ys) + scene_i),
                ],
                axis=-1,
            )
            if occluder:
                # textured patch moving 5 px/frame diagonally (wrapping),
                # independent of the background motion
                oy = int(h * 0.2 + 5 * f) % max(h - occ_h, 1)
                ox = int(w * 0.3 + 5 * f) % max(w - occ_w, 1)
                clean[oy : oy + occ_h, ox : ox + occ_w, :] = occ_tex
            low = clean * brightness + rng.normal(0, 0.01, clean.shape)
            low = np.clip(low, 0, 1)

            for kind, img in (("low_light_10", low), ("normal_light_10", clean)):
                sub = "input" if kind.startswith("low") else "gt"
                d = os.path.join(root, sub, scene, kind)
                os.makedirs(d, exist_ok=True)
                u8 = (img * 255).astype(np.uint8)
                write_png(os.path.join(d, f"{f:05d}.png"), u8)

    for lst in ("train_list.txt", "test_list.txt"):
        with open(os.path.join(root, lst), "w") as fh:
            fh.write("\n".join(scenes) + "\n")
    return root
