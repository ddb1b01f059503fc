"""Flow-training augmentation (host-side numpy).

Port of ``zero_tig_tpu/data/augmentor.py`` (:24-215; reference
utils/augmentor.py): ``FlowAugmentor`` (dense ground truth: photometric
jitter, asymmetric with some probability, an occlusion eraser, random
scale and stretch, flips, a crop) and ``SparseFlowAugmentor`` (KITTI-style
sparse ground truth: the resize forward-splats the valid flow vectors).

The random draws are JAX's: the same ``np.random.default_rng(seed)`` calls
in the same order. The OpenCV calls are replaced:

  * ``cv2.resize(INTER_LINEAR)``: ``F.interpolate`` (bilinear, half-pixel
    centres, no antialiasing); uint8 images are rounded, which lands within
    one level of OpenCV's 11-bit fixed-point weights; float flow is plain
    f32 bilinear;
  * the hue shift's RGB <-> HSV on uint8 (H in [0, 180)): OpenCV's formulas
    in numpy. RGB -> HSV is its integer one (12-bit reciprocal tables);
    HSV -> RGB its f32 one with ``1 - s*x`` fused, which OpenCV's x86 build
    (256-bit vectors) truncates to uint8 in each row's blocks of 32 pixels
    and rounds in the row's last ``W % 32`` (its scalar tail).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.misc import resize_u8

_HSV_SHIFT = 12
_CV_BLOCK = 32  # pixels of a row OpenCV's HSV -> RGB takes per vector step
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])  # b, g, r of tab


def _div_tables() -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _div_tables()


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> uint8 HSV, H in [0, 180): ``cv2.COLOR_RGB2HSV``."""
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 HSV, H in [0, 180) -> uint8 RGB: ``cv2.COLOR_HSV2RGB``."""
    f32, one = np.float32, np.float32(1.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h).astype(np.int64) % 6
    frac = h - np.floor(h)
    # 1 - s*x with one rounding (a fused multiply-add): exact in f64, then rounded
    fused = lambda x: (1.0 - s.astype(np.float64) * x.astype(np.float64)).astype(f32)  # noqa: E731
    tab = np.stack([v, v * (one - s), v * fused(frac), v * fused(one - frac)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    bgr = np.where((hsv[..., 1] == 0)[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255.0)
    w = hsv.shape[-2]
    vector = np.arange(w)[:, None] < (w // _CV_BLOCK) * _CV_BLOCK
    return np.clip(np.where(vector, np.trunc(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)


def _adjust(img: np.ndarray, brightness: float, contrast: float,
            saturation: float, hue: float) -> np.ndarray:
    out = img.astype(np.float32) / 255.0
    out = np.clip(out * brightness, 0, 1)
    mean = out.mean()
    out = np.clip((out - mean) * contrast + mean, 0, 1)
    gray = out @ np.array([0.299, 0.587, 0.114], np.float32)
    out = np.clip((out - gray[..., None]) * saturation + gray[..., None], 0, 1)
    if hue != 0.0:
        hsv = rgb_to_hsv_u8((out * 255).astype(np.uint8))
        hsv[..., 0] = (hsv[..., 0].astype(int) + int(hue * 180)) % 180
        out = hsv_to_rgb_u8(hsv).astype(np.float32) / 255.0
    return (out * 255).astype(np.uint8)


def _resize_flow(flow: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, 2) f32 -> (size[0], size[1], 2), bilinear, half-pixel centres."""
    t = torch.from_numpy(np.ascontiguousarray(flow, np.float32)).permute(2, 0, 1)[None]
    return F.interpolate(t, size=tuple(size), mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()


@dataclass
class FlowAugmentor:
    crop_size: tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    spatial_aug_prob: float = 0.8
    stretch_prob: float = 0.8
    max_stretch: float = 0.2
    asymmetric_color_aug_prob: float = 0.2
    eraser_aug_prob: float = 0.5
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    seed: int | None = None

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    # --- photometric ---
    def color_transform(self, img1, img2):
        def draw():
            return (
                self.rng.uniform(0.6, 1.4),  # brightness
                self.rng.uniform(0.6, 1.4),  # contrast
                self.rng.uniform(0.6, 1.4),  # saturation
                self.rng.uniform(-0.5 / 3.14, 0.5 / 3.14),  # hue
            )

        if self.rng.random() < self.asymmetric_color_aug_prob:
            img1 = _adjust(img1, *draw())
            img2 = _adjust(img2, *draw())
        else:
            params = draw()
            img1 = _adjust(img1, *params)
            img2 = _adjust(img2, *params)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        """Occlusion: random rectangles of img2 -> its mean color."""
        ht, wd = img1.shape[:2]
        if self.rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(self.rng.integers(1, 3)):
                x0 = int(self.rng.integers(0, wd))
                y0 = int(self.rng.integers(0, ht))
                dx = int(self.rng.integers(bounds[0], bounds[1]))
                dy = int(self.rng.integers(bounds[0], bounds[1]))
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    # --- spatial ---
    def spatial_transform(self, img1, img2, flow):
        ht, wd = img1.shape[:2]
        min_scale = max(
            (self.crop_size[0] + 8) / float(ht),
            (self.crop_size[1] + 8) / float(wd),
        )
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if self.rng.random() < self.stretch_prob:
            scale_x *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if self.rng.random() < self.spatial_aug_prob:
            new_hw = (round(ht * scale_y), round(wd * scale_x))
            img1 = resize_u8(img1, new_hw)
            img2 = resize_u8(img2, new_hw)
            flow = _resize_flow(flow, new_hw)
            flow = (flow * np.array([scale_x, scale_y], np.float32)).astype(np.float32)

        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = (flow[:, ::-1] * np.array([-1.0, 1.0], np.float32))
            if self.rng.random() < self.v_flip_prob:
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = (flow[::-1, :] * np.array([1.0, -1.0], np.float32))

        y0 = int(self.rng.integers(0, img1.shape[0] - self.crop_size[0] + 1))
        x0 = int(self.rng.integers(0, img1.shape[1] - self.crop_size[1] + 1))
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow):
        img1, img2 = self.color_transform(img1.copy(), img2.copy())
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow = self.spatial_transform(img1, img2, flow.copy())
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow),
        )


@dataclass
class SparseFlowAugmentor(FlowAugmentor):
    """Sparse-GT variant: valid-aware resize forward-splats flow vectors."""

    do_flip: bool = False
    min_scale: float = -0.2
    max_scale: float = 0.5

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow_f = flow.reshape(-1, 2)
        valid_f = valid.reshape(-1) >= 1

        coords0 = coords[valid_f]
        flow0 = flow_f[valid_f]
        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))
        coords1 = coords0 * np.array([fx, fy], np.float32)
        flow1 = (flow0 * np.array([fx, fy], np.float32)).astype(np.float32)
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx >= 0) & (xx < wd1) & (yy >= 0) & (yy < ht1)
        xx, yy, flow1 = xx[v], yy[v], flow1[v]

        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.int32)
        flow_img[yy, xx] = flow1
        valid_img[yy, xx] = 1
        return flow_img, valid_img

    def spatial_transform_sparse(self, img1, img2, flow, valid):
        ht, wd = img1.shape[:2]
        min_scale = max(
            (self.crop_size[0] + 1) / float(ht),
            (self.crop_size[1] + 1) / float(wd),
        )
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = max(scale, min_scale)
        scale_y = max(scale, min_scale)

        if self.rng.random() < self.spatial_aug_prob:
            new_hw = (round(ht * scale_y), round(wd * scale_x))
            img1 = resize_u8(img1, new_hw)
            img2 = resize_u8(img2, new_hw)
            flow, valid = self.resize_sparse_flow_map(
                flow, valid, fx=scale_x, fy=scale_y
            )

        if self.do_flip and self.rng.random() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = (flow[:, ::-1] * np.array([-1.0, 1.0], np.float32))
            valid = valid[:, ::-1]

        margin_y, margin_x = 20, 50
        y0 = int(self.rng.integers(
            0, max(img1.shape[0] - self.crop_size[0] + margin_y, 1)))
        x0 = int(self.rng.integers(
            0, max(img1.shape[1] - self.crop_size[1] + margin_x, 1)))
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid):
        img1, img2 = self.color_transform(img1.copy(), img2.copy())
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, valid = self.spatial_transform_sparse(
            img1, img2, flow.copy(), valid.copy()
        )
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow),
            np.ascontiguousarray(valid),
        )
