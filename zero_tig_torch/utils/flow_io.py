"""Optical-flow file IO: Middlebury ``.flo``, PFM, KITTI 16-bit PNG, and
``read_gen``'s dispatch by extension.

Port of ``zero_tig_tpu/utils/flow_io.py`` (:19-107; reference
utils/frame_utils.py:12-137). The JAX file reads and writes KITTI PNGs and
decodes images with OpenCV; here the port's codec (``native``) does both:
16-bit RGB for KITTI flow, 8-bit PNG and binary PPM for frames, Pillow
(imported on use, and an ImportError where it is absent) for JPEG and BMP.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .. import native

TAG_CHAR = np.float32(202021.25)


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != TAG_CHAR:
            raise ValueError(f"Invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_CHAR], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("Malformed PFM header.")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape))


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("Image must be HxWx3, HxWx1 or HxW.")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(b"%f\n" % scale)
        np.flipud(image).tofile(f)


def read_flow_kitti(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit PNG: flow = (uint16 - 2^15) / 64 from R and G, valid = B."""
    with open(path, "rb") as f:
        raw = native.decode_png16(f.read()).astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    flow = 64.0 * np.asarray(flow, np.float64) + 2**15
    valid = np.ones((flow.shape[0], flow.shape[1], 1), flow.dtype)
    out = np.concatenate([flow, valid], axis=-1).astype(np.uint16)
    with open(path, "wb") as f:
        f.write(native.encode_png16(out))


def read_gen(path: str):
    """Read by extension (reference frame_utils.py:119-137): images as
    (H, W, 3) uint8 RGB, ``.bin``/``.raw`` with ``np.load``, ``.flo`` and
    ``.pfm`` flow (a 3-channel PFM loses its last channel)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg", ".bmp"):
        return native.read_rgb(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    raise ValueError(f"unsupported extension: {ext}")
