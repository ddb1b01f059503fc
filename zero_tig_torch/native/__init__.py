"""The port's host image IO: its own PNG codec, and Pillow for the rest.

The JAX package decodes, resizes and writes frames with OpenCV and Pillow
(``zero_tig_tpu/data/datasets.py:108-136``, ``cli/common.py:139-142``) and
keeps its C++ frame pipeline in ``zero_tig_tpu/native/frameio.cc``
(libpng/libjpeg). The machine with the card has neither OpenCV nor Pillow,
so PNG, the format of every frame the reference datasets hold, has one path
here on every machine:

  * decode: the chunks are parsed here, Python's ``zlib`` inflates the IDAT
    stream, and ``pngio.cpp`` (``zt_png_unfilter``) undoes the row filters.
    8-bit gray, RGB and RGBA, non-interlaced; anything else raises. Frames
    come back as (H, W, 3) uint8 RGB (gray repeated, alpha dropped: what
    Pillow's ``convert("RGB")`` and OpenCV's ``IMREAD_COLOR`` give);
  * encode: 8-bit RGB, filter Up on every row (one numpy subtraction), then
    ``zlib`` level 1 with the run-length strategy, OpenCV's default PNG
    strategy. The bytes differ from OpenCV's; the decoded pixels are equal.

``pngio.cpp`` is compiled with the host C++ compiler at first use into
``build/zero_tig_torch/host/`` under a name keyed by a hash of the source
and flags; a failed build raises. JPEG frames and resizing a frame that is
not at the target size go through Pillow, imported when one is needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "pngio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zero_tig_torch" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for 8-bit images: gray, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}
WRITE_LEVEL = 1  # zlib level of written PNGs: the CLIs write 1080p frames on their path
WRITE_STRATEGY = zlib.Z_RLE  # OpenCV's default PNG strategy: twice as fast as the default one

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``pngio.cpp`` into a shared library (once per source hash)."""
    target = BUILD_DIR / f"libzt_pngio-{_digest()}.so"
    if target.exists():
        return target
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the port's PNG codec cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / target.name
        res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(out)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stdout}{res.stderr}")
        os.replace(out, target)  # atomic: a reader never sees half a file
    return target


def library() -> ctypes.CDLL:
    """The loaded codec library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.zt_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64]
            lib.zt_png_unfilter.restype = ctypes.c_int64
            _lib = lib
    return _lib


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with the file's C channels (1, 3 or 4)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, color, _compression, _filter, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, color type {color}, interlace {interlace} "
            "(8-bit gray, RGB or RGBA, non-interlaced only)"
        )
    ch = _CHANNELS[color]
    rowbytes = width * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, {height * (rowbytes + 1)} expected")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, width, ch), np.uint8)
    bad = library().zt_png_unfilter(src.ctypes.data, out.ctypes.data, height, rowbytes, ch)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 1|3|4) -> (H, W, 3): gray repeated, alpha dropped."""
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (filter Up, zlib level 1, run-length strategy)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, not {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    flat = rgb.reshape(h, 3 * w)
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 2  # Up: each byte minus the one above it, mod 256
    rows[0, 1:] = flat[0]
    np.subtract(flat[1:], flat[:-1], out=rows[1:, 1:])
    z = zlib.compressobj(WRITE_LEVEL, zlib.DEFLATED, 15, zlib.DEF_MEM_LEVEL, WRITE_STRATEGY)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", z.compress(rows.tobytes()) + z.flush()) + chunk(b"IEND", b""))


def write_png(path: str | os.PathLike, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "Pillow is needed to read a JPEG frame or to resize a frame that is not at the target "
            "size; PNG frames at the target size need nothing beyond the port"
        ) from e
    return Image


def read_rgb(path: str | os.PathLike) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB: PNG through the port's codec,
    any other format through Pillow."""
    if str(path).lower().endswith(".png"):
        with open(path, "rb") as f:
            return to_rgb(decode_png(f.read()))
    Image = _pillow()
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def resize_bicubic_pil(rgb: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Pillow's antialiased bicubic resize to ``size`` = (W, H), the
    reference's (multi_read_data.py:127-132)."""
    Image = _pillow()
    return np.asarray(Image.fromarray(rgb).resize(size, Image.Resampling.BICUBIC), np.uint8)
