"""The port's native frame pipeline, bound with ctypes.

``frameio.cc`` is the port's copy of the JAX package's C++ frame IO
(``zero_tig_tpu/native/frameio.cc``): libpng and libjpeg decode, a
Catmull-Rom bicubic (OpenCV ``INTER_CUBIC``) or bilinear resize, and an
ordered multi-threaded decode pipeline with float32 [0, 1] or uint8 output.
Port of ``zero_tig_tpu/native/__init__.py`` (:96-204). The library is
built with the host C++ compiler at first use, linked with ``-lpng -ljpeg
-lpthread``, into ``build/zero_tig_torch/host/`` under a name keyed as
``compile_shared`` keys it; a failed build raises with the compiler's message. The
JAX package falls back to OpenCV then; the port has no fallback.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import compile_shared

SOURCE = Path(__file__).resolve().parent / "frameio.cc"
LIBS = ("-lpng", "-ljpeg", "-lpthread")
MODE_BILINEAR = 0
MODE_BICUBIC = 1

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_ubyte)


def build() -> Path:
    return compile_shared(SOURCE, "libzt_frameio", LIBS)


def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            load_args = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.frameio_load.argtypes = load_args + [_F32]
            lib.frameio_load.restype = ctypes.c_int
            lib.frameio_load_u8.argtypes = load_args + [_U8]
            lib.frameio_load_u8.restype = ctypes.c_int
            create_args = [ctypes.POINTER(ctypes.c_char_p)] + [ctypes.c_int] * 6
            for name in ("frameio_pipeline_create", "frameio_pipeline_create_u8"):
                getattr(lib, name).argtypes = create_args
                getattr(lib, name).restype = ctypes.c_void_p
            lib.frameio_pipeline_next.argtypes = [ctypes.c_void_p, _F32]
            lib.frameio_pipeline_next.restype = ctypes.c_int
            lib.frameio_pipeline_next_u8.argtypes = [ctypes.c_void_p, _U8]
            lib.frameio_pipeline_next_u8.restype = ctypes.c_int
            lib.frameio_pipeline_destroy.argtypes = [ctypes.c_void_p]
            lib.frameio_pipeline_destroy.restype = None
            _lib = lib
    return _lib


def _out(height: int, width: int, u8: bool) -> tuple[np.ndarray, ctypes.c_void_p]:
    out = np.empty((height, width, 3), np.uint8 if u8 else np.float32)
    return out, out.ctypes.data_as(_U8 if u8 else _F32)


def load_frame(path: str, width: int, height: int, *, mode: int = MODE_BICUBIC) -> np.ndarray:
    """Decode, resize to (width, height) and normalise one frame: (H, W, 3)
    float32 RGB in [0, 1]."""
    out, ptr = _out(height, width, False)
    if library().frameio_load(str(path).encode(), width, height, mode, ptr):
        raise IOError(f"native decode failed: {path}")
    return out


def load_frame_u8(path: str, width: int, height: int, *, mode: int = MODE_BICUBIC) -> np.ndarray:
    """Decode and resize one frame: (H, W, 3) uint8 RGB; a frame already at
    the target size is the decoded bytes as they are."""
    out, ptr = _out(height, width, True)
    if library().frameio_load_u8(str(path).encode(), width, height, mode, ptr):
        raise IOError(f"native decode failed: {path}")
    return out


class NativePipeline:
    """Frames of a fixed path list, decoded ahead on ``threads`` threads
    into a ring of ``capacity`` slots and yielded in order: (H, W, 3)
    uint8 with ``out_u8``, else float32 in [0, 1]. A frame that fails to
    decode raises IOError where it is due."""

    def __init__(
        self,
        paths: list[str],
        width: int,
        height: int,
        *,
        mode: int = MODE_BICUBIC,
        threads: int = 4,
        capacity: int = 8,
        out_u8: bool = False,
    ):
        self._lib = library()
        self._u8 = bool(out_u8)
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        create = self._lib.frameio_pipeline_create_u8 if out_u8 else self._lib.frameio_pipeline_create
        self._handle = create(arr, len(self._paths), width, height, mode, threads, capacity)
        self.width, self.height = width, height
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= len(self._paths):
            raise StopIteration
        out, ptr = _out(self.height, self.width, self._u8)
        nxt = self._lib.frameio_pipeline_next_u8 if self._u8 else self._lib.frameio_pipeline_next
        rc = nxt(self._handle, ptr)
        self._i += 1
        if rc == 2:
            raise StopIteration
        if rc != 0:
            raise IOError(f"native decode failed: {self._paths[self._i - 1].decode()}")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.frameio_pipeline_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
