"""Build and load the port's CUDA kernels (``zero_tig_torch/csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects link into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``build/zero_tig_torch/`` at the repository root under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once. Nothing is built when this module is imported: the first
call of ``library()`` builds, on a machine with ``nvcc`` and a card.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zero_tig_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point: pointers and the stream as c_void_p so no
# 64-bit address is cut to 32 bits
SIGNATURES = {
    # K1: one packed launch record (ops/fused_conv.py::launch_k1) and the
    # stream: forty separate arguments cost ctypes a third of the call's host time
    "zt_fused_conv": [ctypes.c_char_p, _P],
    "zt_fused_conv_mma": [ctypes.c_char_p, _P],
    "zt_gru_reset": [_P, _P, _P, _I, _I, _I, _I, _P],
    "zt_gru_update": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "zt_equalize": [_P, _P, _P, _I, _I, _I, _I, _P],
    # coords, 4 level pointers, 4 (h, w), levels, radius, queries, level_bf16, out_bf16, out, stream
    "zt_corr_lookup": [_P] * 5 + [_I] * 8 + [_I] * 5 + [_P, _P],
}

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them."""
    target = BUILD_DIR / f"libzt_kernels-{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / target.name
        subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp), *objs],
            check=True, capture_output=True, text=True,
        )
        os.replace(lib_tmp, target)  # atomic: a reader never sees half a file
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_handle(device) -> int:
    import torch

    # the raw handle of the current stream (what current_stream(device).cuda_stream
    # holds), without building the Stream object: K1 asks for it at every launch
    return torch._C._cuda_getCurrentRawStream(device.index)
