"""Benchmark-format flow submissions: Middlebury ``.flo`` per frame for
MPI-Sintel, 16-bit KITTI PNGs for KITTI 2012/2015.

Port of ``zero_tig_tpu/flowtools/submit.py`` (:22-86; reference
ptlflow_scripts/test.py:240-295). Frames are read and flows written with
the port's codec. By default each pair runs cold and the flow is written at
the size the model gives (the padded size, for RAFT), as JAX writes it;
``write_sintel_submission(..., warm_start=True)`` is RAFT's published Sintel
submission instead (``flowtools/sequence.py``).
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
from .sequence import flow_chunk

CHUNK = 8  # frames a warm-started scene hands to ``flow_chunk`` at a time


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
    warm_start: bool = False,
) -> int:
    """frames_root/<scene>/frame_NNNN.png -> out_root/<scene>/frame_NNNN.flo,
    the flow from each frame to the next, named after the first. Returns the
    number of flow files written.

    ``warm_start=False``: every pair runs cold through the registry's
    ``forward_fn`` and the flow is written at the size the model gives
    (RAFT's padded size), as the JAX package writes it. ``warm_start=True``
    (``raft`` only): RAFT's published Sintel submission
    (``evaluate.py::create_sintel_submission --warm_start``, which passes
    ``iters=32``): each scene runs through ``flow_chunk``, every pair after a
    scene's first starting from the previous pair's forward-interpolated
    flow, each frame read and copied to the device once, and the flow is
    written at the frame's size (``InputPadder.unpad``)."""
    if warm_start:
        return _sintel_warm(model_name, model, frames_root, out_root, iters, device, precision)
    flow = _flow_fn(model_name, model, iters, device, precision)
    count = 0
    for _, frames, odir in _sintel_scenes(frames_root, out_root):
        for f1, f2 in zip(frames[:-1], frames[1:]):
            write_flo(os.path.join(odir, f"{_stem(f1)}.flo"), flow(f1, f2))
            count += 1
    return count


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _sintel_scenes(frames_root: str, out_root: str):
    """(scene, its sorted frame paths, its output directory), a scene a
    directory; the output directory is made."""
    for scene in sorted(os.listdir(frames_root)):
        sdir = os.path.join(frames_root, scene)
        if not os.path.isdir(sdir):
            continue
        odir = os.path.join(out_root, scene)
        os.makedirs(odir, exist_ok=True)
        yield scene, sorted(glob.glob(os.path.join(sdir, "*.png"))), odir


def _sintel_warm(model_name, model, frames_root, out_root, iters, device, precision) -> int:
    if model_name != "raft":
        raise ValueError(f"warm start needs RAFT's flow_init, not {model_name!r}")
    iters = iters or get_flow_model(model_name).default_iters
    device = resolve_device(device)
    count = 0
    for _, frames, odir in _sintel_scenes(frames_root, out_root):
        carry: dict = {}
        for s in range(0, len(frames), CHUNK):
            batch = frames[s:s + CHUNK]
            chunk = torch.from_numpy(np.stack([native.read_rgb(f) for f in batch]))[:, None].to(device)
            (flows, _), carry = flow_chunk(model, chunk, carry, [s + i == 0 for i in range(len(batch))], iters,
                                           precision)
            # the flows of frames s.. (of 1.. in a scene's first chunk), each named after the frame before
            for f1, flow in zip(frames[max(s - 1, 0):s + len(batch) - 1], flows.cpu().numpy(), strict=True):
                write_flo(os.path.join(odir, f"{_stem(f1)}.flo"), flow[0])
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
