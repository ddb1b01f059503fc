"""Streaming enhancement service: ``python -m zero_tig_torch.cli.serve``.

Port of ``zero_tig_tpu/cli/serve.py`` (:1-328) on one device. The weights
load once; then the daemon watches an inbox directory and streams each
arriving frame through the inference step, with one recurrent carry per
scene directory, as ``predict`` does but incrementally and restart-safe:

    <inbox>/<scene...>/NNN.png        arriving low-light frames
    <save>/<scene...>/NNN_denoise.png (H3) + NNN_enhance.png (H2)
    <save>/manifest.jsonl             one line per served frame

Frames are served in numeric order per scene directory; a gap in the
numbering starts a new sequence. A frame is read only once its successor
exists or the stream has been quiet for ``--serve_settle_sec``, so a file
still being written is never read. A settled backlog of at least
``--chunk`` frames of one scene runs as ``predict_chunk(emit="u8")`` calls
of ``--chunk`` frames; the rest frame by frame (``predict_step``). Frames
in the manifest are skipped on a restart. The daemon exits when
``<inbox>/STOP`` exists or nothing new arrived for ``--serve_max_idle_sec``.
Frames off the target size are resized with Pillow's bicubic, as the
reference's loader does; PNGs decode and encode through the port's codec.
``--mesh_data`` (scene-parallel serving) waits for the multi-device port.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time

import numpy as np
import torch

from .. import native
from ..core.config import Config, add_config_args, config_from_args
from ..core.device import resolve_device
from ..data.datasets import extract_number, sort_files_by_name
from ..models import build_model
from ..pipeline.steps import init_carry, predict_chunk, predict_step
from .common import load_state_dict, setup_logging, write_png


def _scan(inbox: str) -> dict[str, list[str]]:
    """Scene dir -> its frame paths in numeric order."""
    frames: dict[str, list[str]] = {}
    for p in glob.glob(os.path.join(inbox, "**", "*.png"), recursive=True):
        frames.setdefault(os.path.dirname(p), []).append(p)
    return {d: sort_files_by_name(ps) for d, ps in frames.items()}


def run_serve(
    config: Config,
    *,
    device=None,
    poll_sec: float = 0.5,
    settle_sec: float = 2.0,
    max_idle_sec: float = 60.0,
) -> int:
    """Serve until STOP or the idle timeout; returns the frames served.
    ``device`` None means the card (and raises without one)."""
    device = resolve_device(device)
    os.makedirs(config.save, exist_ok=True)
    setup_logging(config.save)
    log = logging.getLogger()
    model = build_model(load_state_dict(config), device=device, precision=config.precision)
    log.info("serving %s -> %s", config.lowlight_images_path, config.save)

    manifest_path = os.path.join(config.save, "manifest.jsonl")
    done: set[str] = set()
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            done = {json.loads(line)["path"] for line in f if line.strip()}
        log.info("resuming: %d frames already served", len(done))

    carries: dict[str, dict] = {}
    last_idx: dict[str, int] = {}
    step_kwargs = dict(of_scale=config.of_scale, raft_iters=config.raft_iters, enh_scale=config.enh_scale)
    size = (config.frame_width, config.frame_height)
    inbox = config.lowlight_images_path
    processed = 0
    last_activity = time.time()

    def load_frame(p: str) -> np.ndarray:
        img = native.read_rgb(p)
        if (img.shape[1], img.shape[0]) != size:
            img = native.resize_bicubic_pil(img, size)
        return img

    def is_new(scene: str, idx: int) -> bool:
        return scene not in carries or idx != last_idx.get(scene, -2) + 1

    with open(manifest_path, "a") as manifest:

        def emit(p: str, scene: str, idx: int, new: bool, H2, H3) -> None:
            rel = os.path.relpath(p, inbox)
            out_dir = os.path.join(config.save, os.path.dirname(rel))
            os.makedirs(out_dir, exist_ok=True)
            stem = os.path.splitext(os.path.basename(p))[0]
            write_png(os.path.join(out_dir, stem + "_denoise.png"), H3)
            write_png(os.path.join(out_dir, stem + "_enhance.png"), H2)
            manifest.write(json.dumps({"path": p, "scene": scene, "index": idx, "new_seq": bool(new),
                                       "t": time.time()}) + "\n")
            manifest.flush()
            done.add(p)
            log.info("served %s (new_seq=%s)", rel, new)

        while True:
            if os.path.exists(os.path.join(inbox, "STOP")):
                log.info("STOP file found; exiting")
                break
            now = time.time()
            acted = False
            for scene, paths in sorted(_scan(inbox).items()):
                # the longest settled run of unserved frames
                todo: list[str] = []
                for i, p in enumerate(paths):
                    if p in done:
                        continue
                    if i + 1 == len(paths) and now - os.path.getmtime(p) < settle_sec:
                        break
                    todo.append(p)
                acted = acted or bool(todo)
                while todo:
                    if config.chunk > 1 and len(todo) >= config.chunk:
                        group, todo = todo[:config.chunk], todo[config.chunk:]
                        flags, idxs = [], []
                        for p in group:
                            idx = extract_number(p)
                            # the carry exists after the group's first frame
                            flags.append(is_new(scene, idx) if not flags else idx != idxs[-1] + 1)
                            idxs.append(idx)
                        frames = torch.from_numpy(np.stack([load_frame(p) for p in group])[:, None])
                        if scene not in carries:
                            carries[scene] = init_carry(model, tuple(frames.shape[1:]))
                        (H2s, H3s), carries[scene] = predict_chunk(
                            model, frames, carries[scene], flags, emit="u8", **step_kwargs)
                        last_idx[scene] = idxs[-1]
                        H2s, H3s = H2s.cpu().numpy(), H3s.cpu().numpy()  # one copy to the host per chunk
                        for k, p in enumerate(group):
                            emit(p, scene, idxs[k], flags[k], H2s[k, 0], H3s[k, 0])
                        processed += len(group)
                    else:
                        p = todo.pop(0)
                        frame = torch.from_numpy(load_frame(p)[None])
                        idx = extract_number(p)
                        new = is_new(scene, idx)
                        if scene not in carries:
                            carries[scene] = init_carry(model, tuple(frame.shape))
                        (H2, H3, _s3), carries[scene] = predict_step(model, frame, carries[scene], new, **step_kwargs)
                        last_idx[scene] = idx
                        emit(p, scene, idx, new, H2[0], H3[0])
                        processed += 1
            if acted:
                last_activity = time.time()
            elif time.time() - last_activity > max_idle_sec:
                log.info("idle %.0fs; exiting", max_idle_sec)
                break
            else:
                time.sleep(poll_sec)
    return processed


def main(argv=None):
    parser = argparse.ArgumentParser("ZERO-TIG-serve")
    add_config_args(parser)
    parser.add_argument("--serve_poll_sec", type=float, default=0.5)
    parser.add_argument("--serve_settle_sec", type=float, default=2.0)
    parser.add_argument("--serve_max_idle_sec", type=float, default=60.0)
    args = parser.parse_args(argv)
    run_serve(
        config_from_args(args),
        poll_sec=args.serve_poll_sec,
        settle_sec=args.serve_settle_sec,
        max_idle_sec=args.serve_max_idle_sec,
    )


if __name__ == "__main__":
    main()
