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

``--mesh_data N`` or ``--mesh_spatial M`` above 1 serves on an N x M mesh
of ranks (JAX :70-88, :169-235), one process per rank, spawned here or
joined under torchrun. Rank 0 scans the inbox, settles frames and keeps the
manifest; for each scan it broadcasts the rounds to run, or the order to
stop, so no rank waits on a collective the others skip. A round takes one
frame from each of up to N active scenes, in sorted order, as JAX does; a
scene keeps the data index that holds its carry while that index is free,
and its carry moves (a broadcast) when it must change index. Each scene's
frames run ``predict_step`` one at a time, by bands of rows over the
spatial axis when M > 1; the PNGs are written by the scene's rank of
spatial index 0, and the manifest line by rank 0 once every rank is done.
The outputs are the single-device daemon's, frame for frame.
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
import torch.distributed as dist

from .. import native
from ..core.config import Config, add_config_args, config_from_args
from ..core.device import resolve_device
from ..data.datasets import extract_number, sort_files_by_name
from ..models import build_model
from ..parallel import launch
from ..parallel.mesh import Mesh, broadcast_, broadcast_object
from ..parallel.spmd_predict import predict_step_banded
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
    """Serve until STOP or the idle timeout; returns the frames served (on
    a mesh, rank 0's count, which is every frame). ``device`` None means the
    card (and raises without one); on a mesh, the ranks' cards."""
    if config.mesh_data > 1 or config.mesh_spatial > 1:
        return launch.run(_serve_spmd, (config, poll_sec, settle_sec, max_idle_sec), n_data=config.mesh_data,
                          n_spatial=config.mesh_spatial, device=device)[0]
    device = resolve_device(device)
    os.makedirs(config.save, exist_ok=True)
    setup_logging(config.save)
    log = logging.getLogger()
    model = build_model(load_state_dict(config), device=device, precision=config.precision)
    log.info("serving %s -> %s", config.lowlight_images_path, config.save)

    done = _served(config.save)
    carries: dict[str, dict] = {}
    last_idx: dict[str, int] = {}
    step_kwargs = dict(of_scale=config.of_scale, raft_iters=config.raft_iters, enh_scale=config.enh_scale)
    inbox = config.lowlight_images_path
    processed = 0
    last_activity = time.time()

    def is_new(scene: str, idx: int) -> bool:
        return scene not in carries or idx != last_idx.get(scene, -2) + 1

    with open(os.path.join(config.save, "manifest.jsonl"), "a") as manifest:

        def emit(p: str, scene: str, idx: int, new: bool, H2, H3) -> None:
            _write_pngs(config, p, H2, H3)
            _record(manifest, done, inbox, p, scene, idx, new)

        while True:
            if os.path.exists(os.path.join(inbox, "STOP")):
                log.info("STOP file found; exiting")
                break
            acted = False
            for scene, todo in sorted(_settled(inbox, done, settle_sec).items()):
                acted = True
                while todo:
                    if config.chunk > 1 and len(todo) >= config.chunk:
                        group, todo = todo[:config.chunk], todo[config.chunk:]
                        flags, idxs = [], []
                        for p in group:
                            idx = extract_number(p)
                            # the carry exists after the group's first frame
                            flags.append(is_new(scene, idx) if not flags else idx != idxs[-1] + 1)
                            idxs.append(idx)
                        frames = torch.from_numpy(np.stack([_load_frame(config, p) for p in group])[:, None])
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
                        frame = torch.from_numpy(_load_frame(config, p)[None])
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


def _served(save: str) -> set[str]:
    """The frames the manifest under ``save`` lists: served before a restart."""
    path = os.path.join(save, "manifest.jsonl")
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        done = {json.loads(line)["path"] for line in f if line.strip()}
    logging.getLogger().info("resuming: %d frames already served", len(done))
    return done


def _settled(inbox: str, done: set[str], settle_sec: float) -> dict[str, list[str]]:
    """Scene -> the longest settled run of its unserved frames, where it has one."""
    now = time.time()
    todo_map = {}
    for scene, paths in _scan(inbox).items():
        todo: list[str] = []
        for i, p in enumerate(paths):
            if p in done:
                continue
            if i + 1 == len(paths) and now - os.path.getmtime(p) < settle_sec:
                break
            todo.append(p)
        if todo:
            todo_map[scene] = todo
    return todo_map


def _load_frame(config: Config, p: str) -> np.ndarray:
    img = native.read_rgb(p)
    size = (config.frame_width, config.frame_height)
    if (img.shape[1], img.shape[0]) != size:
        img = native.resize_bicubic_pil(img, size)
    return img


def _write_pngs(config: Config, p: str, H2, H3) -> None:
    rel = os.path.relpath(p, config.lowlight_images_path)
    out_dir = os.path.join(config.save, os.path.dirname(rel))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(p))[0]
    write_png(os.path.join(out_dir, stem + "_denoise.png"), H3)
    write_png(os.path.join(out_dir, stem + "_enhance.png"), H2)


def _record(manifest, done: set[str], inbox: str, p: str, scene: str, idx: int, new: bool) -> None:
    """A served frame's manifest line (its PNGs exist), flushed at once."""
    manifest.write(json.dumps({"path": p, "scene": scene, "index": idx, "new_seq": bool(new),
                               "t": time.time()}) + "\n")
    manifest.flush()
    done.add(p)
    logging.getLogger().info("served %s (new_seq=%s)", os.path.relpath(p, inbox), new)


class _Rounds:
    """Rank 0's plan of the mesh's rounds: which frame each data index runs
    (a scene keeps the index that holds its carry while it is free), its
    new-sequence flag, and the carries that must move before a round."""

    def __init__(self, n_data: int):
        self.n_data = n_data
        self.slot_of: dict[str, int] = {}  # the data index holding each scene's carry
        self.last_idx: dict[str, int] = {}

    def plan(self, todo_map: dict[str, list[str]]) -> list[dict]:
        todo = {s: list(ps) for s, ps in todo_map.items()}
        rounds = []
        while todo:
            active = sorted(todo)[:self.n_data]
            free = list(range(self.n_data))
            placed = {}
            for scene in active:
                if self.slot_of.get(scene) in free:
                    placed[scene] = self.slot_of[scene]
                    free.remove(placed[scene])
            slots: list = [None] * self.n_data
            moves = []
            for scene in active:
                slot = placed.get(scene)
                if slot is None:
                    slot = free.pop(0)
                p = todo[scene].pop(0)
                if not todo[scene]:
                    del todo[scene]
                idx = extract_number(p)
                new = scene not in self.slot_of or idx != self.last_idx.get(scene, -2) + 1
                if not new and self.slot_of[scene] != slot:
                    moves.append((scene, self.slot_of[scene], slot))
                self.slot_of[scene] = slot
                self.last_idx[scene] = idx
                slots[slot] = (p, scene, idx, new)
            rounds.append({"slots": slots, "moves": moves})
        return rounds


def _serve_spmd(mesh: Mesh, config: Config, poll_sec: float, settle_sec: float, max_idle_sec: float) -> int:
    """One rank of the mesh daemon; rank 0 returns the frames served, the
    others the frames they wrote."""
    lead = mesh.rank == 0
    os.makedirs(config.save, exist_ok=True)
    if lead:
        setup_logging(config.save)
    log = logging.getLogger()
    if not lead:
        log.setLevel(logging.ERROR)  # one rank speaks for the daemon
    model = build_model(load_state_dict(config), device=mesh.device, precision=config.precision)
    inbox = config.lowlight_images_path
    log.info("scene-parallel serving %s -> %s on mesh %s, backend %s", inbox, config.save, mesh.shape, mesh.backend)
    step_kwargs = dict(of_scale=config.of_scale, raft_iters=config.raft_iters, enh_scale=config.enh_scale)
    shape = (1, config.frame_height, config.frame_width, 3)
    carries: dict[str, dict] = {}  # the scenes whose carry this rank holds
    written = processed = 0
    manifest = None
    if lead:
        done = _served(config.save)
        rounds = _Rounds(mesh.n_data)
        last_activity = time.time()
        manifest = open(os.path.join(config.save, "manifest.jsonl"), "a")
    try:
        while True:
            order = None
            if lead:
                if os.path.exists(os.path.join(inbox, "STOP")):
                    log.info("STOP file found; exiting")
                    order = "stop"
                elif todo_map := _settled(inbox, done, settle_sec):
                    order = rounds.plan(todo_map)
                    last_activity = time.time()
                elif time.time() - last_activity > max_idle_sec:
                    log.info("idle %.0fs; exiting", max_idle_sec)
                    order = "stop"
                else:
                    order = []  # nothing settled yet: poll again
            order = broadcast_object(mesh, order)
            if order == "stop":
                break
            for rnd in order:
                for scene, src, dst in rnd["moves"]:
                    held = carries.pop(scene, None) if mesh.data_index == src else None
                    bufs = held or init_carry(model, shape)
                    for k in ("last_H3", "last_s3"):
                        broadcast_(mesh, bufs[k], src * mesh.n_spatial, mesh.world)
                    if mesh.data_index == dst:
                        carries[scene] = bufs
                job = rnd["slots"][mesh.data_index]
                if job is not None:
                    p, scene, _idx, new = job
                    frame = torch.from_numpy(_load_frame(config, p)[None])
                    carry = carries.get(scene) or init_carry(model, shape)
                    if mesh.n_spatial > 1:
                        (H2, H3, _s3), carries[scene] = predict_step_banded(
                            model, frame, carry, new, mesh, halo=config.spatial_halo, **step_kwargs)
                    else:
                        (H2, H3, _s3), carries[scene] = predict_step(model, frame, carry, new, **step_kwargs)
                    if mesh.spatial_index == 0:
                        _write_pngs(config, p, H2[0], H3[0])
                        written += 1
                dist.barrier()  # every PNG of the round exists before the manifest says so
                if lead:
                    for job in filter(None, rnd["slots"]):
                        _record(manifest, done, inbox, *job)
                        processed += 1
            if lead and not order:
                time.sleep(poll_sec)
    finally:
        if manifest is not None:
            manifest.close()
    return processed if lead else written


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
