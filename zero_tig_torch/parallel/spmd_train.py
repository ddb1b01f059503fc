"""Scene-parallel and row-sharded training on a (data, spatial) mesh.

Port of ``zero_tig_tpu/parallel/spmd_train.py`` (:32-147). JAX trains B
scenes together as one batched ``train_step`` on its mesh; here each data
index is a process group of ranks that holds one scene's frame and carry,
and each rank of a scene runs one band of its rows (``pipeline/spatial.py``).
One step, ``train_step_spmd``:

  * every rank of a scene runs the flow phase on the whole frame (no
    gradient; K1, K2 and K3 on the card);
  * with ``bn_train`` (epoch 0) pass A's owned-row sums are all-reduced over
    the world, with n_el = n_data*H*W values a channel: the statistics of
    the batch of n_data scenes that JAX's ``train_step`` normalises by. The
    running statistics move once, from those;
  * pass B runs the rank's band; the statistics' adjoints, and in pass C the
    BatchNorm path's, are all-reduced over the world;
  * the parameters' gradients are summed over the spatial group and averaged
    over the data group (one world all-reduce over n_data) before the one
    clip, weight decay and Adam update, so every rank keeps the same bits;
  * the owned rows of H3 and s3 are all-gathered over the spatial group
    into the scene's whole carry, which the next frame's warp needs.

The loss separates over scenes: each of its terms is a plain mean over the
batch's values, and ``loss_factor`` is per sample
(``losses/zero_tig_loss.py``), so the batch loss is the mean of the scenes'
losses, and its gradient the mean of theirs. The logged loss is the world's
all-reduced loss over n_data.

Semantics (as in JAX): the reference presents frames one at a time, batch 1,
so scene-parallel training is another optimisation trajectory, gradients
averaged over n_data scenes a step; n_data = 1 is the reference's loop.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from ..core.config import Config
from ..core.precision import numerics
from ..data.datasets import FrameDataset, sequential_judgment
from ..pipeline.spatial import band_geometry, bands_loss_and_grads
from ..pipeline.steps import TrainState, _norm_frames
from .mesh import Mesh, all_gather_rows, all_reduce


def scene_streams(dataset: FrameDataset, n_streams: int) -> list[list[str]]:
    """The dataset's frame paths in ``n_streams`` streams of whole scenes:
    the longest scene first, each to the stream with the fewest frames."""
    scenes: list[list[str]] = []
    prev = None
    for p in dataset.paths:
        if prev is None or sequential_judgment(p, prev):
            scenes.append([])
        scenes[-1].append(p)
        prev = p
    streams: list[list[str]] = [[] for _ in range(n_streams)]
    sizes = [0] * n_streams
    for scene in sorted(scenes, key=len, reverse=True):
        i = int(np.argmin(sizes))
        streams[i].extend(scene)
        sizes[i] += len(scene)
    return streams


def lockstep(dataset: FrameDataset, n_streams: int) -> Iterator[list[tuple[str, bool]]]:
    """Per step, each stream's (path, is_new_seq). Streams shorter than the
    longest loop back to their start; the first frame compares with itself
    and a wrap jumps back, so both start a new sequence."""
    streams = scene_streams(dataset, n_streams)
    if any(not s for s in streams):
        raise ValueError(f"need >= {n_streams} scenes/frames to fill every stream")
    prevs = [s[0] for s in streams]
    for t in range(max(len(s) for s in streams)):
        step = []
        for i, s in enumerate(streams):
            p = s[t % len(s)]
            step.append((p, sequential_judgment(p, prevs[i])))
            prevs[i] = p
        yield step


def batched_records(dataset: FrameDataset, n_streams: int) -> Iterator[tuple[np.ndarray, np.ndarray, list[str]]]:
    """JAX's lockstep batches: ((B, H, W, 3) frames, (B,) is_new_seq, [B paths])."""
    for step in lockstep(dataset, n_streams):
        paths = [p for p, _ in step]
        yield np.stack([dataset.load_image(p) for p in paths]), np.asarray([f for _, f in step]), paths


def stream_records(dataset: FrameDataset, n_streams: int, index: int) -> Iterator[tuple[np.ndarray, bool, str]]:
    """Stream ``index``'s part of ``batched_records``: (frame (H, W, 3) f32,
    is_new_seq, path), each frame loaded alone by the rank that needs it."""
    for step in lockstep(dataset, n_streams):
        p, flag = step[index]
        yield dataset.load_image(p), flag, p


def spmd_loss_and_grads(
    state: TrainState,
    frame,
    is_new_seq,
    mesh: Mesh,
    *,
    halo: int = 32,
    of_scale: int = 3,
    raft_iters: int = 12,
    is_wb: bool = False,
    bn_train: bool = True,
) -> tuple[torch.Tensor, dict]:
    """This rank's scene (1, H, W, 3) and band: (the batch loss, the scene's
    whole new carry), with the batch's gradients in the trainable
    parameters' ``.grad``, the same bits on every rank, and with ``bn_train``
    the running statistics moved by the batch's statistics."""
    dev = state.model.device
    frame = _norm_frames(frame, dev)
    slice_h, geoms = band_geometry(frame.shape[1], mesh.n_spatial, halo)
    loss, h3, s3 = bands_loss_and_grads(
        state, frame, is_new_seq, [geoms[mesh.spatial_index]], slice_h=slice_h,
        n_el=mesh.n_data * frame[..., 0].numel(), of_scale=of_scale, raft_iters=raft_iters, is_wb=is_wb,
        bn_train=bn_train, reduce=lambda t: all_reduce(mesh, t, mesh.world),
    )
    params = state.optimizer.params
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = all_reduce(mesh, torch.cat([g.flatten() for g in grads]), mesh.world) / mesh.n_data
    for p, g in zip(params, torch.split(flat, [g.numel() for g in grads])):
        p.grad = g.view_as(p)
    loss = all_reduce(mesh, loss.detach(), mesh.world) / mesh.n_data
    carry = {"last_H3": all_gather_rows(mesh, h3[0], mesh.spatial).contiguous(),
             "last_s3": all_gather_rows(mesh, s3[0], mesh.spatial).contiguous()}
    return loss, carry


def train_step_spmd(
    state: TrainState,
    frame,
    is_new_seq,
    mesh: Mesh,
    *,
    halo: int = 32,
    of_scale: int = 3,
    raft_iters: int = 12,
    is_wb: bool = False,
    bn_train: bool = True,
) -> tuple[TrainState, torch.Tensor]:
    """One step of the mesh: this rank's scene frame (1, H, W, 3), its band
    of ``H / n_spatial`` rows run with ``halo`` rows around it. (new_state,
    the batch loss); the parameters stay the same on every rank."""
    loss, carry = spmd_loss_and_grads(
        state, frame, is_new_seq, mesh, halo=halo, of_scale=of_scale, raft_iters=raft_iters, is_wb=is_wb,
        bn_train=bn_train,
    )
    with numerics(state.model.precision):
        state.optimizer.step()
    return TrainState(state.model, state.optimizer, carry), loss


def train_scenes_spmd(
    config: Config,
    dataset: FrameDataset,
    state: TrainState,
    mesh: Mesh,
    *,
    epochs: int | None = None,
    epoch_offset: int = 0,
    log_fn: Callable[[str], None] | None = print,
) -> TrainState:
    """Train over ``mesh.n_data`` scene streams in lockstep, each rank on
    its stream's frames. state/epoch_offset let a caller drive one epoch at
    a time (the train CLI does, to save each epoch's artifacts): the
    BatchNorm schedule keys on the ABSOLUTE epoch. Rank 0 logs JAX's lines
    through ``log_fn``."""
    log_fn = log_fn if mesh.rank == 0 else None
    kw = dict(halo=config.spatial_halo, of_scale=config.of_scale, raft_iters=config.raft_iters, is_wb=config.is_wb)
    epochs = config.epochs if epochs is None else epochs
    for rel_epoch in range(epochs):
        epoch = epoch_offset + rel_epoch
        losses = []
        for step, (frame, flag, _path) in enumerate(stream_records(dataset, mesh.n_data, mesh.data_index)):
            state, loss = train_step_spmd(state, frame[None], flag, mesh, bn_train=epoch == 0, **kw)
            losses.append(float(loss))
            if log_fn:
                log_fn(f"spmd-epoch {epoch:03d} {step:03d} {losses[-1]:f}")
        if log_fn:
            log_fn(f"spmd-epoch {epoch:03d} mean {float(np.mean(losses)):f}")
    return state
