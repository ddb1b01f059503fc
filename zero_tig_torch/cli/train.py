"""Zero-shot training CLI: ``python -m zero_tig_torch.cli.train``.

Port of ``zero_tig_tpu/cli/train.py`` (:1-276; reference train.py, the same
flags and artifacts). Artifacts per run (train.py:33-36, :135, :149-152):

    <save>/Train-YYYYmmdd-HHMMSS/
        log.txt, scripts/ (snapshot), initial_weights.pt
        model_epochs/weights_<epoch>.pt   (reference-loadable, RAFT included)
        model_epochs/state_<epoch>.pt     (full train state, for --resume)
        result/{denoise,enhance}/<scene>_<frame>_{denoise,enhance}_<e>.png

``--resume auto`` searches the new run's ``model_epochs/``, as the JAX CLI
does (:76-86 with ``create_exp_dir`` at :42), so it finds nothing; pass the
path of a ``state_<e>.pt``. ``--spatial_bands N`` trains each frame in N
bands of rows (``pipeline/spatial.py``) with ``--spatial_halo`` rows around
each, frame by frame (``--chunk`` does not apply).

``--mesh_data N`` (N > 1) trains N scene streams in lockstep on an
N x ``--mesh_spatial`` mesh of ranks (``parallel/spmd_train.py``; JAX
:88-125): one process per rank, spawned here or joined under torchrun.
Rank 0 alone logs and writes the epoch's artifacts; ``--resume`` works as
in the single-device loop, and ``--spatial_bands`` is ignored (the mesh's
spatial axis bands the frame). ``--mesh_spatial`` alone does not apply to
training, as in JAX.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch.distributed as dist

from ..core.checkpoint import save_pt
from ..core.config import Config, add_config_args, config_from_args
from ..core.device import resolve_device
from ..core.train_ckpt import latest_checkpoint, restore_train_state, save_train_state
from ..data import create_dataset, device_prefetch
from ..data.prefetch import ChunkRecord, chunk_prefetch
from ..parallel import launch
from ..parallel.mesh import Mesh, broadcast_object, shard_params
from ..parallel.spmd_train import train_scenes_spmd
from ..pipeline.spatial import train_step_spatial
from ..pipeline.steps import eval_forward_step, init_carry, init_train_state, train_chunk, train_step
from ..utils.misc import count_parameters_in_mb
from .common import create_exp_dir, load_state_dict, setup_logging, write_png


def run_training(config: Config, *, device=None) -> str:
    """Train per ``config``; returns the run directory. ``device`` None
    means the card (and raises without one); with ``mesh_data`` > 1, the
    ranks' cards."""
    if config.mesh_data > 1:
        return launch.run(_train_spmd, (config,), n_data=config.mesh_data, n_spatial=config.mesh_spatial,
                          device=device)[0]
    device = resolve_device(device)
    run_dir = create_exp_dir(config.save)
    model_dir = os.path.join(run_dir, "model_epochs")
    os.makedirs(model_dir, exist_ok=True)
    log = setup_logging(run_dir)
    if config.mesh_spatial > 1:
        log.info("--mesh_spatial %d ignored: it applies with --mesh_data > 1", config.mesh_spatial)
    state, train_ds, test_ds, start_epoch = _setup(config, run_dir, device, log, lead=True)

    step_kwargs = dict(of_scale=config.of_scale, raft_iters=config.raft_iters, is_wb=config.is_wb)
    total_step = 0
    for epoch in range(start_epoch, config.epochs):
        # the reference's BatchNorm schedule: only epoch 0 trains on batch
        # statistics (train.py:115-138)
        bn_train = epoch == 0
        losses: list[float] = []

        def log_losses(values) -> None:
            nonlocal total_step
            for v in values:
                losses.append(float(v))
                total_step += 1
                log.info("train-epoch %03d %03d %f", epoch, len(losses) - 1, losses[-1])

        if config.spatial_bands > 1:
            # banded training, frame by frame: the gradients of each band of
            # rows accumulate before one optimizer step (JAX :142-164)
            for rec in device_prefetch(train_ds.iter_u8(), depth=config.prefetch_depth, device=device):
                state, loss = train_step_spatial(state, rec.image, rec.is_new_seq, bands=config.spatial_bands,
                                                 halo=config.spatial_halo, bn_train=bn_train, **step_kwargs)
                log_losses([loss.item()])
            stream = ()
        else:
            # --chunk K runs K sequential frames per train_chunk call; the
            # trailing partial group takes the per-frame step, so no padding
            # frame ever advances the optimizer
            stream = chunk_prefetch(train_ds.iter_u8(), config.chunk, depth=config.prefetch_depth, device=device)
        for item in stream:
            if isinstance(item, ChunkRecord):
                state, k_losses = train_chunk(state, item.images, item.flags, bn_train=bn_train, **step_kwargs)
                log_losses(k_losses.tolist())
            else:
                state, loss = train_step(state, item.image, item.is_new_seq, bn_train=bn_train, **step_kwargs)
                log_losses([loss.item()])
        log.info("train-epoch %03d %f", epoch, float(np.mean(losses)))

        save_train_state(os.path.join(model_dir, f"state_{epoch}.pt"), state, epoch=epoch, step=total_step)
        save_pt(os.path.join(model_dir, f"weights_{epoch}.pt"), state.model)
        _dump_eval_images(config, state, test_ds, run_dir, epoch, device)
    return run_dir


def _setup(config: Config, run_dir: str, device, log, *, lead: bool):
    """The run's train state (resumed where asked), datasets and first
    epoch; the lead process logs and writes ``initial_weights.pt``."""
    log.info("args = %s", config)
    frame_shape = (config.batch_size, config.frame_height, config.frame_width, 3)
    state = init_train_state(config, load_state_dict(config, for_training=True), frame_shape, device=device)
    log.info("model size = %f", count_parameters_in_mb(state.model))

    size = (config.frame_width, config.frame_height)
    train_ds = create_dataset(config.dataset, config.lowlight_images_path, "train", size=size)
    log.info("Training data: %d", len(train_ds))
    test_ds = create_dataset(config.dataset, config.lowlight_images_path, "test", size=size)
    log.info("Test data: %d", len(test_ds))
    if lead:
        save_pt(os.path.join(run_dir, "initial_weights.pt"), state.model)

    start_epoch = 0
    model_dir = os.path.join(run_dir, "model_epochs")
    if config.resume:
        ckpt = latest_checkpoint(model_dir) if config.resume == "auto" else config.resume
        if ckpt and os.path.exists(ckpt):
            state, meta = restore_train_state(ckpt, state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            log.info("Resumed full train state from %s (epoch %d)", ckpt, start_epoch)
    return state, train_ds, test_ds, start_epoch


def _train_spmd(mesh: Mesh, config: Config) -> str:
    """One rank of the ``--mesh_data`` branch: scene-parallel training, one
    epoch per ``train_scenes_spmd`` call; rank 0 makes the run directory,
    logs, and writes each epoch's ``state_<e>.pt``, ``weights_<e>.pt`` and
    eval dumps."""
    lead = mesh.rank == 0
    run_dir = broadcast_object(mesh, create_exp_dir(config.save) if lead else None)
    model_dir = os.path.join(run_dir, "model_epochs")
    if lead:
        os.makedirs(model_dir, exist_ok=True)
        log = setup_logging(run_dir)
    else:
        log = logging.getLogger()
        log.setLevel(logging.ERROR)  # one rank speaks for the run
    log.info("SPMD training: mesh=(%d x %d), backend %s", mesh.n_data, mesh.n_spatial, mesh.backend)
    if config.spatial_bands > 1:
        log.info("--spatial_bands %d ignored: with --mesh_data the mesh's spatial axis bands the frame",
                 config.spatial_bands)
    state, train_ds, test_ds, start_epoch = _setup(config, run_dir, mesh.device, log, lead=lead)
    shard_params(mesh, state.model)
    for epoch in range(start_epoch, config.epochs):
        state = train_scenes_spmd(config, train_ds, state, mesh, epochs=1, epoch_offset=epoch, log_fn=log.info)
        if lead:
            save_train_state(os.path.join(model_dir, f"state_{epoch}.pt"), state, epoch=epoch, step=0)
            save_pt(os.path.join(model_dir, f"weights_{epoch}.pt"), state.model)
            _dump_eval_images(config, state, test_ds, run_dir, epoch, mesh.device)
        dist.barrier()  # the epoch's artifacts exist before any rank moves on
    return run_dir


def _dump_eval_images(config, state, test_ds, run_dir, epoch, device) -> None:
    """Per-epoch test-split dumps (train.py:137-152).

    As the JAX package (:224-268), and unlike the reference, whose eval loop
    warps the recurrent state left by the last training frame, the carry
    threads through the eval frames as in streaming inference; the names
    carry the scene directory, where the reference's collide across scenes
    that share a brightness folder."""
    for sub in ("denoise", "enhance"):
        os.makedirs(os.path.join(run_dir, "result", sub), exist_ok=True)
    carry = None
    for rec in device_prefetch(test_ds.iter_u8(), depth=config.prefetch_depth, device=device):
        if carry is None:
            carry = init_carry(state.model, tuple(rec.image.shape))
        (H2, H3), carry = eval_forward_step(
            state.model, rec.image, carry, rec.is_new_seq,
            of_scale=config.of_scale, raft_iters=config.raft_iters,
        )
        parent = os.path.dirname(rec.path)
        name = f"{os.path.basename(os.path.dirname(parent))}_{os.path.basename(parent)}_{rec.name}"
        write_png(os.path.join(run_dir, "result", "denoise", f"{name}_denoise_{epoch}.png"), H3[0])
        write_png(os.path.join(run_dir, "result", "enhance", f"{name}_enhance_{epoch}.png"), H2[0])


def main(argv=None):
    parser = argparse.ArgumentParser("ZERO-TIG")
    add_config_args(parser)
    run_training(config_from_args(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
