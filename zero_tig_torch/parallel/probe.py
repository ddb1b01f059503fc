"""Rank programs for the equivalence checks and timings of multi-device runs.

Each is a ``launch.run`` target: it runs a distributed call on its rank and
returns what it computed as CPU tensors, which ``run`` hands back to the
parent, where the single-process and JAX references run.
``tests/test_torch_parallel.py`` runs them on the CPU over gloo, and
``chip_smoke.py`` phase 11 on the card. ``sequence`` runs several in one
launch, each on a mesh of its own shape over the same ranks, so one set of
processes serves them all.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..core import spans
from ..core.config import Config
from ..core.precision import numerics
from ..data import create_dataset
from ..models import build_model
from ..pipeline.steps import init_carry, init_train_state, predict_step
from .mesh import Mesh, make_mesh, replicated, shard_params
from .spmd_predict import predict_scenes_spmd, predict_step_banded
from .spmd_train import spmd_loss_and_grads, train_step_spmd


def sequence(mesh: Mesh, calls: list) -> list:
    """[fn(mesh of (n_data, n_spatial), *args) for fn, (n_data, n_spatial),
    args in calls]: every rank builds each mesh, in order."""
    return [fn(make_mesh(*shape, device=mesh.device), *args) for fn, shape, args in calls]


def call(mesh: Mesh, fn, args: tuple = (), kwargs: dict | None = None):
    """``fn(*args, **kwargs)`` on every rank: an entry point (a CLI's
    ``run_*``) that finds the process group and joins it."""
    return fn(*args, **(kwargs or {}))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def predict_scenes(mesh: Mesh, config: Config, state_dict: dict) -> dict:
    """``predict_scenes_spmd`` over ``config``'s test split: {path: (H2, H3,
    s3)} of the frames this rank emitted, their count, this rank's kernel
    launches and RAFT graph captures and replays, and its backend."""
    model = build_model(state_dict, device=mesh.device, precision=config.precision)
    ds = create_dataset(config.dataset, config.lowlight_images_path, "test",
                        size=(config.frame_width, config.frame_height))
    outs = {}
    _sync(mesh.device)
    spans.reset_counts()
    n = predict_scenes_spmd(config, ds, model, lambda p, *o: outs.__setitem__(p, tuple(x.cpu() for x in o)), mesh)
    _sync(mesh.device)
    return {"outputs": outs, "count": n, "launches": dict(spans.COUNTS), "graphs": dict(spans.GRAPHS),
            "backend": mesh.backend}


def predict_banded(mesh: Mesh, state_dict: dict, precision: str, frames, carry: dict, flags, kw: dict) -> dict:
    """K frames (K, B, H, W, 3) through ``predict_step_banded`` from
    ``carry``: each frame's (H2, H3, s3) on the rank of spatial index 0 (the
    others hold the same whole frames), the last carry, the launches and
    RAFT graph captures and replays."""
    model = build_model(state_dict, device=mesh.device, precision=precision)
    _sync(mesh.device)
    spans.reset_counts()
    outs = []
    for frame, flag in zip(frames, flags):
        (H2, H3, s3), carry = predict_step_banded(model, frame, carry, bool(flag), mesh, **kw)
        if mesh.spatial_index == 0:
            outs.append((H2.cpu(), H3.cpu(), s3.cpu()))
    _sync(mesh.device)
    return {"outputs": outs, "carry": {k: v.cpu() for k, v in carry.items()}, "launches": dict(spans.COUNTS),
            "graphs": dict(spans.GRAPHS), "backend": mesh.backend}


def train_steps(mesh: Mesh, config: Config, state_dict: dict, frames, carry: dict, flags, bn_trains,
                halo: int) -> dict:
    """Training steps of the mesh from ``state_dict`` and ``carry`` (each
    (n_data, B, H, W, 3): scene d's on data index d): frames (n_data, K,
    B, H, W, 3), flags (n_data, K), one ``bn_train`` a step. Per step the
    batch loss, the gradients (by parameter name), and after its update the
    trained tensors (parameters and running statistics) and the scene's
    carry; the launches and RAFT graph captures and replays; whether every
    rank ended with rank 0's bits."""
    d = mesh.data_index
    state = init_train_state(config, state_dict, tuple(frames.shape[2:]), device=mesh.device)
    shard_params(mesh, state.model)
    state = state._replace(carry={k: v[d] for k, v in carry.items()})
    names = {id(p): n for n, p in state.model.named_parameters()}
    kw = dict(halo=halo, of_scale=config.of_scale, raft_iters=config.raft_iters, is_wb=config.is_wb)
    steps = []
    _sync(mesh.device)
    spans.reset_counts()
    for k, bn_train in enumerate(bn_trains):
        loss, new_carry = spmd_loss_and_grads(state, frames[d, k], bool(flags[d][k]), mesh, bn_train=bn_train, **kw)
        grads = {names[id(p)]: p.grad.cpu() for p in state.optimizer.params}
        with numerics(config.precision):
            state.optimizer.step()
        state = state._replace(carry=new_carry)
        trained = {n: v.detach().cpu().clone() for n, v in state.model.state_dict().items()
                   if not n.startswith("raft.") and not n.endswith("num_batches_tracked")}
        steps.append({"loss": loss.cpu(), "grads": grads, "trained": trained,
                      "carry": {n: v.cpu() for n, v in new_carry.items()}})
    _sync(mesh.device)
    return {"steps": steps, "launches": dict(spans.COUNTS), "graphs": dict(spans.GRAPHS),
            "replicated": replicated(mesh, state.model), "backend": mesh.backend}


def time_predict(mesh: Mesh, state_dict: dict, precision: str, n_frames: int, shape: tuple, kw: dict,
                 seed: int = 0) -> dict:
    """ms/frame of this rank's stream of ``n_frames`` random frames already
    on the device (one sequence), ``predict_step`` per frame, or by bands
    with n_spatial > 1, after one warm-up frame; every rank starts together
    (a barrier) and the host clock ends at a synchronize. Also the peak
    device memory this process allocated."""
    model = build_model(state_dict, device=mesh.device, precision=precision)
    gen = torch.Generator(device=mesh.device).manual_seed(seed + mesh.data_index)
    frames = (torch.rand((n_frames + 1, *shape), generator=gen, device=mesh.device) * 255).to(torch.uint8)
    carry = init_carry(model, shape)
    kw = dict(kw)
    halo = kw.pop("halo", 32)

    def step(i, carry):
        if mesh.n_spatial > 1:
            return predict_step_banded(model, frames[i], carry, i == 0, mesh, halo=halo, **kw)[1]
        return predict_step(model, frames[i], carry, i == 0, **kw)[1]

    carry = step(0, carry)
    _sync(mesh.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(1, n_frames + 1):
        carry = step(i, carry)
    _sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3 / n_frames
    peak = torch.cuda.max_memory_allocated(mesh.device) / 1e9 if mesh.device.type == "cuda" else None
    return {"ms_per_frame": ms, "peak_mem_gb": peak, "backend": mesh.backend}


def time_train(mesh: Mesh, config: Config, state_dict: dict, n_steps: int, shape: tuple, bn_train: bool,
               halo: int, seed: int = 0) -> dict:
    """ms a training step of the mesh (``train_step_spmd``'s work) on random
    frames in [0, 0.25) already on the device, after one warm-up step, and
    this process's peak device memory over the timed steps."""
    state = init_train_state(config, state_dict, shape, device=mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(seed + mesh.data_index)
    frames = torch.rand((n_steps + 1, *shape), generator=gen, device=mesh.device) * 0.25
    kw = dict(halo=halo, of_scale=config.of_scale, raft_iters=config.raft_iters, is_wb=config.is_wb)
    state, loss = train_step_spmd(state, frames[0], True, mesh, bn_train=bn_train, **kw)
    _sync(mesh.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(1, n_steps + 1):
        state, loss = train_step_spmd(state, frames[i], False, mesh, bn_train=bn_train, **kw)
    _sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    peak = torch.cuda.max_memory_allocated(mesh.device) / 1e9 if mesh.device.type == "cuda" else None
    return {"ms_per_step": ms, "peak_mem_gb": peak, "loss": float(loss), "backend": mesh.backend}
