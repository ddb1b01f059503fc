"""One process per rank: spawn the ranks of a mesh, or join torchrun's.

JAX drives every device of its mesh from one controller; ``torch.distributed``
runs one process per rank. ``run(target, args, n_data=, n_spatial=)`` calls
``target(mesh, *args)`` on every rank of an ``n_data x n_spatial`` mesh and
returns the ranks' results:

  * where a process group already exists (a program launched by torchrun
    that joined it, or a rank of an earlier ``run``), this process is one
    rank: it builds the mesh over that group and returns [its result];
  * under torchrun (RANK, WORLD_SIZE and LOCAL_RANK set) it joins the group
    through torchrun's ``env://`` rendezvous, and leaves it afterwards;
  * at world size 1 it runs in this process, in a group of one;
  * otherwise it spawns ``n_data * n_spatial`` processes with the ``spawn``
    start method (a parent may hold threads, JAX's among them, that forking
    would copy mid-flight), which meet through a ``FileStore`` in a
    temporary directory (no TCP port: concurrent runs cannot collide, and no
    network is needed). Each rank saves its result there with
    ``torch.save``; ``run`` returns them in rank order.

``target`` is pickled by its import path: it must be a module-level function
of a module that a fresh interpreter can import cheaply (never a test
module, which would load the test's own imports into every rank). Each rank
runs with the parent's number of intra-op threads. If a rank raises, the
others are terminated and ``run`` raises with that rank's traceback. Every
process group carries ``TIMEOUT``, so no rank waits forever on a collective
that a dead rank will never join. The backend follows ``mesh.choose_backend``
and is logged.
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh, choose_backend, local_rank, make_mesh, rank_device

TIMEOUT = datetime.timedelta(minutes=30)

log = logging.getLogger(__name__)


def in_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def run(
    target: Callable[..., Any],
    args: tuple = (),
    *,
    n_data: int = 1,
    n_spatial: int = 1,
    device: str | torch.device | None = None,
) -> list[Any]:
    """``target(mesh, *args)`` on every rank; the results, in rank order
    (one, this process's, where this process is one rank of a group that
    exists). ``device``: "cpu", or None for the cards (raises without one)."""
    dev_type = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    if dist.is_initialized():
        return [target(make_mesh(n_data, n_spatial, device=dev_type), *args)]
    world = n_data * n_spatial
    if in_torchrun():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        return [_run_rank(target, args, n_data, n_spatial, dev_type, int(os.environ["RANK"]), local_rank(),
                          local_world, dict(init_method="env://"))]
    tmp = tempfile.mkdtemp(prefix="zt_ranks_")
    try:
        store = os.path.join(tmp, "store")
        if world == 1:
            _rank_main(0, target, args, n_data, n_spatial, dev_type, store, tmp, torch.get_num_threads())
        else:
            rank_device(dev_type, 0)  # no card raises here, before any process starts
            mp.start_processes(
                _rank_main, args=(target, args, n_data, n_spatial, dev_type, store, tmp, torch.get_num_threads()),
                nprocs=world, join=True, start_method="spawn",
            )
        return [torch.load(os.path.join(tmp, f"result-{r}.pt"), weights_only=True) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, target, args, n_data, n_spatial, dev_type, store, out_dir, threads) -> None:
    """A spawned rank (or the only one): join, run, save the result."""
    torch.set_num_threads(threads)
    world = n_data * n_spatial
    result = _run_rank(target, args, n_data, n_spatial, dev_type, rank, rank, world,
                       dict(store=dist.FileStore(store, world), rank=rank, world_size=world))
    torch.save(result, os.path.join(out_dir, f"result-{rank}.pt"))


def _run_rank(target, args, n_data, n_spatial, dev_type, rank, local, local_world, init: dict) -> Any:
    device = rank_device(dev_type, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(device, local_world)
    dist.init_process_group(backend, timeout=TIMEOUT, **init)
    try:
        if rank == 0:
            log.info("rank 0 of %d: backend %s on %s", dist.get_world_size(), backend, device)
        mesh = make_mesh(n_data, n_spatial, device=device)
        if device.type == "cuda":
            _build_kernels(mesh)
        return target(mesh, *args)
    finally:
        dist.destroy_process_group()


def _build_kernels(mesh: Mesh) -> None:
    """Rank 0 builds the kernel library (a no-op where it is built) before
    the others load it; they would also build it correctly at once, as the
    build replaces the library atomically, only each on its own."""
    from ..kernels import build

    if mesh.rank == 0:
        build.build()
    dist.barrier()
