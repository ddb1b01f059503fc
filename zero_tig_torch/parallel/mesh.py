"""The (data, spatial) mesh of a multi-device run, on ``torch.distributed``.

Port of ``zero_tig_tpu/parallel/mesh.py`` (:27-67). JAX drives every device
from one controller and XLA places the collectives; the port runs one
process per rank (``parallel/launch.py``) and calls the collectives itself:

  * ``data``: independent video scenes, one per data index, each with its
    own recurrent carry; training averages the gradients over this axis.
  * ``spatial``: the ranks of one scene split the frame's ROWS into bands
    (``pipeline/spatial.py::band_geometry``), each band run with ``halo``
    rows around it. JAX shards the width and lets XLA insert the halos; the
    port shards rows, whose halo and Region-mode loss ``spatial.py`` already
    holds against JAX. ``--mesh_spatial N`` keeps its meaning, one frame
    over N devices: the height must split into N even band heights.

Rank r sits at (r // n_spatial, r % n_spatial), JAX's row-major device grid.

The backend is chosen by a rule, not by falling back after a failure: NCCL
when every rank has a card of its own; gloo on the CPU, and when ranks share
a card (NCCL refuses two ranks on one device). gloo's collectives take CPU
tensors, so under gloo the helpers below stage a card's tensors through the
host. ``flag_sharding`` has no counterpart: each rank reads its own scene's
flag.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..pipeline.spatial import band_geometry


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK, or the global rank where nothing says otherwise)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: str | torch.device | None, local: int) -> torch.device:
    """A rank's device: ``cuda:(local % device_count)`` unless the caller
    names the CPU. No card raises: a rank never carries on on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: multi-device runs use the cards unless the caller passes device='cpu'")
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when each of this host's ``local_world_size`` ranks has a card
    of its own, gloo on the CPU or when ranks share a card."""
    if device.type == "cpu" or local_world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


@dataclass
class Mesh:
    """This rank's place in an ``n_data x n_spatial`` mesh, its device, and
    the process groups: ``world``, ``data`` (the ranks with this rank's
    spatial index, one per scene) and ``spatial`` (the ranks of this
    rank's scene, in band order)."""

    n_data: int
    n_spatial: int
    rank: int
    device: torch.device
    backend: str
    world: dist.ProcessGroup
    data: dist.ProcessGroup
    spatial: dist.ProcessGroup

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "spatial": self.n_spatial}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial


def make_mesh(n_data: int = 1, n_spatial: int = 1, *, device: str | torch.device | None = None) -> Mesh:
    """A (data, spatial) mesh over the initialised process group, whose
    size must be ``n_data * n_spatial``. Every rank calls it, in the same
    order as its other group constructions. ``device``: "cpu", a card by
    index, or None (or "cuda") for the rank's card (``rank_device``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run through parallel.launch.run, or torchrun")
    world = dist.get_world_size()
    need = n_data * n_spatial
    if world != need:
        raise ValueError(f"mesh {n_data}x{n_spatial} needs {need} ranks, the process group has {world}")
    if device is None or torch.device(device).index is None:
        device = rank_device(device, local_rank())
    groups: dict[str, dist.ProcessGroup] = {}
    rank = dist.get_rank()
    # every rank makes every group, in one order (torch.distributed's rule)
    for s in range(n_spatial):
        g = dist.new_group([d * n_spatial + s for d in range(n_data)])
        if rank % n_spatial == s:
            groups["data"] = g
    for d in range(n_data):
        g = dist.new_group([d * n_spatial + s for s in range(n_spatial)])
        if rank // n_spatial == d:
            groups["spatial"] = g
    return Mesh(n_data, n_spatial, rank, device, dist.get_backend(), dist.group.WORLD, groups["data"],
                groups["spatial"])


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend's collectives take it: the host under gloo,
    the rank's card under NCCL."""
    return t.to("cpu" if mesh.backend == "gloo" else mesh.device)


def all_reduce(mesh: Mesh, t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor on ``t``'s device;
    every rank of the group gets the same bits."""
    buf = _staged(mesh, t).clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_rows(mesh: Mesh, t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The group's (B, rows, ...) blocks, equal in size, concatenated along
    dim 1 in group order: the bands of a scene back into its frame."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = _staged(mesh, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, 1).to(t.device)


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int, group: dist.ProcessGroup) -> torch.Tensor:
    """Global rank ``src``'s ``t`` into every rank's ``t``, in place."""
    buf = _staged(mesh, t).contiguous()
    dist.broadcast(buf, src=src, group=group)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Global rank ``src``'s picklable ``obj``, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.world)
    return box[0]


def _tensors(module: torch.nn.Module) -> list[torch.Tensor]:
    return [t for _, t in sorted({**dict(module.named_parameters()), **dict(module.named_buffers())}.items())]


@torch.no_grad()
def shard_params(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Replicate ``module``'s parameters and buffers from rank 0 to every
    rank, in place (JAX's ``shard_params``: a replicated device_put). Each
    arrives in a buffer and is copied into the tensor itself: the copy
    moves the tensor's version counter, which the stamp of the kernels'
    weight operands reads (a collective into ``.data`` would not)."""
    for t in _tensors(module):
        buf = _staged(mesh, t).clone()
        dist.broadcast(buf, src=0, group=mesh.world)
        t.copy_(buf)
    return module


@torch.no_grad()
def replicated(mesh: Mesh, module: torch.nn.Module) -> bool:
    """Whether every rank holds rank 0's parameters and buffers, bit for bit."""
    differ = torch.zeros(1)
    for t in _tensors(module):
        ref = broadcast_(mesh, t.detach().clone(), 0, mesh.world)
        differ += float(not torch.equal(ref, t))
    return float(all_reduce(mesh, differ, mesh.world)) == 0.0


def frame_sharding(mesh: Mesh, height: int, halo: int) -> tuple[int, tuple[int, int, int]]:
    """This rank's band of a frame of ``height`` rows: (slice_h, (slice
    start, first owned row, end of the owned rows)). Raises ValueError
    where the height does not split into ``n_spatial`` even band heights."""
    slice_h, geoms = band_geometry(height, mesh.n_spatial, halo)
    return slice_h, geoms[mesh.spatial_index]


def carry_sharding(mesh: Mesh, height: int) -> slice:
    """The rows of the carry this rank computes; each rank of a scene holds
    the whole carry after the step's all-gather (the warp needs it whole)."""
    band_h = height // mesh.n_spatial
    return slice(mesh.spatial_index * band_h, (mesh.spatial_index + 1) * band_h)
