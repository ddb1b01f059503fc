"""Multi-device runs on torch.distributed: a (data, spatial) mesh of ranks,
one process each (``launch.run``), scene-parallel and row-sharded training
and inference. The names of ``zero_tig_tpu/parallel/__init__.py`` (:1-25)
that have counterparts; ``flag_sharding`` and ``shard_frames`` have none
(each rank reads its own scene's frames and flags)."""

from .launch import run
from .mesh import Mesh, carry_sharding, frame_sharding, make_mesh, replicated, shard_params
from .spmd_predict import predict_scenes_spmd, predict_step_banded
from .spmd_train import batched_records, scene_streams, train_scenes_spmd, train_step_spmd

__all__ = [
    "Mesh",
    "batched_records",
    "carry_sharding",
    "frame_sharding",
    "make_mesh",
    "predict_scenes_spmd",
    "predict_step_banded",
    "replicated",
    "run",
    "scene_streams",
    "shard_params",
    "train_scenes_spmd",
    "train_step_spmd",
]
