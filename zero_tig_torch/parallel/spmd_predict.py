"""Scene-parallel and row-sharded streaming inference on a (data, spatial) mesh.

Port of ``zero_tig_tpu/parallel/spmd_predict.py`` (:31-79). Scenes are
independent: each data index runs its own stream with its own carry through
``pipeline/steps.py::predict_step``, with no collective at all, so a rank
runs its stream once, without the lockstep of JAX's batch and without the
wrapped revisits JAX computes and then drops (:74-76). Each frame is emitted
once, on the rank with spatial index 0 of its scene.

Across the spatial axis, ``predict_step_banded`` is ``forward_inference``
by bands of rows: every rank of a scene runs the gradient-free whole-frame
part (Denoise_1, the flow at 1/of_scale, the new-sequence reset and the
warp), then the Enhancer and Denoise_2 on its band plus ``halo`` rows (their
receptive field is 7 rows each side), and the owned rows of H2, H3 and s3
are all-gathered into the outputs and the next carry.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.config import Config
from ..data.datasets import FrameDataset, sequential_judgment
from ..models.network import ZeroTIG, forward_inference
from ..pipeline.steps import _carry_on, _norm_frames, init_carry, predict_step
from .mesh import Mesh, all_gather_rows, frame_sharding
from .spmd_train import scene_streams


@torch.inference_mode()
def predict_step_banded(
    model: ZeroTIG,
    frame,
    carry: dict,
    is_new_seq,
    mesh: Mesh,
    *,
    halo: int = 32,
    of_scale: int = 3,
    raft_iters: int = 12,
    enh_scale: int = 1,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], dict]:
    """``predict_step`` of one frame (B, H, W, 3) over the mesh's spatial
    group: ((H2, H3, s3), new_carry), whole frames on every rank of it."""
    dev = model.device
    frame = _norm_frames(frame, dev)
    slice_h, (s0, own0, own1) = frame_sharding(mesh, frame.shape[1], halo)
    outs, _ = forward_inference(
        model, frame, _carry_on(carry, dev), torch.as_tensor(is_new_seq, device=dev), of_scale=of_scale,
        raft_iters=raft_iters, enh_scale=enh_scale, rows=slice(s0, s0 + slice_h),
    )
    own = slice(own0 - s0, own1 - s0)
    H2, H3, s3 = (all_gather_rows(mesh, x[:, own], mesh.spatial).contiguous() for x in outs)
    return (H2, H3, s3), {"last_H3": H3, "last_s3": s3}


def predict_scenes_spmd(
    config: Config,
    dataset: FrameDataset,
    model: ZeroTIG,
    on_frame: Callable[[str, torch.Tensor, torch.Tensor, torch.Tensor], None],
    mesh: Mesh,
) -> int:
    """Run this rank's scene stream (``scene_streams`` over the mesh's
    n_data); with n_spatial > 1 each frame by bands (``config.spatial_halo``
    rows around each). ``on_frame(path, H2, H3, s3)``, (H, W, 3) f32 tensors
    on the device, fires once per frame on the scene's rank of spatial index
    0. Returns the frames this rank emitted."""
    stream = scene_streams(dataset, mesh.n_data)[mesh.data_index]
    if not stream:
        raise ValueError(f"need >= {mesh.n_data} scenes/frames to fill every stream")
    kw = dict(of_scale=config.of_scale, raft_iters=config.raft_iters, enh_scale=config.enh_scale)
    carry = init_carry(model, (1, config.frame_height, config.frame_width, 3))
    prev = stream[0]
    count = 0
    for path in stream:
        frame = torch.from_numpy(np.ascontiguousarray(dataset.load_image(path)[None]))
        flag = sequential_judgment(path, prev)  # the first frame compares with itself: a new sequence
        prev = path
        if mesh.n_spatial > 1:
            (H2, H3, s3), carry = predict_step_banded(model, frame, carry, flag, mesh, halo=config.spatial_halo, **kw)
        else:
            (H2, H3, s3), carry = predict_step(model, frame, carry, flag, **kw)
        if mesh.spatial_index == 0:
            on_frame(path, H2[0], H3[0], s3[0])
            count += 1
    return count
