"""The run configuration and its command-line flags, under the JAX package's
field names and defaults.

Port of ``zero_tig_tpu/core/config.py`` (:17-92; reference train.py:15-27,
model/model.py, loss.py): every field, the TPU knobs included, so a
reference or JAX command line parses unchanged. ``mesh_data`` /
``mesh_spatial`` above 1 run on a mesh of ranks (``parallel/``): scenes
over the data axis, bands of each frame's rows over the spatial axis, so
the frame height must split into ``mesh_spatial`` even band heights and
the halo must be even, or the ``Config`` raises ``ValueError`` when it is
made. ``spatial_bands`` above 1 trains in bands of rows on one device
(``pipeline/spatial.py``), ``spatial_halo`` rows around each.
``compute_dtype`` is read by nothing, as in the JAX package: the precision
mode sets the dtype. ``prefetch_depth`` sets the depth of
``data.prefetch``'s staging queue.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    # reference argparse surface
    batch_size: int = 1
    seed: int = 2
    epochs: int = 5
    lr: float = 1e-4
    save: str = "./EXP/"
    model_pretrain: str | None = None
    lowlight_images_path: str = ""
    of_scale: int = 3
    dataset: str = "RLV"
    num_workers: int = 0
    gain: int = 100

    # model hyperparameters (hard-coded in the reference)
    enhancer_layers: int = 3
    enhancer_channels: int = 64
    denoise_channels: int = 48
    raft_iters: int = 12
    enh_scale: int = 1  # inference: the Enhancer at 1/enh_scale (models/network.py)
    corr_levels: int = 4
    corr_radius: int = 4

    # optimizer (train.py:98, :130)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    weight_decay: float = 3e-4
    grad_clip: float = 5.0

    # data (dataloader/multi_read_data.py:129)
    frame_width: int = 1920
    frame_height: int = 1080

    # knobs with no reference equivalent
    raft_weights: str | None = None  # a RAFT checkpoint that overrides model_pretrain's
    resume: str | None = None  # a full-train-state checkpoint, or "auto"
    precision: str = "highest"  # "highest" (f32) | "fast" (bf16 operands, f32 sums)
    compute_dtype: str = "float32"
    mesh_data: int = 1
    mesh_spatial: int = 1
    prefetch_depth: int = 2  # chunks staged ahead of the consumer
    chunk: int = 1  # frames per train_chunk / predict_chunk call
    spatial_bands: int = 1
    spatial_halo: int = 32

    def __post_init__(self) -> None:
        if self.mesh_data < 1 or self.mesh_spatial < 1:
            raise ValueError(f"mesh_data={self.mesh_data}, mesh_spatial={self.mesh_spatial}: each must be >= 1")
        n = self.mesh_spatial
        if n > 1 and (self.frame_height % n or (self.frame_height // n) % 2 or self.spatial_halo % 2):
            raise ValueError(
                f"mesh_spatial={n}: frame_height={self.frame_height} must split into {n} even band heights "
                f"and spatial_halo={self.spatial_halo} must be even"
            )

    @property
    def is_wb(self) -> bool:
        """Adaptive white balance for underwater data (model/model.py:94)."""
        return self.dataset == "underwater"

    @property
    def frame_size(self) -> tuple[int, int]:
        return (self.frame_height, self.frame_width)


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Register every Config field as a flag of the same name and default."""
    for f in dataclasses.fields(Config):
        typ = {"int": int, "float": float}.get(str(f.type), str)
        if "str | None" in str(f.type):
            typ = str
        parser.add_argument("--" + f.name, type=typ, default=f.default)


def config_from_args(args: argparse.Namespace) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in names})
