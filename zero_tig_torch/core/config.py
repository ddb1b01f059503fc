"""The run configuration, under the JAX package's field names and defaults.

Port of ``zero_tig_tpu/core/config.py`` (:17-73; reference train.py:15-27,
model/model.py, loss.py). The TPU's device knobs (mesh and spatial-band
sizes, prefetch depth, compute dtype) have no counterpart here; the
precision mode sets the dtype. The CLIs that read these fields as flags
come in a later slice.
"""

from __future__ import annotations

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
    enh_scale: int = 1
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

    raft_weights: str | None = None
    resume: str | None = None
    precision: str = "highest"  # "highest" (f32) | "fast" (bf16 operands, f32 sums)
    chunk: int = 1  # frames per train_chunk / predict_chunk call

    @property
    def is_wb(self) -> bool:
        """Adaptive white balance for underwater data (model/model.py:94)."""
        return self.dataset == "underwater"

    @property
    def frame_size(self) -> tuple[int, int]:
        return (self.frame_height, self.frame_width)
