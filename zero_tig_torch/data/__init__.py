"""Frame datasets, the synthetic fixture and device staging.

The exports of ``zero_tig_tpu/data/__init__.py`` (:1-42) but the flow
sidecar's augmentors (ROADMAP.md queue 1 item 10)."""

from .datasets import (
    DIDDataset,
    FrameDataset,
    FrameRecord,
    GenericDataset,
    RLVDataset,
    SDSDDataset,
    create_dataset,
    gt_path_for,
    sequential_judgment,
    sort_files_by_name,
)
from .prefetch import (
    ChunkRecord,
    DeviceRecord,
    chunk_prefetch,
    device_prefetch,
)
from .synthetic import make_rlv_fixture

__all__ = [
    "ChunkRecord",
    "DIDDataset",
    "DeviceRecord",
    "FrameDataset",
    "FrameRecord",
    "GenericDataset",
    "RLVDataset",
    "SDSDDataset",
    "chunk_prefetch",
    "create_dataset",
    "device_prefetch",
    "gt_path_for",
    "make_rlv_fixture",
    "sequential_judgment",
    "sort_files_by_name",
]
