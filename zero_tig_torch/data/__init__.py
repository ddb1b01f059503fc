"""Frame datasets, the synthetic fixture and device staging.

The exports of ``zero_tig_tpu/data/__init__.py`` (:1-42)."""

from .augmentor import FlowAugmentor, SparseFlowAugmentor

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
    "FlowAugmentor",
    "SparseFlowAugmentor",
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
