"""The flow sidecar: model registry, benchmark, validation, submissions and
supervised training; the exports of ``zero_tig_tpu/flowtools/__init__.py``
(:1-36)."""

from .benchmark import benchmark_all, benchmark_model
from .metrics import flow_metrics
from .registry import (
    FlowModel,
    available_models,
    get_flow_model,
    register_flow_model,
)
from .submit import write_kitti_submission, write_sintel_submission
from .train import (
    FlowTrainState,
    flow_train_step,
    init_flow_train_state,
    sequence_loss,
    train_flow_model,
)
from .validate import infer_pair, validate_folder

__all__ = [
    "FlowModel",
    "FlowTrainState",
    "flow_train_step",
    "init_flow_train_state",
    "sequence_loss",
    "train_flow_model",
    "available_models",
    "benchmark_all",
    "benchmark_model",
    "flow_metrics",
    "get_flow_model",
    "infer_pair",
    "register_flow_model",
    "validate_folder",
    "write_kitti_submission",
    "write_sintel_submission",
]
