"""The flow sidecar's model registry.

Port of ``zero_tig_tpu/flowtools/registry.py`` (:17-103), with the same four
names and iteration counts: ``raft`` (12), ``raft_small`` (12),
``lk_pyramid`` (3, nothing to train) and ``pwc_lite`` (1). A model is an
``nn.Module``; ``init_fn(seed or torch.Generator, device=None)`` draws its
weights with torch's ``Conv2d`` defaults (weight and bias uniform in
+-1/sqrt(fan_in), BatchNorm at identity) on the CPU and moves it to
``device``: the card unless the caller names the CPU.

``forward_fn(model, img1, img2, iters, precision="highest")`` gives
(flow_low, flow_up) without gradients, for (B, H, W, 3) frames in [0, 255]
on the model's device; "highest" is f32 throughout (TF32 off), "fast" takes
bf16 conv operands with f32 sums, JAX's two modes. ``raft`` runs its
inference loop on K1 and the GRU kernel (K2) on the card, the others on
library convolutions. ``predictions_fn(model, img1, img2, iters,
precision="highest")`` gives the differentiable (seq, B, H, W, 2) prediction
sequence the sequence loss takes (``flowtools/train.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.precision import compute_dtype, numerics
from ..models import init_weights
from ..models.classical_flow import LucasKanade
from ..models.pwc import PWCLite
from ..models.raft.raft import RAFT
from ..models.raft.small import RAFTSmall


@dataclass
class FlowModel:
    name: str
    init_fn: Callable[..., nn.Module]  # (seed | Generator, device=None) -> model
    forward_fn: Callable[..., tuple]  # (model, img1, img2, iters, precision) -> flows
    default_iters: int
    # (model, img1, img2, iters, precision) -> (seq, B, H, W, 2) full-res
    # prediction sequence for supervised training (RAFT: one a refinement
    # iteration; PWC: one a pyramid level); None = not trainable here
    predictions_fn: Callable[..., torch.Tensor] | None = None


_REGISTRY: dict[str, FlowModel] = {}


def register_flow_model(model: FlowModel) -> None:
    _REGISTRY[model.name] = model


def get_flow_model(name: str) -> FlowModel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown flow model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def _init(cls) -> Callable[..., nn.Module]:
    def init_fn(key: int | torch.Generator = 0, device: str | torch.device | None = None) -> nn.Module:
        return init_weights(cls(), key).to(resolve_device(device)).eval()

    return init_fn


def prepare_raft(model: RAFT, precision: str) -> None:
    """Prepare the weight operands of RAFT's inference loop (K1 and the GRU
    kernel take the update core and the mask head) again when the precision
    changed or a parameter was written since (a training step)."""
    dtype = compute_dtype(precision)
    stamp = (dtype, tuple(p._version for p in model.parameters()))
    if getattr(model, "prepared_stamp", None) != stamp:
        model.prepare(dtype)
        model.prepared_stamp = stamp


def _raft_forward(model: RAFT, img1, img2, iters: int, precision: str = "highest"):
    """RAFT's inference loop on the operands ``prepare_raft`` keeps."""
    prepare_raft(model, precision)
    with torch.no_grad(), numerics(precision):
        return model(img1, img2, iters)


def _plain_forward(model: nn.Module, img1, img2, iters: int, precision: str = "highest"):
    with torch.no_grad(), numerics(precision):
        return model(img1, img2, iters, dtype=compute_dtype(precision))


def _predictions(model: nn.Module, img1, img2, iters: int, precision: str = "highest") -> torch.Tensor:
    with numerics(precision):
        return model(img1, img2, iters, return_predictions=True, dtype=compute_dtype(precision))[1]


def _register_builtin() -> None:
    register_flow_model(FlowModel("raft", _init(RAFT), _raft_forward, 12, _predictions))
    register_flow_model(FlowModel("raft_small", _init(RAFTSmall), _plain_forward, 12, _predictions))
    register_flow_model(FlowModel("lk_pyramid", _init(LucasKanade), _plain_forward, 3, None))
    register_flow_model(FlowModel("pwc_lite", _init(PWCLite), _plain_forward, 1, _predictions))


_register_builtin()
