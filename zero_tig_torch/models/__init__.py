"""Model construction: ``build_model`` and ``init_random_state_dict``."""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .network import ZeroTIG


def build_model(
    state_dict: dict[str, torch.Tensor],
    device: str | torch.device | None = None,
    precision: str = "fast",
) -> ZeroTIG:
    """The inference network with ``state_dict`` (reference key names)
    loaded, on ``device`` (default: the CUDA card; raises without one) in
    precision mode "fast" (bf16) or "highest" (f32)."""
    device = resolve_device(device)
    model = ZeroTIG(precision)
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    # BatchNorm's step counter is not a weight; the JAX export omits it for RAFT
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    return model.requires_grad_(False).to(device).eval().prepare()


def init_random_state_dict(seed: int) -> dict[str, torch.Tensor]:
    """Random weights under the reference key names, drawn with numpy from
    ``seed``: convs uniform in +-1/sqrt(fan_in) (torch's default bound),
    BatchNorm affine and running statistics near identity."""
    rng = np.random.default_rng(seed)
    model = ZeroTIG("highest")
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith("num_batches_tracked"):
                continue
            shape = tuple(t.shape)
            if name.endswith("running_mean"):
                v = rng.uniform(-0.1, 0.1, shape)
            elif name.endswith("running_var"):
                v = rng.uniform(0.5, 1.5, shape)
            elif t.dim() == 1 and _is_norm(model, name):
                v = rng.uniform(0.9, 1.1, shape) if name.endswith("weight") else rng.uniform(-0.1, 0.1, shape)
            else:
                conv = model.get_submodule(name.rsplit(".", 1)[0])
                fan_in = conv.weight[0].numel()
                bound = 1.0 / np.sqrt(fan_in)
                v = rng.uniform(-bound, bound, shape)
            t.copy_(torch.as_tensor(v, dtype=torch.float32))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _is_norm(model: torch.nn.Module, name: str) -> bool:
    return isinstance(model.get_submodule(name.rsplit(".", 1)[0]), torch.nn.BatchNorm2d)
