"""Model construction: ``build_model``, ``init_state_dict`` (the CLIs'
weights when no checkpoint is given), ``init_weights`` (torch's defaults
from a generator; the flow sidecar's models too) and
``init_random_state_dict`` (the tests' weights)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from .network import ZeroTIG, reinit_enhancer


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


def init_state_dict(seed: int, *, for_training: bool = False) -> dict[str, torch.Tensor]:
    """Fresh weights under the reference key names, drawn as the JAX
    package draws them (``cli/common.py::load_variables``, :59-84): every
    conv torch's ``Conv2d`` default (kaiming-uniform with a=sqrt(5), so weight
    and bias both U(+-1/sqrt(fan_in)); JAX ``models/layers.py:26-39``), every
    BatchNorm at identity (weight 1, bias 0, mean 0, var 1); the network from
    ``seed``, RAFT from its own stream ``seed + 1``, and for training the
    Enhancer re-drawn with the reference's init from ``seed + 2``
    (``reinit_enhancer``; train.py:82-84). Each stream is a CPU
    ``torch.Generator`` walked in module order: the distributions are JAX's,
    the values are not (``jax.random`` is another generator), so the two
    packages share values only through a ``.pt``."""
    model = ZeroTIG("highest")
    net = torch.Generator().manual_seed(seed)
    for part in (model.enhance, model.denoise_1, model.denoise_2):
        init_weights(part, net)
    init_weights(model.raft, torch.Generator().manual_seed(seed + 1))
    if for_training:
        reinit_enhancer(model, torch.Generator().manual_seed(seed + 2))
    return {k: v.clone() for k, v in model.state_dict().items()}


def init_weights(model: nn.Module, key: int | torch.Generator) -> nn.Module:
    """Draw ``model``'s weights in module order from ``key`` (a seed or a CPU
    generator): every conv torch's ``Conv2d`` default, weight and bias
    uniform in +-1/sqrt(fan_in); every BatchNorm at identity."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    with torch.no_grad():
        for module in model.modules():  # a shared module once
            if isinstance(module, nn.Conv2d):
                bound = 1.0 / math.sqrt(module.weight[0].numel())
                module.weight.uniform_(-bound, bound, generator=gen)
                if module.bias is not None:
                    module.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
    return model


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
