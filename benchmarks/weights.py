"""Seeded Zero-TIG weights, drawn on the device in two calls.

Every conv uniform in +-1/sqrt(fan_in) (torch's ``Conv2d`` bound, weight and
bias); every BatchNorm's affine and running statistics near identity
(weight U(0.9, 1.1), bias and running mean U(-0.1, 0.1), running variance
U(0.5, 1.5)), so that a fold of the statistics into a kernel is exercised.
``for_training`` re-draws the Enhancer as the published trainer does
(model/model.py:123-130, train.py:82-84): conv weights N(0, 0.02), biases 0,
BatchNorm scale N(1, 0.02); its running statistics stay.
"""

from __future__ import annotations

import math

import torch

from reference.params import PARAMS, full_state

_RANGES = {"bn_w": (0.9, 1.1), "bn_b": (-0.1, 0.1), "bn_mean": (-0.1, 0.1), "bn_var": (0.5, 1.5)}


def make_state(seed: int, device, *, for_training: bool = False) -> dict[str, torch.Tensor]:
    """A state dict under the published names (aliases included), float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in PARAMS]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, shape, kind), n in zip(PARAMS, sizes):
        v = u[off:off + n].reshape(shape)
        off += n
        if kind in ("conv_w", "conv_b"):
            w_shape = shape if kind == "conv_w" else next(s for k, s, _ in PARAMS if k == key[:-4] + "weight")
            bound = 1.0 / math.sqrt(math.prod(w_shape[1:]))
            out[key] = (2.0 * v - 1.0) * bound
        else:
            lo, hi = _RANGES[kind]
            out[key] = lo + (hi - lo) * v
    if for_training:
        enh = [(k, s, kind) for k, s, kind in PARAMS if k.startswith("enhance.") and kind in ("conv_w", "conv_b", "bn_w", "bn_b")]
        noise = torch.randn(sum(math.prod(s) for _, s, _ in enh), generator=gen, device=device)
        off = 0
        for key, shape, kind in enh:
            n = math.prod(shape)
            z = noise[off:off + n].reshape(shape)
            off += n
            out[key] = {"conv_w": 0.02 * z, "bn_w": 1.0 + 0.02 * z}.get(kind, torch.zeros_like(z))
    return full_state({k: v.contiguous() for k, v in out.items()})
