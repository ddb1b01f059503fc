"""The two Neighbor2Neighbor-style denoisers, each three K1 launches.

Port of ``zero_tig_tpu/models/denoise.py`` (Denoise_1 3->48->48->3, Denoise_2
12->48->48->6 with chan_embed=48, LeakyReLU 0.2, 1x1 output conv) on the
fused path of ``zero_tig_tpu/models/fastpath.py``: the residual prediction
and the clamp of its caller fuse into the last layer's epilogue,

    out = clip(anchor - Denoise(cat(parts)), 1e-4, 1)

so neither the input concat nor the anchor concat is written to memory.
Training differentiates ``train_forward`` instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.fused_conv import fused_conv, prepare_conv
from .layers import conv2d

EPS = 1e-4


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) as ``jnp.where(x >= 0, x, 0.2 * x)``."""
    return torch.where(x >= 0, x, 0.2 * x)


class Denoise(nn.Module):
    def __init__(self, cin: int, cout: int, chan_embed: int = 48):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, chan_embed, 3, padding=1)
        self.conv2 = nn.Conv2d(chan_embed, chan_embed, 3, padding=1)
        self.conv3 = nn.Conv2d(chan_embed, cout, 1)
        self.kw: dict | None = None

    def prepare(self, dtype: torch.dtype) -> None:
        self.kw = {n: prepare_conv(getattr(self, n), dtype) for n in ("conv1", "conv2", "conv3")}

    def forward(self, parts: Sequence[torch.Tensor], anchor: Sequence[torch.Tensor]) -> torch.Tensor:
        """clip(cat(anchor) - Denoise(cat(parts)), 1e-4, 1) on NHWC tensors."""
        x = fused_conv(parts, self.kw["conv1"], act="leaky")
        x = fused_conv([x], self.kw["conv2"], act="leaky")
        return fused_conv([x], self.kw["conv3"], anchor=anchor, lo=EPS, hi=1.0)

    def train_forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The residual Denoise(x) on NHWC ``x`` under autograd: library
        convolutions on the module's own parameters with operands and
        activations in ``dtype`` (the training counterpart of the XLA convs
        the JAX package differentiates)."""
        x = x.permute(0, 3, 1, 2)
        x = leaky_relu02(conv2d(self.conv1, x, dtype))
        x = leaky_relu02(conv2d(self.conv2, x, dtype))
        return conv2d(self.conv3, x, dtype).permute(0, 2, 3, 1)


def Denoise1(chan_embed: int = 48) -> Denoise:
    return Denoise(3, 3, chan_embed)


def Denoise2(chan_embed: int = 48) -> Denoise:
    return Denoise(12, 6, chan_embed)
