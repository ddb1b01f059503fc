"""RAFT feature and context encoders (NCHW, library convolutions).

Port of ``zero_tig_tpu/models/raft/encoder.py`` (reference
model/RAFT/extractor.py): a 7x7/s2 stem, three stages of two residual blocks
(64, 96, 128 channels; the last two stride 2) and a 1x1 head. The fnet
normalises with InstanceNorm, the cnet with eval BatchNorm. These are XLA
convolutions in the JAX package, so here they are ``F.conv2d``; RAFT is
frozen and always in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import EvalBatchNorm2d, conv2d, instance_norm


class _InstanceNorm(nn.Module):
    """Parameter-free, like the reference's InstanceNorm2d(affine=False)."""

    def forward(self, x: torch.Tensor, fast: bool) -> torch.Tensor:
        return instance_norm(x, one_pass=fast)


class _BatchNorm(EvalBatchNorm2d):
    def forward(self, x: torch.Tensor, fast: bool) -> torch.Tensor:  # noqa: ARG002
        return super().forward(x)


def _norm(norm_fn: str, planes: int) -> nn.Module:
    if norm_fn == "instance":
        return _InstanceNorm()
    if norm_fn == "batch":
        return _BatchNorm(planes)
    raise ValueError(f"unsupported norm_fn {norm_fn!r}")


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        fast = dtype == torch.bfloat16
        y = torch.relu(self.norm1(conv2d(self.conv1, x, dtype), fast))
        y = torch.relu(self.norm2(conv2d(self.conv2, y, dtype), fast))
        if self.downsample is not None:
            x = self.norm3(conv2d(self.downsample[0], x, dtype), fast)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for i, (cin, dim, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride), ResidualBlock(dim, dim, norm_fn, 1)
            ))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, 3, H, W) -> (B, output_dim, H/8, W/8) in ``dtype``."""
        fast = dtype == torch.bfloat16
        x = torch.relu(self.norm1(conv2d(self.conv1, x, dtype), fast))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, dtype)
        return conv2d(self.conv2, x, dtype)
