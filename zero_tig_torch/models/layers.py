"""Layers shared by the port's models: eval BatchNorm, InstanceNorm, convs.

Port of ``zero_tig_tpu/models/layers.py`` for inference. Norm statistics are
computed in f32 and the result is cast back to the input's dtype, as the JAX
package does. BatchNorm eps is 1e-5 (torch's default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class EvalBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d on its running statistics, f32 arithmetic, NCHW."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - self.running_mean.float().view(shape)) * inv.view(shape)
        return (y + self.bias.float().view(shape)).to(x.dtype)


def instance_norm(x: torch.Tensor, *, one_pass: bool, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW, biased variance, f32 statistics.

    ``one_pass`` (fast mode) takes var = E[x^2] - mean^2 in one pass over the
    data, as zero_tig_tpu/models/layers.py:154-156; otherwise two passes."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    if one_pass:
        var = torch.clamp((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean, min=0.0)
    else:
        var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on NCHW ``x`` with operands, bias and result in ``dtype``
    (bf16 in fast mode: the library convolution sums in f32)."""
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(
        x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding
    )
