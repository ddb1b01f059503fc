"""Layers shared by the port's models: BatchNorm (eval and train),
InstanceNorm, convs, and the JAX package's clip.

Port of ``zero_tig_tpu/models/layers.py``. Norm statistics are computed in
f32 and the result is cast back to the input's dtype, as the JAX package
does. BatchNorm eps is 1e-5 and momentum 0.1 (torch's defaults).
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


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor, *, one_pass: bool) -> torch.Tensor:
    """Train-mode BatchNorm2d on NCHW ``x`` with torch's semantics
    (zero_tig_tpu/models/layers.py:92-139): normalise by the batch's f32
    mean and BIASED variance over (N, H, W), and move the running
    statistics, in place, by momentum 0.1 toward the mean and the UNBIASED
    variance. ``one_pass`` (fast mode) takes var = E[x^2] - mean^2,
    as the JAX package's fast training Enhancer does
    (models/xla_fastpath.py:176-188)."""
    shape = (1, -1, 1, 1)
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    if one_pass:
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    else:
        var = ((xf - mean.view(shape)) ** 2).mean(dim=(0, 2, 3))
    move_running_stats(bn, mean, var, x.numel() // x.shape[1])
    return batch_norm_with(bn, x, mean, var)


@torch.no_grad()
def move_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
    """torch's running-statistics update from a batch's mean and BIASED
    variance over ``n`` values a channel: momentum 0.1, unbiased variance."""
    m = bn.momentum
    bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
    bn.running_var.copy_((1 - m) * bn.running_var + m * (var * (n / max(n - 1, 1))))


def batch_norm_with(bn: nn.BatchNorm2d, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """BatchNorm2d of NCHW ``x`` by the given f32 (C,) mean and biased
    variance, with ``bn``'s scale and shift, f32 arithmetic."""
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(var + bn.eps) * bn.weight.float()
    return ((x.float() - mean.view(shape)) * inv.view(shape) + bn.bias.float().view(shape)).to(x.dtype)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), whose gradient at an exact tie with
    a bound is split in half, as JAX's (``torch.clamp`` passes all of it).
    bf16 values land on 1e-4 and 1.0 often enough for this to matter."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


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
