"""Layers shared by the port's models: BatchNorm (eval and train),
InstanceNorm, convs, and the JAX package's clip.

Port of ``zero_tig_tpu/models/layers.py``. Norm statistics are f32 and
the result is cast back to the input's dtype, as the JAX package does;
train-mode BatchNorm's sums, and those of its backward, accumulate in f64
(``channel_sum``). BatchNorm eps is 1e-5 and momentum 0.1 (torch's
defaults).
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


def channel_sum(t: torch.Tensor) -> torch.Tensor:
    """The (C,) sums of an NCHW tensor, f64: each row summed in f32, the
    rows' sums in f64. A batch statistic or its cotangent is such a sum;
    the gradient that reaches the Enhancer's in_conv through the statistics
    is the small difference of large terms, so a sum that moves with the
    order of f32 additions (how rows split into bands or processes) moves
    that gradient by 1e-4 of itself. Summed so, the order barely matters.
    The rows are summed in NHWC order, the activations' channels_last
    layout: a sum over dim 3 of the NCHW view reads them C-strided, and on
    the H100 it made 1080p epoch-0 training ~55 ms a frame slower."""
    return t.float().permute(0, 2, 3, 1).sum(dim=2).sum(dim=(0, 1), dtype=torch.float64)


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor, *, one_pass: bool) -> torch.Tensor:
    """Train-mode BatchNorm2d on NCHW ``x`` with torch's semantics
    (zero_tig_tpu/models/layers.py:92-139): normalise by the batch's f32
    mean and BIASED variance over (N, H, W), and move the running
    statistics, in place, by momentum 0.1 toward the mean and the UNBIASED
    variance. ``one_pass`` (fast mode) takes var = E[x^2] - mean^2,
    as the JAX package's fast training Enhancer does
    (models/xla_fastpath.py:176-188). The sums are ``channel_sum``'s."""
    xf = x.float()
    n = x.numel() // x.shape[1]
    mean = channel_sum(xf) / n
    if one_pass:
        var = torch.clamp(channel_sum(xf * xf) / n - mean * mean, min=0.0)
    else:
        var = channel_sum(torch.square(xf - mean.float().view(1, -1, 1, 1))) / n
    mean, var = mean.float(), var.float()
    move_running_stats(bn, mean, var, n)
    return batch_norm_with(bn, x, mean, var)


@torch.no_grad()
def move_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
    """torch's running-statistics update from a batch's mean and BIASED
    variance over ``n`` values a channel: momentum 0.1, unbiased variance."""
    m = bn.momentum
    bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
    bn.running_var.copy_((1 - m) * bn.running_var + m * (var * (n / max(n - 1, 1))))


class _BatchNormWith(torch.autograd.Function):
    """``batch_norm_with`` with the statistics' and the affine parameters'
    cotangents summed by ``channel_sum``."""

    @staticmethod
    def forward(ctx, x, mean, var, weight, bias, eps):
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(var + eps) * weight.float()
        ctx.save_for_backward(x, mean, var, weight)
        ctx.eps = eps
        return ((x.float() - mean.view(shape)) * inv.view(shape) + bias.float().view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, mean, var, weight = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        g = gy.float()
        rstd = torch.rsqrt(var + ctx.eps)
        inv = rstd * weight.float()
        sg = channel_sum(g)
        sgx = channel_sum(g * (x.float() - mean.view(shape)))
        r64 = rstd.double()
        return (
            (g * inv.view(shape)).to(x.dtype),
            (-sg * inv.double()).to(mean.dtype),
            (sgx * weight.double() * -0.5 * r64 ** 3).to(var.dtype),  # d rsqrt(v + eps) / dv = -rsqrt^3 / 2
            (sgx * r64).to(weight.dtype),
            sg.to(weight.dtype),
            None,
        )


def batch_norm_with(bn: nn.BatchNorm2d, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """BatchNorm2d of NCHW ``x`` by the given f32 (C,) mean and biased
    variance, with ``bn``'s scale and shift, f32 arithmetic; the (C,)
    cotangents summed by ``channel_sum``."""
    return _BatchNormWith.apply(x, mean, var, bn.weight, bn.bias, bn.eps)


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


def conv2d_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` (stride, padding and dilation its own) on NHWC ``x`` -> NHWC,
    operands, bias and result in ``dtype``, as JAX's ``Conv`` in either mode."""
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype), bias,
                 conv.stride, conv.padding, conv.dilation)
    return y.permute(0, 2, 3, 1)
