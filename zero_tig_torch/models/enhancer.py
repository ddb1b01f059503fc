"""The Retinex illumination estimator, five K1 launches.

Port of ``zero_tig_tpu/models/enhancer.py`` with eval BatchNorm: in_conv
9->64 relu; ONE shared conv+BN+relu block applied 3 times with a residual
(the reference appends the same module three times, model/model.py:60-67,
so ``blocks.{0,1,2}`` and ``conv`` name one set of weights); out_conv 64->3,
sigmoid, clip to [1e-4, 1]. The BatchNorm folds into K1's scale and shift
(zero_tig_tpu/models/fastpath.py:150-162); the 9-channel input concat is
done inside the first launch. Training differentiates ``train_forward``
instead, with train-mode or eval BatchNorm.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.fused_conv import fused_conv, prepare_conv
from .layers import EvalBatchNorm2d, batch_norm_train, batch_norm_with, clip, conv2d, kernel_operands


class Enhancer(nn.Module):
    def __init__(self, layers: int = 3, channels: int = 64):
        super().__init__()
        self.in_conv = nn.Sequential(nn.Conv2d(9, channels, 3, padding=1), nn.ReLU())
        self.conv = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1), EvalBatchNorm2d(channels), nn.ReLU()
        )
        self.blocks = nn.ModuleList([self.conv] * layers)
        self.out_conv = nn.Sequential(nn.Conv2d(channels, 3, 3, padding=1), nn.Sigmoid())
        self.kw: dict | None = None

    def prepare(self, dtype: torch.dtype) -> dict:
        return kernel_operands(self, dtype, self._operands)

    def _operands(self, dtype: torch.dtype) -> dict:
        return {
            "in": prepare_conv(self.in_conv[0], dtype),
            "block": prepare_conv(self.conv[0], dtype, bn=self.conv[1]),
            "out": prepare_conv(self.out_conv[0], dtype),
        }

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Illumination s2 (B, H, W, 3) from NHWC parts concatenating to 9 channels."""
        fea = fused_conv(parts, self.kw["in"], act="relu")
        for _ in self.blocks:
            fea = fused_conv([fea], self.kw["block"], act="relu", residual=fea)
        return fused_conv([fea], self.kw["out"], act="sigmoid_clip")

    def train_forward(
        self, x: torch.Tensor, dtype: torch.dtype, *, bn_train: bool, stats: list | None = None
    ) -> torch.Tensor:
        """s2 from NHWC ``x`` (9 channels) under autograd, operands and
        activations in ``dtype``. The shared block's gradient sums over its
        three uses. ``bn_train``: batch statistics, and the running statistics
        move three times (once per use, as in torch and JAX); otherwise the
        running statistics normalise and stay. ``stats``, three (mean, var)
        pairs, one per use, normalise instead, and nothing moves (banded
        training supplies the full frame's batch statistics so)."""
        conv, bn = self.conv[0], self.conv[1]
        fea = torch.relu(conv2d(self.in_conv[0], x.permute(0, 3, 1, 2), dtype))
        for i, _ in enumerate(self.blocks):
            y = conv2d(conv, fea, dtype)
            if stats is not None:
                y = batch_norm_with(bn, y, *stats[i])
            elif bn_train:
                y = batch_norm_train(bn, y, one_pass=dtype == torch.bfloat16)
            else:
                y = bn(y)
            fea = fea + torch.relu(y)
        s2 = clip(torch.sigmoid(conv2d(self.out_conv[0], fea, dtype)), 1e-4, 1.0)
        return s2.permute(0, 2, 3, 1)
