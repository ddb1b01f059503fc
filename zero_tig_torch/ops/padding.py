"""Centred replicate padding to multiples of 8 (RAFT's ``InputPadder``).

Port of ``zero_tig_tpu/ops/padding.py::pad8_replicate``; tensors are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad8_amounts(ht: int, wd: int) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) replicate-pad to multiples of 8, centred."""
    pad_ht = (((ht // 8) + 1) * 8 - ht) % 8
    pad_wd = (((wd // 8) + 1) * 8 - wd) % 8
    return pad_ht // 2, pad_ht - pad_ht // 2, pad_wd // 2, pad_wd - pad_wd // 2


def pad8_replicate(x: torch.Tensor) -> torch.Tensor:
    """Pad (B, H, W, C) to /8 dims with edge replication."""
    t, b, l, r = pad8_amounts(x.shape[1], x.shape[2])
    if t == b == l == r == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), mode="replicate")
    return y.permute(0, 2, 3, 1).contiguous()
