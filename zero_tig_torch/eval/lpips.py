"""LPIPS (VGG16) perceptual distance.

Port of ``zero_tig_tpu/eval/lpips.py`` (:1-215; reference evals.py:73-89,
``lpips.LPIPS(net='vgg')``): inputs in [-1, 1] shifted and scaled by the
published constants, VGG16 features after relu1_2 / relu2_2 / relu3_3 /
relu4_3 / relu5_3, unit-normalised over channels, squared differences, the
five learned 1x1 linear heads, a spatial mean, summed over the layers.

No weights ship with the repository and none are fetched. Scoring reads the
JAX package's ``lpips_weights.npz`` format (:11-18): ``conv{i}_w`` (HWIO)
and ``conv{i}_b`` for the 13 VGG convs, ``lin{j}_w`` (1, 1, C, 1) for the
five heads; the kernels turn to OIHW at load. ``LPIPSScorer.maybe_load(None)``
is None, and evals then reports LPIPS as null. The VGG convolutions are
library convolutions, as in the JAX package (its ``ops/convs.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.precision import numerics

# VGG16 conv plan: out channels, "M" = 2x2 max pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)  # the convs whose relu output is scored
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def load_weights(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """An ``lpips_weights.npz`` -> conv and head kernels in OIHW, biases."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            a = z[k]
            out[k] = torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)).float()
    return out


def lpips_distance(weights: dict[str, torch.Tensor], img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """LPIPS between two (B, H, W, 3) images in [-1, 1] -> (B,). ``weights``
    as ``load_weights`` gives them (OIHW)."""
    shift = img1.new_tensor(_SHIFT).view(1, 3, 1, 1)
    scale = img1.new_tensor(_SCALE).view(1, 3, 1, 1)

    def features(x):
        x = (x.permute(0, 3, 1, 2) - shift) / scale
        feats, conv_i = [], 0
        for spec in _VGG_CFG:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = torch.relu(F.conv2d(x, weights[f"conv{conv_i}_w"], weights[f"conv{conv_i}_b"], padding=1))
            if conv_i in _TAPS:
                feats.append(x)
            conv_i += 1
        return feats

    total = img1.new_zeros(img1.shape[0])
    for j, (a, b) in enumerate(zip(features(img1), features(img2))):
        a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
        total = total + F.conv2d((a - b) ** 2, weights[f"lin{j}_w"]).mean(dim=(1, 2, 3))
    return total


class LPIPS(nn.Module):
    """The scorer's network: the weights as buffers, ``lpips_distance`` as
    its forward."""

    def __init__(self, weights: dict[str, torch.Tensor]):
        super().__init__()
        for k, v in weights.items():
            self.register_buffer(k, v)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return lpips_distance(dict(self.named_buffers()), img1, img2)


class LPIPSScorer:
    """Callable (out01, gt01) -> distance on (H, W, 3) float images in [0, 1]."""

    def __init__(self, weights_path: str | os.PathLike, device=None):
        self.device = resolve_device(device)
        self.net = LPIPS(load_weights(weights_path)).to(self.device).eval()

    @classmethod
    def maybe_load(cls, path: str | None, device=None) -> "LPIPSScorer | None":
        if path and os.path.exists(path):
            return cls(path, device)
        return None

    @torch.no_grad()
    def __call__(self, out01: np.ndarray, gt01: np.ndarray) -> float:
        # the reference's cvt_array2tensor: (x - 0.5) * 2 (evals.py:92-98)
        a = torch.as_tensor((np.asarray(out01, np.float32)[None] - 0.5) * 2.0, device=self.device)
        b = torch.as_tensor((np.asarray(gt01, np.float32)[None] - 0.5) * 2.0, device=self.device)
        with numerics("highest"):  # f32 convolutions, not TF32, on a card
            return float(self.net(a, b)[0])
