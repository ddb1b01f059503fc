"""PWC-lite: coarse-to-fine pyramid flow with warping and local cost volumes.

Port of ``zero_tig_tpu/models/pwc.py`` (:43-206; after Sun et al.,
"PWC-Net", CVPR 2018): features at 1/2..1/16 (16/32/64/96 channels), flow
estimated at 1/16 -> 1/8 -> 1/4 from a 49-channel local cost volume of the
warped second feature map, a dilated context network at the finest level,
and a x4 bilinear upsample to the padded input size.

JAX computes it with XLA convolutions and elementwise ops, outside any
Pallas kernel, so here it is library convolutions and torch ops,
differentiable, in either precision. As in JAX: the cost volume is taken in
f32 from 49 static shifts (channel mean, then LeakyReLU 0.2), the warp is
``grid_sample_pixel`` (zero outside), the flows are f32 and every conv's
operands are in the working dtype. Parameter names follow the JAX tree
(``pyramid.down0``, ``estimator2.flow``, ``context.conv1``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from ..ops.sampling import coords_grid, grid_sample_pixel
from .denoise import leaky_relu02
from .layers import conv2d_nhwc

MAX_DISP = 3  # local correlation radius -> (2*3+1)^2 = 49 cost channels
_PYR_CHANNELS = (16, 32, 64, 96)  # features at 1/2, 1/4, 1/8, 1/16
_EST_LEVELS = (3, 2, 1)  # estimate flow at 1/16, 1/8, 1/4 (pyramid indices)
_COST = (2 * MAX_DISP + 1) ** 2


def _pad16_replicate(x: torch.Tensor) -> torch.Tensor:
    """Pad (B, H, W, C) to multiples of 16, centred, edges replicated."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % 16, (-w) % 16
    if ph == 0 and pw == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), mode="replicate")
    return y.permute(0, 2, 3, 1).contiguous()


def local_correlation(f1: torch.Tensor, f2w: torch.Tensor, d: int = MAX_DISP) -> torch.Tensor:
    """(2d+1)^2-channel cost volume of NHWC maps from static shifts:
    corr[dy, dx] = mean_c f1 * shift(f2w, dy, dx), zero beyond the borders,
    then LeakyReLU 0.2; dy-major channel order."""
    h, w = f1.shape[1], f1.shape[2]
    padded = F.pad(f2w, (0, 0, d, d, d, d))
    costs = [
        torch.mean(f1 * padded[:, dy:dy + h, dx:dx + w], dim=-1)
        for dy in range(2 * d + 1) for dx in range(2 * d + 1)
    ]
    return leaky_relu02(torch.stack(costs, dim=-1))


class FeaturePyramid(nn.Module):
    """Four stride-2 stages (conv s2 + conv), channels 16/32/64/96."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, ch in enumerate(_PYR_CHANNELS):
            setattr(self, f"down{i}", nn.Conv2d(cin, ch, 3, stride=2, padding=1))
            setattr(self, f"conv{i}", nn.Conv2d(ch, ch, 3, padding=1))
            cin = ch

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
        feats = []
        for i in range(len(_PYR_CHANNELS)):
            x = leaky_relu02(conv2d_nhwc(getattr(self, f"down{i}"), x, dtype))
            x = leaky_relu02(conv2d_nhwc(getattr(self, f"conv{i}"), x, dtype))
            feats.append(x)
        return feats


class FlowEstimator(nn.Module):
    """Conv stack over [cost, features, upsampled flow] -> (flow delta, last features)."""

    def __init__(self, feat_channels: int):
        super().__init__()
        cin = _COST + feat_channels + 2
        for i, ch in enumerate((96, 64, 32)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch
        self.flow = nn.Conv2d(32, 2, 3, padding=1)

    def forward(self, cost, feat, upflow, dtype):
        x = torch.cat([cost, feat, upflow], dim=-1)
        for i in range(3):
            x = leaky_relu02(conv2d_nhwc(getattr(self, f"conv{i}"), x, dtype))
        return conv2d_nhwc(self.flow, x, dtype), x


class ContextNet(nn.Module):
    """Dilated refinement at the finest level: dilations 1, 2 and 4."""

    def __init__(self):
        super().__init__()
        cin = 32 + 2
        for i, (ch, dil) in enumerate(((64, 1), (64, 2), (32, 4))):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, 3, padding=dil, dilation=dil))
            cin = ch
        self.flow = nn.Conv2d(32, 2, 3, padding=1)

    def forward(self, x, dtype):
        for i in range(3):
            x = leaky_relu02(conv2d_nhwc(getattr(self, f"conv{i}"), x, dtype))
        return conv2d_nhwc(self.flow, x, dtype)


class PWCLite(nn.Module):
    def __init__(self):
        super().__init__()
        self.pyramid = FeaturePyramid()
        for li, level in enumerate(_EST_LEVELS):
            setattr(self, f"estimator{li}", FlowEstimator(_PYR_CHANNELS[level]))
        self.context = ContextNet()

    def flows(self, image1: torch.Tensor, image2: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
        """(B, H, W, 3) frames in [0, 1] -> the f32 flows, coarse to fine,
        each at its own level's resolution (1/16, 1/8, 1/4)."""
        f1s = self.pyramid(image1, dtype)
        f2s = self.pyramid(image2, dtype)
        out, flow = [], None
        for li, level in enumerate(_EST_LEVELS):
            f1, f2 = f1s[level], f2s[level]
            b, h, w, _ = f1.shape
            if flow is None:
                upflow = f1.new_zeros(b, h, w, 2, dtype=torch.float32)
                f2w = f2
            else:
                upflow = 2.0 * resize_bilinear(flow, (h, w), align_corners=False)
                tgt = coords_grid(b, h, w, device=f1.device) + upflow
                f2w = grid_sample_pixel(f2, tgt[..., 0], tgt[..., 1]).to(f2.dtype)
            cost = local_correlation(f1.float(), f2w.float())
            delta, est = getattr(self, f"estimator{li}")(cost.to(dtype), f1, upflow.to(dtype), dtype)
            flow = upflow + delta.float()
            if li == len(_EST_LEVELS) - 1:
                flow = flow + self.context(torch.cat([est, flow.to(dtype)], dim=-1), dtype).float()
            out.append(flow)
        return out

    def forward(
        self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 1, *,
        return_predictions: bool = False, dtype: torch.dtype = torch.float32,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(flow_low, flow_up) between (B, H, W, 3) frames in [0, 255], the
        flow at the /16-padded size; ``iters`` is ignored (PWC is
        feed-forward). With ``return_predictions``, (flow_low, (3, B, H, W, 2)):
        every level's flow upsampled to the padded size, coarse to fine,
        each scaled by the ratio of the heights."""
        del iters
        image1 = _pad16_replicate(image1) / 255.0
        image2 = _pad16_replicate(image2) / 255.0
        flows = self.flows(image1, image2, dtype)
        flow_low = flows[-1]
        h, w = image1.shape[1], image1.shape[2]
        if return_predictions:
            ups = [(h / f.shape[1]) * resize_bilinear(f, (h, w), align_corners=False) for f in flows]
            return flow_low, torch.stack(ups)
        return flow_low, 4.0 * resize_bilinear(flow_low, (4 * flow_low.shape[1], 4 * flow_low.shape[2]))
