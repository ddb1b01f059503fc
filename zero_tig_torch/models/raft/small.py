"""Small-RAFT: the reference's compact flow-model configuration.

Port of ``zero_tig_tpu/models/raft/small.py`` (:1-237; reference
model/RAFT/extractor.py:59-115 BottleneckBlock, :194-266 SmallEncoder;
model/RAFT/update.py:16-47, :99-112):

    fnet   = SmallEncoder(output_dim=128, norm='instance')
    cnet   = SmallEncoder(output_dim=96+64, norm='none')
    update = SmallUpdateBlock(hidden_dim=96), corr levels 4, radius 3,
    no convex-upsample mask: the final x8 upsample is bilinear (``upflow8``).

JAX computes it with XLA convolutions outside any Pallas kernel, so here it
runs on library convolutions (``F.conv2d``), differentiable, in either
precision: conv operands in the working dtype (bf16 in fast mode), f32
sums; the dtypes follow JAX's promotions (the flow and the concatenations
holding it f32). The correlation pyramid and lookup are RAFT's
(``corr.py``), the lookup its differentiable twin. Parameter names are the reference's (``fnet.layer1.0.conv1``,
``update_block.gru.convz``, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.padding import pad8_replicate
from ...ops.resize import upflow8
from ...ops.sampling import coords_grid
from ..layers import conv2d_nhwc, instance_norm
from .corr import build_corr_pyramid, lookup_corr_reference
from .update import FlowHead

CORR_LEVELS = 4
CORR_RADIUS = 3
HIDDEN_DIM = 96
CONTEXT_DIM = 64


def _norm(x: torch.Tensor, norm_fn: str, dtype: torch.dtype) -> torch.Tensor:
    """'instance' (parameter-free, one pass in fast mode) or 'none', on NHWC."""
    if norm_fn == "instance":
        return instance_norm(x.permute(0, 3, 1, 2), one_pass=dtype == torch.bfloat16).permute(0, 2, 3, 1)
    if norm_fn == "none":
        return x
    raise ValueError(f"unsupported norm_fn {norm_fn!r}")


class BottleneckBlock(nn.Module):
    """1x1 down / 3x3 (strided) / 1x1 up residual bottleneck (extractor.py:59-115)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        q = planes // 4
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(in_planes, q, 1)
        self.conv2 = nn.Conv2d(q, q, 3, padding=1, stride=stride)
        self.conv3 = nn.Conv2d(q, planes, 1)
        # the reference's Sequential(conv, norm4); its norms have no parameters
        self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride)) if stride != 1 else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n = self.norm_fn
        y = torch.relu(_norm(conv2d_nhwc(self.conv1, x, dtype), n, dtype))
        y = torch.relu(_norm(conv2d_nhwc(self.conv2, y, dtype), n, dtype))
        y = torch.relu(_norm(conv2d_nhwc(self.conv3, y, dtype), n, dtype))
        if self.downsample is not None:
            x = _norm(conv2d_nhwc(self.downsample[0], x, dtype), n, dtype)
        return torch.relu(x + y)


class SmallEncoder(nn.Module):
    """7x7/s2 stem (32 channels), three stages of 2 bottlenecks (32/64/96,
    the last two stride 2) and a 1x1 head (extractor.py:194-266)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance"):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(3, 32, 7, stride=2, padding=3)
        cin = 32
        for i, (dim, stride) in enumerate(((32, 1), (64, 2), (96, 2)), start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                BottleneckBlock(cin, dim, norm_fn, stride), BottleneckBlock(dim, dim, norm_fn, 1)
            ))
            cin = dim
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/8, W/8, output_dim) in ``dtype``."""
        x = torch.relu(_norm(conv2d_nhwc(self.conv1, x, dtype), self.norm_fn, dtype))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, dtype)
        return conv2d_nhwc(self.conv2, x, dtype)


class SmallMotionEncoder(nn.Module):
    """196 correlation channels and the flow -> 82 channels (update.py:16-31)."""

    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        cor = torch.relu(conv2d_nhwc(self.convc1, corr, dtype))
        flo = torch.relu(conv2d_nhwc(self.convf1, flow, dtype))
        flo = torch.relu(conv2d_nhwc(self.convf2, flo, dtype))
        out = torch.relu(conv2d_nhwc(self.conv, torch.cat([cor, flo], -1), dtype))
        return torch.cat([out.float(), flow.float()], -1)


class ConvGRU(nn.Module):
    """3x3 gated conv GRU (update.py:33-47)."""

    def __init__(self, hidden_dim: int = HIDDEN_DIM, input_dim: int = 82 + CONTEXT_DIM):
        super().__init__()
        for gate in "zrq":
            setattr(self, f"conv{gate}", nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1))

    def forward(self, h: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        hx = torch.cat([h.float(), x], -1)
        z = torch.sigmoid(conv2d_nhwc(self.convz, hx, dtype))
        r = torch.sigmoid(conv2d_nhwc(self.convr, hx, dtype))
        q = torch.tanh(conv2d_nhwc(self.convq, torch.cat([(r * h).float(), x], -1), dtype))
        return (1 - z) * h + z * q


class SmallUpdateBlock(nn.Module):
    """Motion encoder, GRU and flow head, no mask head (update.py:99-112)."""

    def __init__(self, hidden_dim: int = HIDDEN_DIM):
        super().__init__()
        self.encoder = SmallMotionEncoder()
        self.gru = ConvGRU(hidden_dim, 82 + CONTEXT_DIM)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow, dtype):
        motion = self.encoder(flow, corr, dtype)
        net = self.gru(net, torch.cat([inp.float(), motion], -1), dtype)
        fh = self.flow_head
        delta = conv2d_nhwc(fh.conv2, torch.relu(conv2d_nhwc(fh.conv1, net, dtype)), dtype)
        return net, delta


class RAFTSmall(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = SmallEncoder(128, "instance")
        self.cnet = SmallEncoder(HIDDEN_DIM + CONTEXT_DIM, "none")
        self.update_block = SmallUpdateBlock(HIDDEN_DIM)

    def forward(
        self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12, *,
        return_predictions: bool = False, dtype: torch.dtype = torch.float32,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(flow_low, flow_up) between (B, H, W, 3) frames in [0, 255], flow
        at the /8-padded size; with ``return_predictions``, (flow_low,
        (iters, B, H, W, 2) upsampled flows), ``coords1`` detached each
        iteration as RAFT's."""
        image1 = 2.0 * (pad8_replicate(image1) / 255.0) - 1.0
        image2 = 2.0 * (pad8_replicate(image2) / 255.0) - 1.0
        b = image1.shape[0]
        fmaps = self.fnet(torch.cat([image1, image2]), dtype)
        levels = build_corr_pyramid(fmaps[:b].float(), fmaps[b:].float(), CORR_LEVELS, dtype)
        cnet = self.cnet(image1, dtype)
        net = torch.tanh(cnet[..., :HIDDEN_DIM])
        inp = torch.relu(cnet[..., HIDDEN_DIM:])

        coords0 = coords_grid(b, net.shape[1], net.shape[2], device=net.device)
        coords1 = coords0
        ys = []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = lookup_corr_reference(levels, coords1, CORR_RADIUS)  # differentiable
            net, delta = self.update_block(net, inp, corr, coords1 - coords0, dtype)
            coords1 = coords1 + delta.float()
            if return_predictions:
                ys.append(upflow8(coords1 - coords0))
        flow_low = coords1 - coords0
        if return_predictions:
            return flow_low, torch.stack(ys)
        return flow_low, upflow8(flow_low)
