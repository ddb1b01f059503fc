"""RAFT optical flow at the pipeline's operating point.

Port of ``zero_tig_tpu/models/raft/raft.py`` (reference model/RAFT/raft.py):
corr_levels=4, corr_radius=4, hidden=context=128, frozen, eval mode. Both
images are replicate-padded to multiples of 8, mapped to [-1, 1] and go
through the fnet as one batch; the refinement iterations are a Python loop
whose core is K2 (``update.update_core``); the mask head runs once, after
the loop, and the convex upsample gives the flow at the PADDED size (the
reference never unpads; the warp absorbs the padded shape).

``return_predictions=True`` is the training path (JAX :75-166): every
iteration's convex-upsampled flow, differentiable, on the plain modules
(``BasicUpdateBlock.forward``: library convolutions, no K1 and no GRU
kernel), ``coords1`` detached at the top of each iteration and the mask head
run each iteration. The cnet's BatchNorm stays on its running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core import spans
from ...ops.padding import pad8_replicate
from ...ops.sampling import coords_grid
from .corr import build_corr_pyramid, lookup_corr
from .encoder import BasicEncoder
from .update import BasicUpdateBlock, update_core

CORR_LEVELS = 4
CORR_RADIUS = 4
HIDDEN_DIM = 128


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x8 convex-combination upsample. flow (B, h, w, 2) f32; mask
    (B, h, w, 576) logits -> (B, 8h, 8w, 2) f32. Parity: raft.py:52-72."""
    b, h, w, _ = flow.shape
    m = mask.float().reshape(b, h, w, 9, 8, 8).softmax(dim=3)
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    nb = torch.stack(
        [fp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)], dim=3
    )  # (B, h, w, 9, 2), kernel position row-major as F.unfold
    up = torch.einsum("bhwkij,bhwkc->bhwijc", m, nb)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(2 * HIDDEN_DIM, "batch")
        self.update_block = BasicUpdateBlock(HIDDEN_DIM)

    def prepare(self, dtype: torch.dtype) -> None:
        self.update_block.prepare(dtype)

    def forward(
        self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12, *,
        return_predictions: bool = False, dtype: torch.dtype | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(flow_low, flow_up) between (B, H, W, 3) frames in [0, 255]; with
        ``return_predictions``, (flow_low, (iters, B, 8h, 8w, 2) flows).
        ``dtype``: the training path's working dtype (the inference path
        takes the one ``prepare`` set)."""
        with spans.span("zt.raft"):
            ub = self.update_block
            dtype = ub.dtype if dtype is None else dtype
            image1 = 2.0 * (pad8_replicate(image1) / 255.0) - 1.0
            image2 = 2.0 * (pad8_replicate(image2) / 255.0) - 1.0
            b = image1.shape[0]
            pair = torch.cat([image1.float(), image2.float()]).permute(0, 3, 1, 2)
            fmaps = self.fnet(pair, dtype).permute(0, 2, 3, 1)
            levels = build_corr_pyramid(fmaps[:b], fmaps[b:], CORR_LEVELS, dtype)

            cnet = self.cnet(image1.permute(0, 3, 1, 2), dtype).permute(0, 2, 3, 1)
            net = torch.tanh(cnet[..., :HIDDEN_DIM]).contiguous()
            inp = torch.relu(cnet[..., HIDDEN_DIM:]).contiguous()

            h8, w8 = net.shape[1], net.shape[2]
            coords0 = coords_grid(b, h8, w8, device=net.device)
            coords1 = coords0
            if return_predictions:
                ups = []
                for _ in range(iters):
                    coords1 = coords1.detach()
                    corr = lookup_corr(levels, coords1, CORR_RADIUS)
                    net, mask, delta = ub(net, inp, corr, coords1 - coords0, dtype)
                    coords1 = coords1 + delta.float()
                    ups.append(convex_upsample_flow(coords1 - coords0, mask))
                return coords1 - coords0, torch.stack(ups)
            for _ in range(iters):
                corr = lookup_corr(levels, coords1, CORR_RADIUS)
                flow = coords1 - coords0
                net, delta = update_core(ub.kw, net, inp, corr, ub.flow_features(flow), flow)
                coords1 = coords1 + delta
            flow_low = coords1 - coords0
            return flow_low, convex_upsample_flow(flow_low, ub.mask_head(net))
