"""RAFT's published Sintel evaluation in plain PyTorch, for the benchmark's
flow-sequence cells: princeton-vl/RAFT ``evaluate.py::create_sintel_submission``
with ``--warm_start`` (Teed & Deng, arXiv:2003.12039).

It builds on the frozen RAFT of ``model.py`` (encoders, correlation pyramid
and lookup, update block, convex upsample; ``F.conv2d``, float32, TF32 off)
and adds what the published evaluation has besides: ``flow_init`` added to
``coords1`` before the first iteration (``core/raft.py``), the centred
replicate padding and its cut back (``InputPadder`` in Sintel mode), and the
forward interpolation of the last pair's 1/8 flow
(``core/utils/utils.py::forward_interpolate``: scipy's nearest
``griddata`` over the points moved strictly inside the grid, here a plain
nearest search in float64, the lower index on an exact tie). It takes the
benchmark's state dict (the ``raft.*`` keys are RAFT's) and nothing of the
program under test.
"""

from __future__ import annotations

import torch

from . import ops
from .model import ZeroTIGReference
from .ops import exact_f32
from .params import CONTEXT, CORR_LEVELS, CORR_RADIUS, FNET_DIM, HIDDEN

ROWS = 1024  # grid points a block of the forward interpolation's distances
RAFT_WIDTHS = {"raft_hidden": HIDDEN, "raft_context": CONTEXT, "raft_fnet_dim": FNET_DIM,
               "corr_levels": CORR_LEVELS, "corr_radius": CORR_RADIUS}


def check_raft_widths(config: dict) -> None:
    """A configuration's RAFT widths must be the published ones: neither side runs others."""
    wrong = {k: config.get(k) for k, v in RAFT_WIDTHS.items() if config.get(k) != v}
    if wrong:
        raise ValueError(f"{config.get('name')}: widths {wrong} differ from RAFT's {RAFT_WIDTHS}")


def unpad8(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """InputPadder.unpad: (..., H8, W8) padded by ``ops.pad8`` cut back to h x w."""
    ph, pw = x.shape[-2] - h, x.shape[-1] - w
    return x[..., ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]


def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """(B, 2, h, w) flow -> (B, 2, h, w) f32: each grid point takes the flow
    of the nearest point moved strictly inside the grid (zeros where none
    is), ``ROWS`` grid points at a time."""
    b, _, h, w = flow.shape
    out = torch.zeros(b, 2, h * w, device=flow.device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=flow.device),
                            torch.arange(w, dtype=torch.float64, device=flow.device), indexing="ij")
    gx, gy = xs.reshape(-1), ys.reshape(-1)
    for i in range(b):
        f = flow[i].float().reshape(2, -1)
        x1, y1 = gx + f[0].double(), gy + f[1].double()
        valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
        if not bool(valid.any()):
            continue
        px, py, vals = x1[valid], y1[valid], f[:, valid]
        for s in range(0, h * w, ROWS):
            d2 = (gx[s:s + ROWS, None] - px) ** 2 + (gy[s:s + ROWS, None] - py) ** 2
            out[i, :, s:s + ROWS] = vals[:, d2.argmin(1)]
    return out.reshape(b, 2, h, w)


class RAFTSintelReference(ZeroTIGReference):
    """The reference's RAFT with a warm start. ``operands`` as for
    ``ZeroTIGReference``: "f32", or "tf32" for the check's control."""

    @torch.no_grad()
    def pair(self, frame1: torch.Tensor, frame2: torch.Tensor, iters: int, flow_init: torch.Tensor | None = None):
        """(flow_low (B, 2, H8/8, W8/8), flow (B, 2, h, w)) between (B, 3, h, w)
        frames in [0, 255]: RAFT.forward(..., flow_init, test_mode=True) on the
        padded frames, and the flow cut back to the frames' size."""
        h, w = frame1.shape[-2:]
        with exact_f32():
            im1 = 2.0 * (ops.pad8(frame1) / 255.0) - 1.0
            im2 = 2.0 * (ops.pad8(frame2) / 255.0) - 1.0
            b = im1.shape[0]
            fmaps = self.encoder("raft.fnet", torch.cat([im1, im2]), instance=True)
            levels = self.corr_pyramid(fmaps[:b], fmaps[b:])
            cnet = self.encoder("raft.cnet", im1, instance=False)
            net, inp = torch.tanh(cnet[:, :HIDDEN]), torch.relu(cnet[:, HIDDEN:])
            coords0 = ops.coords_grid(b, net.shape[2], net.shape[3], net.device)
            coords1 = coords0 if flow_init is None else coords0 + flow_init
            for _ in range(iters):
                net, delta = self.update(net, inp, self.lookup(levels, coords1), coords1 - coords0)
                coords1 = coords1 + delta
            pre = "raft.update_block.mask"
            mask = 0.25 * self.conv(torch.relu(self.conv(net, f"{pre}.0", padding=1)), f"{pre}.2")
            low = coords1 - coords0
            return low, unpad8(self.convex_upsample(low, mask), h, w)
