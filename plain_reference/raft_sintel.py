"""RAFT's published Sintel evaluation in plain PyTorch: the warm-started
sequence of ``evaluate.py::create_sintel_submission`` (princeton-vl/RAFT;
Teed & Deng, arXiv:2003.12039).

Float32, NCHW, on ``F.conv2d`` and torch operations, with TF32 off for
matrix products and cuDNN while it computes. It imports nothing of the port
and no JAX: the port's flow path (``zero_tig_torch/flowtools/sequence.py``)
is held against it.

- ``RAFTReference.forward``: ``core/raft.py::RAFT.forward(image1, image2,
  iters, flow_init, test_mode=True)``: the feature encoder (instance norm) on
  both images, the context encoder (eval batch norm) split into hidden and
  context, the all-pairs correlation pyramid (``core/corr.py::CorrBlock``,
  4 levels) looked up at radius 4 with ``F.grid_sample`` (its
  ``bilinear_sampler``, window position (i, j) sampling (x + d[i], y + d[j])),
  ``coords1 = coords0 + flow_init``, the ``BasicUpdateBlock`` iterations and
  the convex upsample. Returns (flow_low, flow_up).
- ``pad8`` / ``unpad8``: ``core/utils/utils.py::InputPadder`` in Sintel mode
  (centred replicate padding to multiples of 8, and the cut back).
- ``forward_interpolate``: ``core/utils/utils.py::forward_interpolate``, the
  scipy ``griddata(method="nearest")`` over the points the flow moves
  strictly inside the frame, as a plain nearest search in float64.
- ``sintel_sequence``: the submission's loop over one dataset's frames.

Departures from the published code:

- it takes a state dict under the port's key names, which are the
  published module names without DataParallel's ``module.`` prefix;
- the mask head runs once, after the last iteration, where the published
  loop runs it every iteration and keeps the last (the same flow_up);
- frames are tensors in memory, not files, and ``sintel_sequence`` returns
  the flows instead of writing them;
- ``forward_interpolate`` takes and returns torch tensors (B, 2, h, w);
  where two sources lie at exactly the same distance from a grid point it
  takes the lower index, where scipy's k-d tree takes the first it visits;
- every correlation level has to be at least 2 pixels on each side (the
  published normalisation divides by the side minus one): frames of at
  least 128 x 128 after padding.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

HIDDEN = CONTEXT = 128
CORR_LEVELS, CORR_RADIUS = 4, 4


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and matrix products inside the block; restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _pad_amounts(h: int, w: int) -> list[int]:
    ph, pw = (((h // 8) + 1) * 8 - h) % 8, (((w // 8) + 1) * 8 - w) % 8
    return [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2]


def pad8(x: torch.Tensor) -> torch.Tensor:
    """InputPadder(mode="sintel").pad: (B, C, H, W) replicate-padded, centred, to multiples of 8."""
    return F.pad(x, _pad_amounts(*x.shape[-2:]), mode="replicate")


def unpad8(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """InputPadder.unpad for frames of h x w: the padded map cut back to them."""
    left, _, top, _ = _pad_amounts(h, w)
    return x[..., top:top + h, left:left + w]


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys]).float()[None].repeat(b, 1, 1, 1)


def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """(B, 2, h, w) flow -> (B, 2, h, w) float32: every grid point takes the
    flow of the nearest point that lands strictly inside the grid, zeros
    where none does."""
    out = torch.zeros(flow.shape, dtype=torch.float32, device=flow.device)
    b, _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=flow.device),
                            torch.arange(w, dtype=torch.float64, device=flow.device), indexing="ij")
    for i in range(b):
        dx, dy = flow[i, 0].float(), flow[i, 1].float()
        x1, y1 = xs + dx.double(), ys + dy.double()
        valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
        if not bool(valid.any()):
            continue
        px, py = x1[valid], y1[valid]
        d2 = (xs.reshape(-1, 1) - px) ** 2 + (ys.reshape(-1, 1) - py) ** 2
        nearest = d2.argmin(1)
        out[i, 0] = dx[valid][nearest].reshape(h, w)
        out[i, 1] = dy[valid][nearest].reshape(h, w)
    return out


class RAFTReference:
    """RAFT on a state dict (the port's key names), float32 on ``device``."""

    def __init__(self, state: dict, device=None):
        self.p = {k: v.detach().to(device=device, dtype=torch.float32).clone()
                  for k, v in state.items() if not k.endswith("num_batches_tracked")}

    def conv(self, x, key, stride=1, padding=0):
        return F.conv2d(x, self.p[key + ".weight"], self.p[key + ".bias"], stride, padding)

    def norm(self, key, x, instance: bool):
        if instance:
            return F.instance_norm(x, eps=1e-5)
        p = self.p
        return F.batch_norm(x, p[key + ".running_mean"], p[key + ".running_var"], p[key + ".weight"],
                            p[key + ".bias"], training=False, eps=1e-5)

    def encoder(self, pre, x, instance: bool):
        """core/extractor.py::BasicEncoder: 7x7/2 stem, 3 stages of 2 residual blocks, 1x1 head."""
        x = torch.relu(self.norm(f"{pre}.norm1", self.conv(x, f"{pre}.conv1", 2, 3), instance))
        for i, stride in ((1, 1), (2, 2), (3, 2)):
            for j in range(2):
                blk, s = f"{pre}.layer{i}.{j}", stride if j == 0 else 1
                y = torch.relu(self.norm(f"{blk}.norm1", self.conv(x, f"{blk}.conv1", s, 1), instance))
                y = torch.relu(self.norm(f"{blk}.norm2", self.conv(y, f"{blk}.conv2", 1, 1), instance))
                if s != 1:
                    x = self.norm(f"{blk}.norm3", self.conv(x, f"{blk}.downsample.0", s), instance)
                x = torch.relu(x + y)
        return self.conv(x, f"{pre}.conv2")

    @staticmethod
    def corr_pyramid(fmap1, fmap2):
        """CorrBlock.__init__: the all-pairs volume over sqrt(dim) and 3 average-pooled levels."""
        b, d, h, w = fmap1.shape
        corr = torch.matmul(fmap1.view(b, d, h * w).transpose(1, 2), fmap2.view(b, d, h * w))
        corr = (corr / math.sqrt(d)).reshape(b * h * w, 1, h, w)
        levels = [corr]
        for _ in range(CORR_LEVELS - 1):
            levels.append(F.avg_pool2d(levels[-1], 2, stride=2))
        return levels

    @staticmethod
    def lookup(levels, coords):
        """CorrBlock.__call__: (B, 2, h, w) coordinates -> (B, 324, h, w)."""
        r = CORR_RADIUS
        b, _, h, w = coords.shape
        coords = coords.permute(0, 2, 3, 1)
        d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).view(1, 2 * r + 1, 2 * r + 1, 2)
        out = []
        for i, corr in enumerate(levels):
            pts = coords.reshape(b * h * w, 1, 1, 2) / 2 ** i + delta
            hh, ww = corr.shape[-2:]
            grid = torch.cat([2 * pts[..., :1] / (ww - 1) - 1, 2 * pts[..., 1:] / (hh - 1) - 1], dim=-1)
            out.append(F.grid_sample(corr, grid, align_corners=True).view(b, h, w, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()

    def update(self, net, inp, corr, flow):
        """BasicUpdateBlock: the motion encoder, the separable ConvGRU and the flow head."""
        pre = "update_block"
        cor = torch.relu(self.conv(corr, f"{pre}.encoder.convc1"))
        cor = torch.relu(self.conv(cor, f"{pre}.encoder.convc2", padding=1))
        flo = torch.relu(self.conv(flow, f"{pre}.encoder.convf1", padding=3))
        flo = torch.relu(self.conv(flo, f"{pre}.encoder.convf2", padding=1))
        out = torch.relu(self.conv(torch.cat([cor, flo], 1), f"{pre}.encoder.conv", padding=1))
        x = torch.cat([inp, out, flow], 1)
        h = net
        for n, pad in (("1", (0, 2)), ("2", (2, 0))):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(self.conv(hx, f"{pre}.gru.convz{n}", padding=pad))
            r = torch.sigmoid(self.conv(hx, f"{pre}.gru.convr{n}", padding=pad))
            q = torch.tanh(self.conv(torch.cat([r * h, x], 1), f"{pre}.gru.convq{n}", padding=pad))
            h = (1 - z) * h + z * q
        delta = self.conv(torch.relu(self.conv(h, f"{pre}.flow_head.conv1", padding=1)),
                          f"{pre}.flow_head.conv2", padding=1)
        return h, delta

    @staticmethod
    def upsample(flow, mask):
        """RAFT.upsample_flow: the x8 convex combination of each 3x3 neighbourhood."""
        n, _, h, w = flow.shape
        mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
        up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
        return torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)

    @torch.no_grad()
    def forward(self, image1, image2, iters: int, flow_init=None):
        """(flow_low (B, 2, H/8, W/8), flow_up (B, 2, H, W)) between padded
        (B, 3, H, W) frames in [0, 255]."""
        with exact_f32():
            im1, im2 = 2 * (image1 / 255.0) - 1.0, 2 * (image2 / 255.0) - 1.0
            b = im1.shape[0]
            fmaps = self.encoder("fnet", torch.cat([im1, im2]), instance=True)
            levels = self.corr_pyramid(fmaps[:b].float(), fmaps[b:].float())
            cnet = self.encoder("cnet", im1, instance=False)
            net, inp = torch.tanh(cnet[:, :HIDDEN]), torch.relu(cnet[:, HIDDEN:HIDDEN + CONTEXT])
            coords0 = coords_grid(b, *net.shape[-2:], im1.device)
            coords1 = coords0 if flow_init is None else coords0 + flow_init
            for _ in range(iters):
                net, delta = self.update(net, inp, self.lookup(levels, coords1), coords1 - coords0)
                coords1 = coords1 + delta
            mask = 0.25 * self.conv(torch.relu(self.conv(net, "update_block.mask.0", padding=1)),
                                    "update_block.mask.2")
            return coords1 - coords0, self.upsample(coords1 - coords0, mask)


def sintel_sequence(ref: RAFTReference, frames, new_seq, iters: int = 32, warm_start: bool = True):
    """create_sintel_submission over (n, B, 3, H, W) frames in [0, 255] with
    a flag each that starts a sequence: [(flow (B, 2, H, W), flow_low)] for
    every frame with a predecessor in its sequence, in order."""
    out, flow_prev = [], None
    h, w = frames.shape[-2:]
    for k in range(1, len(frames)):
        if new_seq[k]:
            flow_prev = None
            continue
        flow_low, flow_up = ref.forward(pad8(frames[k - 1]), pad8(frames[k]), iters, flow_prev)
        out.append((unpad8(flow_up, h, w), flow_low))
        if warm_start:
            flow_prev = forward_interpolate(flow_low)
    return out
