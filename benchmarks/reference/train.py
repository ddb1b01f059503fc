"""Zero-TIG's zero-shot training step in plain PyTorch: the 17-term loss,
backward, and the optimizer.

The loss is LossFunction.forward (loss.py:23-78) with SmoothLoss
(:173-311) and L_TV (:139-152), NCHW, every weight, eps and clip of the
published code and its quirks: the criterion reads the raw frame plus 1e-9;
the luminance puts 0.299 on channel 2; SmoothLoss's yCbCr flattens the NCHW
buffer into rows of three values; its 24 shifted terms are 12 offsets
counted twice; ``weighted_diff2`` blends with H3_denoised1.

The optimizer is train.py's (:98, :130): the gradients clipped to a global
norm of ``grad_clip`` (scaled only when the norm reaches it), weight decay
added to the gradient, then Adam with bias correction.
"""

from __future__ import annotations

import torch

from . import ops
from .model import ZeroTIGReference
from .ops import clip
from .params import TRAINABLE

EPS9 = 1e-9
SMOOTH_OFFSETS = ((1, 0), (0, 1), (1, 1), (1, -1), (2, 0), (0, 2), (2, 1), (2, -1),
                  (1, 2), (1, -2), (2, 2), (2, -2))
YCBCR_MAT = ((0.257, -0.148, 0.439), (0.564, -0.291, -0.368), (0.098, 0.439, -0.071))
YCBCR_BIAS = (16.0 / 255.0, 128.0 / 255.0, 128.0 / 255.0)


def _mse(a, b):
    return torch.mean(torch.square(a - b))


def _ycbcr_scrambled(x):
    b, c, h, w = x.shape
    flat = x.contiguous().reshape(-1, 3)
    cols = [flat[:, 0] * YCBCR_MAT[0][j] + flat[:, 1] * YCBCR_MAT[1][j] + flat[:, 2] * YCBCR_MAT[2][j]
            + YCBCR_BIAS[j] for j in range(3)]
    return torch.stack(cols, -1).reshape(b, c, h, w)


def _shift(x, dy, dx):
    h, w = x.shape[-2:]
    return (x[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)],
            x[..., max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)])


def smooth_loss(rgb, out):
    ycc = _ycbcr_scrambled(rgb)
    total = out.new_zeros(())
    for dy, dx in SMOOTH_OFFSETS:
        ia, ib = _shift(ycc, dy, dx)
        oa, ob = _shift(out, dy, dx)
        wgt = torch.exp(torch.sum(torch.square(ia - ib), 1, keepdim=True) * (-1.0 / 200.0))
        total = total + 2.0 * torch.mean(wgt * torch.sum(torch.abs(oa - ob), 1, keepdim=True))
    return total


def tv_loss(x):
    b, _, h, w = x.shape
    dh = torch.square(x[:, :, 1:] - x[:, :, :-1])
    dw = torch.square(x[:, :, :, 1:] - x[:, :, :, :-1])
    return 2.0 * (torch.sum(dh) / ((h - 1) * w) + torch.sum(dw) / (h * (w - 1))) / b


def zero_tig_loss(frame, o):
    """The weighted 17-term objective of one frame (B, 3, H, W) in [0, 1]."""
    inp = frame + EPS9
    L2d = o["L2"].detach()
    luma = L2d[:, 2] * 0.299 + L2d[:, 1] * 0.587 + L2d[:, 0] * 0.144
    factor = clip(0.5 / (torch.mean(luma, dim=(1, 2))[:, None, None, None] + EPS9), 1.0, 25.0)
    adjustment = torch.pow(0.7, -factor) / factor
    s2 = o["s2"]
    loss = _mse(s2, clip(torch.pow(L2d * factor, factor) * adjustment, EPS9, 1.0)) * 700.0
    loss = loss + _mse(clip(L2d / s2, EPS9, 0.8), clip(L2d * factor, EPS9, 1.0)) * 1000.0
    loss = loss + smooth_loss(L2d, s2) * 5.0
    loss = loss + tv_loss(s2) * 1600.0
    L11, L12 = ops.pair_downsampler(inp)
    loss = loss + _mse(L11, o["L_pred2"]) * 1000.0 + _mse(L12, o["L_pred1"]) * 1000.0
    d1, d2 = ops.pair_downsampler(o["L2"])
    loss = loss + _mse(o["L_pred1"], d1) * 1000.0 + _mse(o["L_pred2"], d2) * 1000.0
    loss = loss + _mse(o["H3_pred"], torch.cat([o["H12"], o["s22"]], 1).detach()) * 1000.0
    loss = loss + _mse(o["H4_pred"], torch.cat([o["H11"], o["s21"]], 1).detach()) * 1000.0
    H3d1, H3d2 = ops.pair_downsampler(o["H3"])
    loss = loss + _mse(o["H3_pred"][:, 0:3], H3d1) * 1000.0 + _mse(o["H4_pred"][:, 0:3], H3d2) * 1000.0
    loss = loss + _mse(o["H2_blur"].detach(), o["H3_blur"]) * 10000.0
    loss = loss + _mse(s2.detach(), o["s3"]) * 1000.0
    d = o["H3_diff"]
    loss = loss + _mse(H3d1, (1.0 - d) * ops.local_mean(H3d1) + H3d1 * d) * 10000.0
    loss = loss + _mse(H3d2, (1.0 - d) * ops.local_mean(H3d2) + H3d1 * d) * 10000.0
    noise_var = ops.local_variance(o["H3"] - o["H2"])
    loss = loss + _mse(ops.local_variance(o["H2"]), noise_var) * 1000.0
    return loss


class TrainerReference:
    """Zero-shot training of ``ZeroTIGReference`` from ``state``: fresh Adam
    moments and a zero carry of (B, 3, H, W). ``opt``: lr, weight_decay,
    grad_clip, adam_beta1, adam_beta2. ``first_grads`` holds each leaf's
    gradient as the optimizer takes it at the first step (clipped, decay
    added)."""

    def __init__(self, state, opt: dict, frame_shape, operands="f32", device=None):
        self.model = ZeroTIGReference(state, operands, device, trainable=TRAINABLE)
        self.opt = opt
        self.mu = {k: torch.zeros_like(self.model.p[k]) for k in TRAINABLE}
        self.nu = {k: torch.zeros_like(self.model.p[k]) for k in TRAINABLE}
        self.count = 0
        zeros = torch.zeros(frame_shape, device=device)
        self.carry = (zeros, zeros.clone())
        self.first_grads: dict | None = None

    def step(self, frame, new: bool, of_scale: int, iters: int, bn_train: bool, loss_fn=zero_tig_loss) -> float:
        """One training frame (B, 3, H, W) in [0, 1]; returns the loss."""
        o, carry = self.model.train_forward(frame, self.carry, new, of_scale, iters, bn_train)
        loss = loss_fn(frame, o)
        loss.backward()
        self._adam()
        self.carry = carry
        return float(loss.detach())

    @torch.no_grad()
    def _adam(self):
        c, p = self.opt, self.model.p
        grads = {k: p[k].grad for k in TRAINABLE}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.where(norm >= c["grad_clip"], c["grad_clip"] / norm, torch.ones_like(norm))
        self.count += 1
        b1, b2 = c["adam_beta1"], c["adam_beta2"]
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        taken = {}
        for k in TRAINABLE:
            g = grads[k] * scale + c["weight_decay"] * p[k]
            taken[k] = g.clone()
            self.mu[k].mul_(b1).add_((1.0 - b1) * g)
            self.nu[k].mul_(b2).add_((1.0 - b2) * g * g)
            p[k].sub_(c["lr"] * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8))
            p[k].grad = None
        if self.first_grads is None:
            self.first_grads = taken
