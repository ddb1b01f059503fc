"""Zero-TIG in plain PyTorch: streaming inference and the training forward.

A frozen rewrite of the published model on ``F.conv2d`` and torch
operations, NCHW float32 (L-Forster/Zero-TIG ``model/model.py``: Denoise_1,
the flow and warp of the previous output, the Enhancer, Denoise_2; RAFT from
``model/RAFT``). It takes a state dict under the published key names and
nothing else: no kernel, cache or packed weight of the program.

The published model's quirks are kept, since the program keeps them: the
previous output goes to RAFT scaled by 255 and not equalised while the
current frame is; the warp scales its x map by the height ratio and its y
map by the width ratio; on a scene's first frame the warped state is zero
for the Enhancer and replaced by H2 for Denoise_2 (inference only); RAFT's
correlation window pairs channel i * 9 + j with the offsets (x + L[i],
y + L[j]); the convex upsample gives the flow at the padded size.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import ops
from .ops import EPS, clip, leaky
from .params import CORR_LEVELS, CORR_RADIUS, ENH_LAYERS, HIDDEN, PARAMS


class ZeroTIGReference:
    """The model on ``state`` (a state dict; aliases are ignored) in float32,
    convolutions and matrix products reading operands through ``operands``
    ("f32" for the reference; "tf32" or "fp8" for a control).

    ``trainable``: the Enhancer's and the denoisers' tensors become leaves
    that record gradients (``params.TRAINABLE``). ``freeze_stats``: a
    batch-statistics BatchNorm leaves the running statistics where they are
    (a planted fault, for the check's calibration)."""

    freeze_stats = False

    def __init__(self, state: dict, operands: str = "f32", device=None, trainable: tuple = ()):
        self.p = {k: state[k].detach().to(device=device, dtype=torch.float32).clone() for k, _, _ in PARAMS}
        for k in trainable:
            self.p[k].requires_grad_(True)
        self.rnd = ops.Rounding(operands)

    # -- layers --------------------------------------------------------------

    def conv(self, x, key, stride=1, padding=0):
        return F.conv2d(self.rnd(x), self.rnd(self.p[key + ".weight"]), self.p[key + ".bias"], stride, padding)

    def bn(self, key, x, train: bool = False):
        p = self.p
        mean, var = p[key + ".running_mean"], p[key + ".running_var"]
        if self.freeze_stats:
            mean, var = mean.clone(), var.clone()
        return F.batch_norm(x, mean, var, p[key + ".weight"], p[key + ".bias"], training=train, momentum=0.1,
                            eps=1e-5)

    def denoise(self, pre, x):
        """The residual Denoise(x): 3x3, LeakyReLU 0.2, 3x3, LeakyReLU 0.2, 1x1."""
        x = leaky(self.conv(x, f"{pre}.conv1", padding=1))
        x = leaky(self.conv(x, f"{pre}.conv2", padding=1))
        return self.conv(x, f"{pre}.conv3")

    def enhance(self, x, bn_train: bool = False):
        """Illumination s2 from 9 channels: in_conv + ReLU, the shared
        conv+BN+ReLU block three times with a residual, out_conv + sigmoid,
        clipped to [1e-4, 1]. With ``bn_train`` the block normalises by batch
        statistics and moves the running ones at each of its three uses."""
        fea = torch.relu(self.conv(x, "enhance.in_conv.0", padding=1))
        for _ in range(ENH_LAYERS):
            fea = fea + torch.relu(self.bn("enhance.conv.1", self.conv(fea, "enhance.conv.0", padding=1), bn_train))
        return clip(torch.sigmoid(self.conv(fea, "enhance.out_conv.0", padding=1)), 1e-4, 1.0)

    # -- RAFT ----------------------------------------------------------------

    def _norm(self, key, x, instance: bool):
        return F.instance_norm(x, eps=1e-5) if instance else self.bn(key, x)

    def encoder(self, pre, x, instance: bool):
        x = torch.relu(self._norm(f"{pre}.norm1", self.conv(x, f"{pre}.conv1", 2, 3), instance))
        for i, stride in ((1, 1), (2, 2), (3, 2)):
            for j in range(2):
                blk, s = f"{pre}.layer{i}.{j}", stride if j == 0 else 1
                y = torch.relu(self._norm(f"{blk}.norm1", self.conv(x, f"{blk}.conv1", s, 1), instance))
                y = torch.relu(self._norm(f"{blk}.norm2", self.conv(y, f"{blk}.conv2", 1, 1), instance))
                if s != 1:
                    x = self._norm(f"{blk}.norm3", self.conv(x, f"{blk}.downsample.0", s), instance)
                x = torch.relu(x + y)
        return self.conv(x, f"{pre}.conv2")

    def corr_pyramid(self, f1, f2):
        b, d, h, w = f1.shape
        a = self.rnd(f1.reshape(b, d, h * w).transpose(1, 2))
        corr = torch.matmul(a, self.rnd(f2.reshape(b, d, h * w))) / math.sqrt(d)
        levels = [corr.reshape(b * h * w, 1, h, w)]
        for _ in range(CORR_LEVELS - 1):
            c = levels[-1]
            hh, ww = c.shape[-2] // 2, c.shape[-1] // 2
            levels.append(F.avg_pool2d(c, 2, stride=2) if hh and ww else c.new_zeros(c.shape[0], 1, hh, ww))
        return levels

    @staticmethod
    def lookup(levels, coords):
        """(B, 2, h, w) coordinates -> (B, 324, h, w) windows, level-major;
        channel a * 9 + b of a level samples (x / 2^l + L[a], y / 2^l + L[b])."""
        b, _, h, w = coords.shape
        q, n = b * h * w, 2 * CORR_RADIUS + 1
        offs = torch.arange(-CORR_RADIUS, CORR_RADIUS + 1, dtype=torch.float32, device=coords.device)
        cx = coords[:, 0].reshape(q, 1, 1)
        cy = coords[:, 1].reshape(q, 1, 1)
        out = []
        for i, lvl in enumerate(levels):
            h2, w2 = lvl.shape[-2:]
            if h2 == 0 or w2 == 0:
                out.append(coords.new_zeros(b, n * n, h, w))
                continue
            x = (cx / 2 ** i + offs[None, :, None]).expand(q, n, n)
            y = (cy / 2 ** i + offs[None, None, :]).expand(q, n, n)
            v = ops.bilinear_zero(lvl.reshape(q, h2 * w2), x, y, h2, w2)
            out.append(v.reshape(b, h, w, n * n).permute(0, 3, 1, 2))
        return torch.cat(out, 1)

    def update(self, net, inp, corr, flow):
        """One refinement iteration: motion encoder, the separable ConvGRU
        (1x5 then 5x1) and the flow head: (net', delta)."""
        pre = "raft.update_block"
        cor = torch.relu(self.conv(corr, f"{pre}.encoder.convc1"))
        cor = torch.relu(self.conv(cor, f"{pre}.encoder.convc2", padding=1))
        flo = torch.relu(self.conv(flow, f"{pre}.encoder.convf1", padding=3))
        flo = torch.relu(self.conv(flo, f"{pre}.encoder.convf2", padding=1))
        mot = torch.relu(self.conv(torch.cat([cor, flo], 1), f"{pre}.encoder.conv", padding=1))
        x = torch.cat([inp, mot, flow], 1)
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
    def convex_upsample(flow, mask):
        n, _, h, w = flow.shape
        mask = mask.view(n, 1, 9, 8, 8, h, w).softmax(dim=2)
        up = F.unfold(8.0 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
        return (mask * up).sum(dim=2).permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)

    def raft(self, image1, image2, iters: int):
        """Flow (B, 2, 8h, 8w) at the padded size between two frames in [0, 255]."""
        im1 = 2.0 * (ops.pad8(image1) / 255.0) - 1.0
        im2 = 2.0 * (ops.pad8(image2) / 255.0) - 1.0
        b = im1.shape[0]
        fmaps = self.encoder("raft.fnet", torch.cat([im1, im2]), instance=True)
        levels = self.corr_pyramid(fmaps[:b], fmaps[b:])
        cnet = self.encoder("raft.cnet", im1, instance=False)
        net, inp = torch.tanh(cnet[:, :HIDDEN]), torch.relu(cnet[:, HIDDEN:])
        coords0 = ops.coords_grid(b, net.shape[2], net.shape[3], net.device)
        coords1 = coords0
        for _ in range(iters):
            net, delta = self.update(net, inp, self.lookup(levels, coords1), coords1 - coords0)
            coords1 = coords1 + delta
        pre = "raft.update_block.mask"
        mask = 0.25 * self.conv(torch.relu(self.conv(net, f"{pre}.0", padding=1)), f"{pre}.2")
        return self.convex_upsample(coords1 - coords0, mask)

    # -- the composed network --------------------------------------------------

    def warped_state(self, carry, L2, of_scale: int, iters: int):
        """Flow from the previous output to this frame at 1/of_scale, and the
        backward warp of [last_H3 | last_s3]: (B, 6, H, W)."""
        last_H3, last_s3 = carry
        h, w = last_H3.shape[-2:]
        size = (h // of_scale, w // of_scale)
        last_tmp = ops.resize(last_H3, size) * 255.0
        l2_tmp = ops.equalize01(ops.resize(L2, size))
        return ops.warp(self.raft(last_tmp, l2_tmp, iters), torch.cat([last_H3, last_s3], 1))

    @torch.no_grad()
    def infer_frame(self, frame, carry, new: bool, of_scale: int, raft_iters: int, enh_scale: int = 1):
        """One frame (B, 3, H, W) in [0, 1] and the carry (last_H3, last_s3):
        (H2, H3, s3), and the new carry is (H3, s3)."""
        inp = frame + EPS
        L2 = clip(inp - self.denoise("denoise_1", inp), EPS, 1.0)
        w6 = self.warped_state(carry, L2, of_scale, raft_iters)
        if new:
            w6 = torch.zeros_like(w6)
        h, w = L2.shape[-2:]
        if enh_scale > 1 and h % enh_scale == 0 and w % enh_scale == 0:
            small = (h // enh_scale, w // enh_scale)
            s2 = ops.resize(self.enhance(torch.cat([ops.resize(w6, small), ops.resize(L2, small)], 1)), (h, w))
        else:
            s2 = self.enhance(torch.cat([w6, L2], 1))
        H2 = clip(inp / s2, EPS, 1.0)
        if new:
            w6 = torch.cat([H2, H2], 1)
        H5 = clip(torch.cat([H2, s2], 1) - self.denoise("denoise_2", torch.cat([w6, H2, s2], 1)), EPS, 1.0)
        return H2, H5[:, :3], H5[:, 3:]

    def train_forward(self, frame, carry, new: bool, of_scale: int, iters: int, bn_train: bool):
        """The training forward (model/model.py:84-259) on one frame in
        [0, 1]: a dict of the maps the loss reads, and the new carry."""
        inp = frame + EPS
        L11, L12 = ops.pair_downsampler(inp)
        L_pred1 = L11 - self.denoise("denoise_1", L11)
        L_pred2 = L12 - self.denoise("denoise_1", L12)
        L2 = clip(inp - self.denoise("denoise_1", inp), EPS, 1.0)
        with torch.no_grad():
            w6 = self.warped_state(carry, L2.detach(), of_scale, iters)
            if new:
                w6 = torch.zeros_like(w6)
        H31w, H32w = ops.pair_downsampler(w6[:, :3])
        s31w, s32w = ops.pair_downsampler(w6[:, 3:])
        s2 = self.enhance(torch.cat([w6, L2.detach()], 1), bn_train)
        s21, s22 = ops.pair_downsampler(s2)
        H2 = clip(inp / s2, EPS, 1.0)
        H11 = clip(L11 / s21, EPS, 1.0)
        H12 = clip(L12 / s22, EPS, 1.0)

        def refine(wH, ws, H, s):
            anchor = torch.cat([H, s], 1).detach()
            return clip(anchor - self.denoise("denoise_2", torch.cat([wH, ws, H, s], 1)), EPS, 1.0)

        H3_pred = refine(H31w, s31w, H11, s21)
        H4_pred = refine(H32w, s32w, H12, s22)
        H5 = refine(w6[:, :3], w6[:, 3:], H2, s2)
        H3, s3 = H5[:, :3], H5[:, 3:]
        H3d1, H3d2 = ops.pair_downsampler(H3)
        o = dict(L_pred1=L_pred1, L_pred2=L_pred2, L2=L2, s2=s2, s21=s21, s22=s22, H2=H2, H11=H11, H12=H12,
                 H3=H3, s3=s3, H3_pred=H3_pred, H4_pred=H4_pred,
                 H3_diff=ops.texture_difference(H3d1, H3d2),
                 H2_blur=ops.blur(clip(L2 / s2, 0.0, 1.0)), H3_blur=ops.blur(H3))
        return o, (H3.detach(), s3.detach())
