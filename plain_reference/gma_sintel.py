"""GMA's forward pass in plain PyTorch: RAFT with global motion aggregation
(Jiang, Campbell, Lu, Li, Hartley, ICCV 2021, arXiv:2104.02409;
zacjiang/GMA), for its Sintel evaluation, which keeps RAFT's warm-started
``evaluate.py::create_sintel_submission`` at 32 iterations.

Float32, NCHW, on ``F.conv2d`` and torch operations, with TF32 off for
matrix products and cuDNN while it computes. It imports nothing of the port
and no JAX: the port's GMA (``zero_tig_torch/models/raft/gma.py``) is held
against it. It builds on ``raft_sintel.py`` (encoders, correlation pyramid
and lookup, motion encoder, ConvGRU, convex upsample, the padding, the
forward interpolation and ``sintel_sequence``) and adds what GMA changes:

- ``GMAReference.attention``: ``core/gma.py::Attention.forward`` with the
  published defaults (``num_heads`` 1, ``dim_head`` 128, ``position_only``
  and ``position_and_content`` False): q and k from the 1x1 ``to_qk`` of the
  context features, q scaled by 128^-0.5, the content logits between every
  two positions and a softmax over the keys;
- ``GMAReference.aggregate``: ``core/gma.py::Aggregate.forward``,
  ``fmap + gamma * attn @ to_v(fmap)`` (no projection: heads * dim_head is
  the feature width);
- ``GMAReference.update``: ``core/update.py::GMAUpdateBlock.forward``: the
  motion features, their aggregation, and the ConvGRU on
  [inp | motion features | aggregated features];
- ``GMAReference.forward``: ``core/network.py::RAFTGMA.forward(image1,
  image2, iters, flow_init, test_mode=True)``, the attention computed once
  from the context features before the iterations.

Departures from the published code, besides those of ``raft_sintel.py``
(a state dict under the port's names, which are the published ones without
DataParallel's ``module.`` prefix; the mask head once, after the last
iteration):

- one head only, the published default; the relative position embeddings
  (``att.pos_emb``) are not read, as the content-only path reads none;
- the logits are one matrix product of (h*w, 128) by (128, h*w) instead of
  ``einsum`` over the grid's two axes (the same sums).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .raft_sintel import CONTEXT, HIDDEN, RAFTReference, coords_grid, exact_f32

DIM_HEAD = 128


class GMAReference(RAFTReference):
    """GMA on a state dict (the port's key names), float32 on ``device``."""

    def attention(self, inp):
        """(B, 128, h, w) context features -> (B, h*w, h*w), rows over the keys."""
        b, _, h, w = inp.shape
        q, k = F.conv2d(inp, self.p["att.to_qk.weight"]).chunk(2, dim=1)
        q = DIM_HEAD ** -0.5 * q.reshape(b, DIM_HEAD, h * w)
        sim = torch.matmul(q.transpose(1, 2), k.reshape(b, DIM_HEAD, h * w))
        return sim.softmax(dim=-1)

    def aggregate(self, attn, fmap):
        """fmap + gamma * (attn @ to_v(fmap)), (B, 128, h, w)."""
        b, c, h, w = fmap.shape
        pre = "update_block.aggregator"
        v = F.conv2d(fmap, self.p[f"{pre}.to_v.weight"]).reshape(b, c, h * w).transpose(1, 2)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return fmap + self.p[f"{pre}.gamma"] * out

    def update(self, net, inp, corr, flow, attn):
        """GMAUpdateBlock: (net', delta)."""
        mf = self.motion(corr, flow)
        return self.recurrent(net, torch.cat([inp, mf, self.aggregate(attn, mf)], 1))

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
            attn = self.attention(inp)
            coords0 = coords_grid(b, *net.shape[-2:], im1.device)
            coords1 = coords0 if flow_init is None else coords0 + flow_init
            for _ in range(iters):
                net, delta = self.update(net, inp, self.lookup(levels, coords1), coords1 - coords0, attn)
                coords1 = coords1 + delta
            mask = 0.25 * self.conv(torch.relu(self.conv(net, "update_block.mask.0", padding=1)),
                                    "update_block.mask.2")
            return coords1 - coords0, self.upsample(coords1 - coords0, mask)
