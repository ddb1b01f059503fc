"""GMA (Jiang et al., ICCV 2021, arXiv:2104.02409; zacjiang/GMA) at its
Sintel evaluation in plain PyTorch, for the benchmark's GMA flow-sequence
cells: RAFT's warm-started ``create_sintel_submission``, which GMA's
``evaluate.py`` keeps, with ``core/network.py::RAFTGMA``'s pass.

It builds on the frozen RAFT of ``raft_sintel.py`` and ``model.py``
(encoders, correlation pyramid and lookup, motion encoder convolutions,
convex upsample, padding, the forward interpolation; ``F.conv2d``, float32,
TF32 off) and adds GMA's parts with the published defaults (one head of
128 channels, content-only attention, ``max_pos_size`` 160):

- ``attention``: ``core/gma.py::Attention.forward``: q and k from the 1x1
  ``to_qk`` of the context features, q scaled by 128^-0.5, the logits
  between every two positions of the 1/8 grid and a softmax over the keys,
  once a pair;
- ``aggregate``: ``core/gma.py::Aggregate.forward``,
  ``mf + gamma * attn @ to_v(mf)``;
- ``update``: ``core/update.py::GMAUpdateBlock.forward``: the motion
  features ``mf`` (126 channels and the flow), their aggregation, and the
  separable ConvGRU on [inp | mf | glob] (every gate 512 channels wide).

It takes a state dict under GMA's published names (``GMA_PARAMS``; the
relative position embeddings are held and never read) and nothing of the
program under test. ``operands`` "tf32" rounds the operands of every
convolution and matrix product, the attention's and the aggregation's
too, for the check's control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ops
from .ops import exact_f32
from .params import HIDDEN, _conv, _encoder
from .raft_sintel import RAFT_WIDTHS, RAFTSintelReference, unpad8

HEADS, DIM_HEAD, MAX_POS = 1, 128, 160
GMA_WIDTHS = {**RAFT_WIDTHS, "gma_heads": HEADS, "gma_dim_head": DIM_HEAD, "gma_max_pos_size": MAX_POS}


def _update_block() -> list:
    """RAFT's update block with GRU gates 512 wide, and the aggregator."""
    pre = "update_block"
    specs = (_conv(f"{pre}.encoder.convc1", 256, 324, 1) + _conv(f"{pre}.encoder.convc2", 192, 256, 3)
             + _conv(f"{pre}.encoder.convf1", 128, 2, 7) + _conv(f"{pre}.encoder.convf2", 64, 128, 3)
             + _conv(f"{pre}.encoder.conv", 128 - 2, 64 + 192, 3))
    for n, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for gate in "zrq":
            specs += _conv(f"{pre}.gru.conv{gate}{n}", HIDDEN, HIDDEN + 128 + 2 * HIDDEN, kh, kw)
    specs += _conv(f"{pre}.flow_head.conv1", 256, HIDDEN, 3) + _conv(f"{pre}.flow_head.conv2", 2, 256, 3)
    specs += _conv(f"{pre}.mask.0", 256, HIDDEN, 3) + _conv(f"{pre}.mask.2", 64 * 9, 256, 1)
    return specs + [(f"{pre}.aggregator.to_v.weight", (DIM_HEAD, 128, 1, 1), "v_w"),
                    (f"{pre}.aggregator.gamma", (1,), "gamma")]


# (key, shape, kind) of each of GMA's tensors under the published names, in
# the order of RAFTGMA's modules; kinds as ``params.PARAMS``, and "qk_w"
# (to_qk), "v_w" (to_v), "gamma" and "emb" (the unread position embeddings)
GMA_PARAMS = (
    _encoder("fnet", 256, False) + _encoder("cnet", 2 * HIDDEN, True) + _update_block()
    + [("att.to_qk.weight", (2 * HEADS * DIM_HEAD, 128, 1, 1), "qk_w"),
       ("att.pos_emb.rel_height.weight", (2 * MAX_POS - 1, DIM_HEAD), "emb"),
       ("att.pos_emb.rel_width.weight", (2 * MAX_POS - 1, DIM_HEAD), "emb")]
)


def check_gma_widths(config: dict) -> None:
    """A configuration's widths must be GMA's published ones: neither side runs others."""
    wrong = {k: config.get(k) for k, v in GMA_WIDTHS.items() if config.get(k) != v}
    if wrong:
        raise ValueError(f"{config.get('name')}: widths {wrong} differ from GMA's {GMA_WIDTHS}")


class GMASintelReference(RAFTSintelReference):
    """GMA with a warm start on a state dict under GMA's names (held here
    under ``raft.`` so that RAFT's layers find them). ``operands``: "f32",
    or "tf32" for the check's control."""

    def __init__(self, state: dict, operands: str = "f32", device=None):
        self.p = {"raft." + k: state[k].detach().to(device=device, dtype=torch.float32).clone()
                  for k, _, _ in GMA_PARAMS}
        self.rnd = ops.Rounding(operands)

    def attention(self, inp):
        """(B, 128, h, w) context features -> (B, h*w, h*w), rows over the keys."""
        b, _, h, w = inp.shape
        qk = F.conv2d(self.rnd(inp), self.rnd(self.p["raft.att.to_qk.weight"]))
        q, k = qk.reshape(b, 2, DIM_HEAD, h * w).unbind(1)
        sim = torch.matmul(self.rnd(DIM_HEAD ** -0.5 * q).transpose(1, 2), self.rnd(k))
        return sim.softmax(dim=-1)

    def aggregate(self, attn, mf):
        """mf + gamma * attn @ to_v(mf): (B, 128, h, w)."""
        b, c, h, w = mf.shape
        pre = "raft.update_block.aggregator"
        v = F.conv2d(self.rnd(mf), self.rnd(self.p[f"{pre}.to_v.weight"])).reshape(b, c, h * w)
        out = torch.matmul(self.rnd(attn), self.rnd(v).transpose(1, 2)).transpose(1, 2).reshape(b, c, h, w)
        return mf + self.p[f"{pre}.gamma"] * out

    def update(self, net, inp, corr, flow, attn):
        """One GMA iteration: (net', delta)."""
        pre = "raft.update_block"
        cor = torch.relu(self.conv(corr, f"{pre}.encoder.convc1"))
        cor = torch.relu(self.conv(cor, f"{pre}.encoder.convc2", padding=1))
        flo = torch.relu(self.conv(flow, f"{pre}.encoder.convf1", padding=3))
        flo = torch.relu(self.conv(flo, f"{pre}.encoder.convf2", padding=1))
        mf = torch.cat([torch.relu(self.conv(torch.cat([cor, flo], 1), f"{pre}.encoder.conv", padding=1)), flow], 1)
        x = torch.cat([inp, mf, self.aggregate(attn, mf)], 1)
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

    @torch.no_grad()
    def context_attention(self, frame: torch.Tensor) -> torch.Tensor:
        """The attention a pair whose first frame is ``frame`` (B, 3, h, w) in [0, 255] computes."""
        with exact_f32():
            cnet = self.encoder("raft.cnet", 2.0 * (ops.pad8(frame) / 255.0) - 1.0, instance=False)
            return self.attention(torch.relu(cnet[:, HIDDEN:]))

    @torch.no_grad()
    def pair(self, frame1: torch.Tensor, frame2: torch.Tensor, iters: int, flow_init: torch.Tensor | None = None):
        """(flow_low (B, 2, H8/8, W8/8), flow (B, 2, h, w)) between (B, 3, h, w)
        frames in [0, 255]: RAFTGMA.forward(..., flow_init, test_mode=True) on
        the padded frames, and the flow cut back to the frames' size."""
        h, w = frame1.shape[-2:]
        with exact_f32():
            im1 = 2.0 * (ops.pad8(frame1) / 255.0) - 1.0
            im2 = 2.0 * (ops.pad8(frame2) / 255.0) - 1.0
            b = im1.shape[0]
            fmaps = self.encoder("raft.fnet", torch.cat([im1, im2]), instance=True)
            levels = self.corr_pyramid(fmaps[:b], fmaps[b:])
            cnet = self.encoder("raft.cnet", im1, instance=False)
            net, inp = torch.tanh(cnet[:, :HIDDEN]), torch.relu(cnet[:, HIDDEN:])
            attn = self.attention(inp)
            coords0 = ops.coords_grid(b, net.shape[2], net.shape[3], net.device)
            coords1 = coords0 if flow_init is None else coords0 + flow_init
            for _ in range(iters):
                net, delta = self.update(net, inp, self.lookup(levels, coords1), coords1 - coords0, attn)
                coords1 = coords1 + delta
            pre = "raft.update_block.mask"
            mask = 0.25 * self.conv(torch.relu(self.conv(net, f"{pre}.0", padding=1)), f"{pre}.2")
            low = coords1 - coords0
            return low, unpad8(self.convex_upsample(low, mask), h, w)
