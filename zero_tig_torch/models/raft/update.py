"""RAFT update block and K2, its per-iteration core.

Port of ``zero_tig_tpu/models/raft/update.py`` (modules) and of the Pallas
kernel ``zero_tig_tpu/models/raft/update_kernel.py::update_core_kernel``:
``update_core`` computes one refinement iteration,

    cor  = relu(convc1_1x1(corr));  cor = relu(convc2_3x3(cor))
    mot  = relu(conv_3x3([cor | flo]));  x = [inp | mot | flow]
    per GRU direction (1x5, then 5x1):
        zr = sigmoid(conv_zr([net | x]))      z|r gates in one conv
        q  = tanh(conv_q([r*net | x]))
        net = (1 - z)*net + z*q
    delta = conv2_3x3(relu(conv1_3x3(net)))

as 9 K1 launches (``ops/fused_conv.py``; the concats are K1's multi-input
loads) and 4 launches of the GRU kernel (``ops/gru.py``) -- 13 per
iteration. Numerics as the TPU kernel (update_kernel.py:24-26): operands of
every conv in the working dtype (bf16 in fast mode), f32 sums, gates and
blend; net' stored in the working dtype, delta in f32. ``convf1`` (7x7 on 2
channels) and ``convf2`` stay outside the core, as in JAX, as library
convolutions. The mask head runs once after the loop, as 2 K1 launches.

``BasicUpdateBlock.forward`` is the module path of JAX's
``BasicUpdateBlock.__call__`` (update.py:156-162) with the mask head: library
convolutions under autograd, for flow-model training, where neither K1 nor
the GRU kernel (they have no backward) runs.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.fused_conv import ConvWeights, conv_weights, fused_conv, prepare_conv
from ...ops.gru import gru_reset, gru_update
from ..layers import conv2d, conv2d_nhwc


def _cat_out(a: ConvWeights, b: ConvWeights) -> ConvWeights:
    """Two convs of one input as one: output channels concatenated (exact)."""
    return conv_weights(torch.cat([a.w, b.w], dim=-1), torch.cat([a.scale, b.scale]), torch.cat([a.shift, b.shift]))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 324):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        for name, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{name}", nn.Conv2d(hidden_dim + input_dim, hidden_dim, k, padding=p))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1)
        )
        self.kw: dict | None = None
        self.dtype = torch.float32

    def prepare(self, dtype: torch.dtype) -> None:
        enc, gru, fh = self.encoder, self.gru, self.flow_head
        p = lambda conv, **kw: prepare_conv(conv, dtype, **kw)  # noqa: E731
        self.dtype = dtype
        self.kw = {
            "convc1": p(enc.convc1),
            "convc2": p(enc.convc2),
            "conv": p(enc.conv),
            "zr1": _cat_out(p(gru.convz1), p(gru.convr1)),
            "q1": p(gru.convq1),
            "zr2": _cat_out(p(gru.convz2), p(gru.convr2)),
            "q2": p(gru.convq2),
            "fh1": p(fh.conv1),
            "fh2": p(fh.conv2),
            "mask0": p(self.mask[0]),
            # reference update.py:131 scales the mask by 0.25; folded here
            "mask2": p(self.mask[2], out_scale=0.25),
        }

    def flow_features(self, flow: torch.Tensor) -> torch.Tensor:
        """relu(convf2(relu(convf1(flow)))): (B, h, w, 2) f32 -> NHWC working dtype."""
        x = flow.permute(0, 3, 1, 2)
        x = torch.relu(conv2d(self.encoder.convf1, x, self.dtype))
        x = torch.relu(conv2d(self.encoder.convf2, x, self.dtype))
        return x.permute(0, 2, 3, 1).contiguous()

    def forward(
        self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor, flow: torch.Tensor, dtype: torch.dtype
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One iteration on the plain modules, differentiable: (net', mask,
        delta), NHWC in and out, conv operands in ``dtype``. The dtypes
        follow JAX's promotions: ``flow`` and the concatenations holding it
        are f32, every conv's output, the gates and net' are in ``dtype``."""
        enc, gru = self.encoder, self.gru
        conv = lambda c, x: conv2d_nhwc(c, x, dtype)  # noqa: E731
        flow = flow.float()
        cor = torch.relu(conv(enc.convc2, torch.relu(conv(enc.convc1, corr))))
        flo = torch.relu(conv(enc.convf2, torch.relu(conv(enc.convf1, flow))))
        out = torch.relu(conv(enc.conv, torch.cat([cor, flo], -1)))
        x = torch.cat([inp.float(), out.float(), flow], -1)
        h = net
        for n in "12":
            hx = torch.cat([h.float(), x], -1)
            z = torch.sigmoid(conv(getattr(gru, f"convz{n}"), hx))
            r = torch.sigmoid(conv(getattr(gru, f"convr{n}"), hx))
            q = torch.tanh(conv(getattr(gru, f"convq{n}"), torch.cat([(r * h).float(), x], -1)))
            h = (1 - z) * h + z * q
        fh = self.flow_head
        delta = conv(fh.conv2, torch.relu(conv(fh.conv1, h)))
        mask = 0.25 * conv(self.mask[2], torch.relu(conv(self.mask[0], h)))
        return h, mask, delta

    def mask_head(self, net: torch.Tensor) -> torch.Tensor:
        """0.25 * mask_2(relu(mask_0(net))): (B, h, w, 576) convex-upsample logits."""
        m = fused_conv([net], self.kw["mask0"], act="relu")
        return fused_conv([m], self.kw["mask2"])


def update_core(
    kw: dict,
    net: torch.Tensor,
    inp: torch.Tensor,
    corr: torch.Tensor,
    flo: torch.Tensor,
    flow: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One refinement iteration (see the module docstring).

    net, inp: (B, h, w, 128); corr: (B, h, w, 324); flo: (B, h, w, 64),
    all in the working dtype of ``kw``; flow: (B, h, w, 2) f32.
    Returns (net' in the working dtype, delta f32)."""
    dt = kw["convc1"].w.dtype
    f32 = torch.float32
    cor = fused_conv([corr.to(dt).contiguous()], kw["convc1"], act="relu")
    cor = fused_conv([cor], kw["convc2"], act="relu")
    mot = fused_conv([cor, flo], kw["conv"], act="relu")
    x = [inp, mot, flow.to(dt).contiguous()]

    # horizontal pass (1x5): net arrives in the working dtype
    zr = fused_conv([net, *x], kw["zr1"], act="sigmoid", out_dtype=f32)
    rh = gru_reset(zr, net, dt)
    q = fused_conv([rh, *x], kw["q1"], act="tanh", out_dtype=f32)
    if dt == f32:
        (net_f,) = gru_update(zr, q, net, (f32,))
        net_op = net_f
    else:  # the f32 state carries on; its bf16 copy feeds the next conv
        net_f, net_op = gru_update(zr, q, net, (f32, dt))

    # vertical pass (5x1)
    zr = fused_conv([net_op, *x], kw["zr2"], act="sigmoid", out_dtype=f32)
    rh = gru_reset(zr, net_f, dt)
    q = fused_conv([rh, *x], kw["q2"], act="tanh", out_dtype=f32)
    (net,) = gru_update(zr, q, net_f, (dt,))

    fh = fused_conv([net], kw["fh1"], act="relu")
    delta = fused_conv([fh], kw["fh2"], out_dtype=f32)
    return net, delta
