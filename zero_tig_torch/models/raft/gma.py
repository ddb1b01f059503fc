"""GMA: RAFT with global motion aggregation (Jiang et al., ICCV 2021,
arXiv:2104.02409; zacjiang/GMA ``core/network.py::RAFTGMA``,
``core/gma.py::Attention, Aggregate``, ``core/update.py::GMAUpdateBlock``),
with the published defaults: one head of 128 channels, content-only
attention (``position_only`` and ``position_and_content`` False).

To RAFT's pass it adds a softmax attention over the 1/8 grid's positions,
computed once a pair from the context features, and an aggregation of the
motion features through it in every iteration:

    q, k = to_qk(inp).chunk(2)                   1x1, 128 -> 256, no bias
    attn = softmax_j(128^-0.5 * q_i . k_j)       (h*w) x (h*w), f32
    each iteration:
        mf   = [relu(conv(cor | flo)) | flow]    RAFT's 128 motion features
        glob = mf + gamma * attn @ to_v(mf)      to_v 1x1, 128 -> 128, no bias
        net  = SepConvGRU(net, [inp | mf | glob])    every gate conv 512 wide
        delta = FlowHead(net)

The relative position embeddings (``att.pos_emb``) are kept under their
published names so that a checkpoint loads, and are never read.

Inference (``RAFTGMA._infer``, the pass ``RAFT.flow_graphed`` captures and
replays): the attention is one ``mm`` for q and k (the 128^-0.5 folded into
q's weights), one ``bmm`` for the logits and a softmax, in f32 whatever the
precision; each iteration runs RAFT's motion encoder (3 K1 launches), ``to_v``
with gamma folded into its scale (1 K1 launch, f32 out), the aggregation as
one ``baddbmm`` (``aggregate``: TF32 as ``numerics`` sets it), and the GRU
and flow head of ``update.gru_core`` with four input parts. Spans
``zt.gma.attention`` (once a pair) and ``zt.gma.aggregate`` (each
iteration) are ``core/spans.py::graph_span``s: inside the graph they are
timing events that each traced replay reads.

``forward(..., return_predictions=True)`` is the differentiable path on
the plain modules, as RAFT's; GMA's training is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core import spans
from ...ops.fused_conv import conv_weights, fused_conv, prepare_conv
from ..layers import conv2d_nhwc, kernel_operands
from .corr import lookup_corr, lookup_corr_reference
from .raft import CORR_RADIUS, HIDDEN_DIM, RAFT, convex_upsample_flow
from .update import BasicUpdateBlock, SepConvGRU, gru_core, motion_core

CONTEXT_DIM = 128
HEADS = 1
DIM_HEAD = 128
MAX_POS_SIZE = 160


class RelPosEmb(nn.Module):
    """``core/gma.py::RelPosEmb``'s parameters and index buffer; the
    content-only attention reads none of them."""

    def __init__(self, max_pos_size: int, dim_head: int):
        super().__init__()
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)
        deltas = torch.arange(max_pos_size).view(1, -1) - torch.arange(max_pos_size).view(-1, 1)
        self.register_buffer("rel_ind", deltas + max_pos_size - 1)


class Attention(nn.Module):
    def __init__(self, dim: int = CONTEXT_DIM, heads: int = HEADS, dim_head: int = DIM_HEAD,
                 max_pos_size: int = MAX_POS_SIZE):
        super().__init__()
        if heads != 1:
            raise ValueError(f"the port runs GMA's published single head, not {heads}")
        self.scale = dim_head ** -0.5
        self.to_qk = nn.Conv2d(dim, 2 * heads * dim_head, 1, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, inp: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The attention on the plain modules, differentiable: (B, h, w, C)
        context features -> (B, h*w, h*w) f32, rows over the keys; the conv's
        operands in ``dtype``."""
        b, h, w, _ = inp.shape
        q, k = conv2d_nhwc(self.to_qk, inp, dtype).float().reshape(b, h * w, -1).chunk(2, dim=-1)
        return torch.einsum("bid,bjd->bij", self.scale * q, k).softmax(dim=-1)

    def qk_weights(self) -> torch.Tensor:
        """(C, 2 * dim_head) f32: [q | k] = inp @ this, q already scaled."""
        w = self.to_qk.weight.detach().float()[:, :, 0, 0]
        d = w.shape[0] // 2
        return torch.cat([w[:d] * self.scale, w[d:]]).t().contiguous()


class Aggregate(nn.Module):
    def __init__(self, dim: int = CONTEXT_DIM, heads: int = HEADS, dim_head: int = DIM_HEAD):
        super().__init__()
        if heads * dim_head != dim:
            raise ValueError("the port runs GMA without its output projection: heads * dim_head == dim")
        self.to_v = nn.Conv2d(dim, heads * dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, mf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """mf + gamma * attn @ to_v(mf) on the plain modules, differentiable:
        (B, h, w, C) f32 -> f32; the conv's operands in ``dtype``."""
        b, h, w, c = mf.shape
        v = conv2d_nhwc(self.to_v, mf, dtype).float().reshape(b, h * w, c)
        return mf + self.gamma * torch.bmm(attn, v).reshape(b, h, w, c)


class GMAUpdateBlock(BasicUpdateBlock):
    """RAFT's update block with the aggregator, and GRU gates that read
    [net | inp | mf | glob] (512 channels)."""

    def __init__(self, hidden_dim: int = HIDDEN_DIM):
        super().__init__(hidden_dim)
        self.gru = SepConvGRU(hidden_dim, 128 + 2 * hidden_dim)
        self.aggregator = Aggregate(128)

    def _operands(self, dtype: torch.dtype) -> dict:
        kw = super()._operands(dtype)
        agg = self.aggregator
        v = prepare_conv(agg.to_v, dtype)
        kw["to_v"] = conv_weights(v.w, v.scale * agg.gamma.detach().float(), v.shift)  # gamma * to_v
        return kw

    def forward(self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor, flow: torch.Tensor,
                attn: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One iteration on the plain modules, differentiable: (net', mask, delta)."""
        flow = flow.float()
        mf = torch.cat([self.motion(corr, flow, dtype).float(), flow], -1)
        glob = self.aggregator(attn, mf, dtype)
        return self.recurrent(net, torch.cat([inp.float(), mf, glob], -1), dtype)


def attention(inp: torch.Tensor, qk: torch.Tensor) -> torch.Tensor:
    """The inference path's attention: (B, h, w, C) context features and
    ``Attention.qk_weights`` -> (B, h*w, h*w) f32."""
    b, h, w, c = inp.shape
    qk = torch.matmul(inp.reshape(b, h * w, c).float(), qk)
    d = qk.shape[-1] // 2
    return torch.bmm(qk[..., :d], qk[..., d:].transpose(1, 2)).softmax(dim=-1)


def aggregate(mf: torch.Tensor, attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """glob = mf + attn @ v, one ``baddbmm``: mf (B, h, w, C), v (B, h, w, C)
    f32 (gamma already in it), attn (B, h*w, h*w) -> (B, h, w, C) f32.
    Counted in ``core/spans.py::COUNTS["gma_aggregate"]``."""
    b, h, w, c = mf.shape
    out = torch.baddbmm(mf.reshape(b, h * w, c).float(), attn, v.reshape(b, h * w, c))
    spans.COUNTS["gma_aggregate"] += 1
    return out.reshape(b, h, w, c)


def gma_core(kw: dict, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor, flo: torch.Tensor,
             flow: torch.Tensor, attn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One GMA iteration on the kernels: RAFT's ``update_core`` with the
    motion features carried as one 128-channel tensor ``mf`` and the
    aggregation as a fourth input part of the GRU's convolutions. Returns
    (net' in the working dtype, delta f32)."""
    dt = kw["convc1"].w.dtype
    mf = torch.cat([motion_core(kw, corr, flo), flow.to(dt)], -1)
    v = fused_conv([mf], kw["to_v"], out_dtype=torch.float32)
    with spans.graph_span("zt.gma.aggregate"):
        glob = aggregate(mf, attn, v)
    return gru_core(kw, net, [inp, mf, glob.to(dt)])


class RAFTGMA(RAFT):
    """RAFT whose update block is ``GMAUpdateBlock``, with the attention
    ``att``: the published module and parameter names."""

    def __init__(self):
        super().__init__()
        self.update_block = GMAUpdateBlock(HIDDEN_DIM)
        self.att = Attention(CONTEXT_DIM)

    def prepare(self, dtype: torch.dtype) -> dict:
        """RAFT's operands, ``to_v`` with gamma folded in and the attention's
        q/k weights ("qk"), as one dict in the update block (``kw``, which
        the graph's key names), built again when any of GMA's parameters or
        buffers, or the dtype, changed."""
        ub = self.update_block
        ub.kw = kernel_operands(self, dtype, lambda dt: {**ub._operands(dt), "qk": self.att.qk_weights()})
        ub.dtype = dtype
        return ub.kw

    def forward(
        self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12, *,
        flow_init: torch.Tensor | None = None, return_predictions: bool = False,
        dtype: torch.dtype | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """As ``RAFT.forward``: the inference path, or with
        ``return_predictions`` the differentiable one on the plain modules."""
        if not return_predictions:
            return super().forward(image1, image2, iters, flow_init=flow_init)
        with spans.span("zt.raft"):
            ub = self.update_block
            dtype = ub.dtype if dtype is None else dtype
            levels, net, inp, coords0 = self._encode(image1, image2, dtype)
            attn = self.att(inp, dtype)
            coords1 = coords0 if flow_init is None else coords0 + flow_init
            ups = []
            for _ in range(iters):
                coords1 = coords1.detach()
                corr = lookup_corr_reference(levels, coords1, CORR_RADIUS)
                net, mask, delta = ub(net, inp, corr, coords1 - coords0, attn, dtype)
                coords1 = coords1 + delta.float()
                ups.append(convex_upsample_flow(coords1 - coords0, mask))
            return coords1 - coords0, torch.stack(ups)

    def _infer(self, image1: torch.Tensor, image2: torch.Tensor, iters: int,
               flow_init: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The inference path: the attention once, then GMA's iterations on
        the operands ``prepare`` built."""
        ub = self.update_block
        levels, net, inp, coords0 = self._encode(image1, image2, ub.dtype)
        with spans.graph_span("zt.gma.attention"):
            attn = attention(inp, ub.kw["qk"])
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        for _ in range(iters):
            corr = lookup_corr(levels, coords1, CORR_RADIUS, ub.dtype)
            flow = coords1 - coords0
            net, delta = gma_core(ub.kw, net, inp, corr, ub.flow_features(flow), flow, attn)
            coords1 = coords1 + delta
        flow_low = coords1 - coords0
        return flow_low, convex_upsample_flow(flow_low, ub.mask_head(net))
