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
kernel) and the lookup's plain twin (the lookup kernel has no backward),
``coords1`` detached at the top of each iteration and the mask head
run each iteration. The cnet's BatchNorm stays on its running statistics.

``flow_init`` (B, h, w, 2) f32 at the 1/8 grid is the warm start of the
reference's ``RAFT.forward(..., flow_init)``: added to ``coords1`` before the
first iteration, so both returned flows include it.

``flow_graphed`` is the inference path for the Zero-TIG network
(``models/network.py::update_cache``) and for warm-started flow along a
sequence (``flowtools/sequence.py::flow_chunk``): on a card it captures the
whole pass, padding to convex upsample, as one CUDA graph and replays it on
later calls, so a pass's launches (the encoders, the correlation pyramid,
the iterations of 13 hand-written kernels with their ATen glue, the mask
head) cost the host one graph launch. The graph belongs to its ``RAFT`` and
goes with it; ``graph_key`` says when it is captured again.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...core import spans
from ...ops.padding import pad8_replicate
from ...ops.sampling import coords_grid
from .corr import build_corr_pyramid, lookup_corr, lookup_corr_reference
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
        self._graph: _FlowGraph | None = None

    def prepare(self, dtype: torch.dtype) -> dict:
        """The inference path's weight operands in ``dtype``: the update
        block's (``BasicUpdateBlock.prepare``), built again only when its own
        weights or the dtype changed; the encoders read their parameters."""
        return self.update_block.prepare(dtype)

    def forward(
        self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12, *,
        flow_init: torch.Tensor | None = None, return_predictions: bool = False,
        dtype: torch.dtype | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(flow_low, flow_up) between (B, H, W, 3) frames in [0, 255]; with
        ``return_predictions``, (flow_low, (iters, B, 8h, 8w, 2) flows).
        ``flow_init``: the warm start, (B, h, w, 2) f32 at the 1/8 grid.
        ``dtype``: the training path's working dtype (the inference path
        takes the one ``prepare`` last set)."""
        with spans.span("zt.raft"):
            if not return_predictions:
                return self._infer(image1, image2, iters, flow_init)
            ub = self.update_block
            dtype = ub.dtype if dtype is None else dtype
            levels, net, inp, coords0 = self._encode(image1, image2, dtype)
            coords1 = coords0 if flow_init is None else coords0 + flow_init
            ups = []
            for _ in range(iters):
                coords1 = coords1.detach()
                corr = lookup_corr_reference(levels, coords1, CORR_RADIUS)  # differentiable
                net, mask, delta = ub(net, inp, corr, coords1 - coords0, dtype)
                coords1 = coords1 + delta.float()
                ups.append(convex_upsample_flow(coords1 - coords0, mask))
            return coords1 - coords0, torch.stack(ups)

    def _encode(self, image1: torch.Tensor, image2: torch.Tensor, dtype: torch.dtype):
        """Padding, both encoders and the correlation pyramid: (levels, net,
        inp, coords0)."""
        image1 = 2.0 * (pad8_replicate(image1) / 255.0) - 1.0
        image2 = 2.0 * (pad8_replicate(image2) / 255.0) - 1.0
        b = image1.shape[0]
        pair = torch.cat([image1.float(), image2.float()]).permute(0, 3, 1, 2)
        fmaps = self.fnet(pair, dtype).permute(0, 2, 3, 1)
        levels = build_corr_pyramid(fmaps[:b], fmaps[b:], CORR_LEVELS, dtype)

        cnet = self.cnet(image1.permute(0, 3, 1, 2), dtype).permute(0, 2, 3, 1)
        net = torch.tanh(cnet[..., :HIDDEN_DIM]).contiguous()
        inp = torch.relu(cnet[..., HIDDEN_DIM:]).contiguous()
        return levels, net, inp, coords_grid(b, net.shape[1], net.shape[2], device=net.device)

    def _infer(self, image1: torch.Tensor, image2: torch.Tensor, iters: int,
               flow_init: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The inference path: K2 on the operands ``prepare`` built, each
        iteration's windows from the lookup kernel in the working dtype."""
        ub = self.update_block
        levels, net, inp, coords0 = self._encode(image1, image2, ub.dtype)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        for _ in range(iters):
            corr = lookup_corr(levels, coords1, CORR_RADIUS, ub.dtype)
            flow = coords1 - coords0
            net, delta = update_core(ub.kw, net, inp, corr, ub.flow_features(flow), flow)
            coords1 = coords1 + delta
        flow_low = coords1 - coords0
        return flow_low, convex_upsample_flow(flow_low, ub.mask_head(net))

    def graph_key(self, image1: torch.Tensor, image2: torch.Tensor, iters: int,
                  flow_init: torch.Tensor | None = None) -> tuple:
        """What a captured inference pass holds fixed besides the weights'
        addresses: each input's shape, strides, dtype and device (None for
        an absent ``flow_init``), ``iters``, the prepared dtype and operands
        (``prepare`` builds new ones when the update block's weights or the
        precision change) and the two TF32 switches
        (``core/precision.py::numerics``)."""
        ub = self.update_block
        return (
            *(None if t is None else (tuple(t.shape), t.stride(), t.dtype, t.device)
              for t in (image1, image2, flow_init)),
            iters, ub.dtype, id(ub.kw),
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
        )

    def flow_graphed(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                     flow_init: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``forward(image1, image2, iters, flow_init=flow_init)``, the
        inference path's (flow_low, flow_up), equal to it bit for bit. On a
        card the first call with a new ``graph_key`` runs the pass eagerly,
        on a side stream, and captures it; the next calls with that key copy
        the inputs (``flow_init`` too, where given) into the graph's own and
        replay it. A replay hands back the graph's static outputs, which the
        next call overwrites: use them before calling again. While a
        profiler records nothing is captured (its ranges and events would
        become graph nodes): the pass runs eagerly until a capture exists.
        On the CPU this is ``forward``. The operands are brought up to date
        first, in the dtype ``prepare`` last set."""
        self.prepare(self.update_block.dtype)
        g = self._graph
        if image1.device.type == "cuda":
            key = self.graph_key(image1, image2, iters, flow_init)
            if g is not None and g.key == key:
                spans.count_raft(replayed=True)
                with spans.span("zt.raft"):
                    return g.replay(image1, image2, flow_init)
            if not spans.on():
                self._graph = None  # the old graph's memory goes before the new one's fills
                self._graph, flows = _FlowGraph.capture(self, key, image1, image2, iters, flow_init)
                return flows
        spans.count_raft(replayed=False)
        return self(image1, image2, iters, flow_init=flow_init)


# One capture stream a card for the whole process, as torch.cuda.graph keeps
# one: every stream that runs a cuBLAS call keeps a workspace of its own (32
# MiB on the H100) for the life of the process, so a new stream for each
# capture would leave one more behind each time.
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream that captures RAFT's graphs on ``dev``. It comes from the
    high-priority pool, which nothing else in the port draws from, so no
    other thread's work (the prefetcher's copies) lands in a capture."""
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev, priority=-1)
    return _CAPTURE_STREAMS[dev]


@dataclasses.dataclass
class _FlowGraph:
    """One captured inference pass of a RAFT: its key, the operands it
    reads (held so that the key's ``id`` stays theirs), the static inputs
    (the two images and, where the pass has one, ``flow_init``) and outputs
    (flow_low, flow_up), and the spans the capture recorded into the graph
    (``core/spans.py::graph_span``; none in RAFT's own pass). The pass's
    intermediates live in the graph's private memory pool."""

    key: tuple
    kw: dict
    graph: torch.cuda.CUDAGraph
    inputs: tuple[torch.Tensor, ...]
    outputs: tuple[torch.Tensor, torch.Tensor]
    graph_spans: list

    @classmethod
    @torch.no_grad()
    def capture(cls, raft: RAFT, key: tuple, image1: torch.Tensor, image2: torch.Tensor, iters: int,
                flow_init: torch.Tensor | None) -> tuple["_FlowGraph", tuple[torch.Tensor, torch.Tensor]]:
        """(the graph, this call's (flow_low, flow_up)). The pass runs once
        eagerly on the capture stream, which builds what the kernels set up
        at their first launch (the kernel library, shared-memory limits,
        cuDNN and cuBLAS state for that stream); its answer is this call's.
        Then it is captured from copies of the inputs."""
        dev = image1.device
        main = torch.cuda.current_stream(dev)
        side = _capture_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            flows = raft._infer(image1, image2, iters, flow_init)
        main.wait_stream(side)
        for t in flows:
            t.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        # plain tensors even inside inference mode (a training step copies into
        # them too), and no autograd record (inference_mode(False) turns grad
        # mode on; the lookup kernel refuses levels that require grad)
        with torch.inference_mode(False), torch.no_grad():
            inputs = tuple(t.clone() for t in (image1, image2, flow_init) if t is not None)
            with spans.capturing() as graph_spans, torch.cuda.graph(graph, stream=side,
                                                                    capture_error_mode="thread_local"):
                outputs = raft._infer(*inputs[:2], iters, *inputs[2:])
        spans.GRAPHS["raft_graph_capture"] += 1
        return cls(key, raft.update_block.kw, graph, inputs, outputs, graph_spans), flows

    def replay(self, image1: torch.Tensor, image2: torch.Tensor,
               flow_init: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
        for static, t in zip(self.inputs, (image1, image2, flow_init)):
            static.copy_(t)
        if self.graph_spans:
            spans.before_replay()
        self.graph.replay()
        spans.replayed(self.graph_spans)
        spans.GRAPHS["raft_graph_replay"] += 1
        return self.outputs
