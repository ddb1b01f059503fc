"""Warm-started RAFT flow along video sequences, on the graphed inference path.

RAFT's published Sintel evaluation (princeton-vl/RAFT
``evaluate.py::create_sintel_submission`` with ``--warm_start``) as a chunked
entry point: ``flow_chunk(model, frames, carry, flags, iters)`` takes n uint8
frames on the card with a host ``is_new_seq`` flag each and gives the flow of
every frame that has a predecessor in its sequence. For each such pair:

1. the new frame is replicate-padded to multiples of 8, centred
   (``InputPadder``; ``ops/padding.py::pad8_replicate``); the previous one,
   padded, comes from the carry;
2. ``RAFT.flow_graphed`` with ``flow_init``: the previous pair's forward-
   interpolated 1/8 flow, or zero on a sequence's first pair (a zero warm
   start gives what none gives, bit for bit, and keeps one graph key);
3. the full-resolution flow is cut back to the frame (``InputPadder.unpad``);
4. ``ops/splat.py::forward_interpolate`` of the pair's 1/8 flow becomes the
   next pair's ``flow_init``.

``model`` is a RAFT or a GMA (``models/raft/gma.py::RAFTGMA``, a RAFT
whose graphed pass holds the attention and the aggregations).

A flagged frame starts a sequence: it gives no flow and resets the warm
start to zero. Nothing in a chunk copies to the host or waits for the
device. The weight operands come from ``registry.prepare_raft``, as
``registry._raft_forward``'s do, and the chunk runs under
``numerics(precision)`` without gradients.

Spans: ``zt.flowseq.chunk`` around a call, ``zt.flowseq.pair`` around a pair,
``zt.flowseq.warm`` around its forward interpolation (outside the graph),
``zt.raft`` inside ``flow_graphed``; session counters ``flowseq.pairs`` and
``flowseq.warm_starts``.
"""

from __future__ import annotations

import torch

from ..core import spans
from ..core.precision import numerics
from ..models.raft.raft import RAFT
from ..ops.padding import pad8_amounts, pad8_replicate
from ..ops.splat import forward_interpolate
from .registry import prepare_raft


def flow_chunk(
    model: RAFT, frames: torch.Tensor, carry: dict, flags, iters: int = 32, precision: str = "highest",
) -> tuple[tuple[torch.Tensor, torch.Tensor], dict]:
    """frames (n, B, H, W, 3) uint8 on the model's device; ``flags`` n host
    booleans (``is_new_seq``); ``carry`` {} before the first sequence, else
    what the last call returned.

    Returns ((flows (m, B, H, W, 2), flows_low (m, B, H8, W8, 2)), carry),
    f32, one row for each of the m frames with a predecessor in its sequence,
    in order: the flow at the frame's size and RAFT's 1/8 flow on the padded
    grid. The carry holds "frame" (the last frame, padded, f32), "flow_low"
    (the last pair's 1/8 flow, None after a reset) and "flow_init" (the next
    pair's warm start)."""
    flags = [bool(f) for f in flags]
    n, b, h, w, _ = frames.shape
    if len(flags) != n:
        raise ValueError(f"{n} frames but {len(flags)} flags")
    if flags and not flags[0] and "frame" not in carry:
        raise ValueError("the first frame of the first chunk must start a sequence (is_new_seq)")
    top, _, left, _ = pad8_amounts(h, w)
    grid = (b, -(-h // 8), -(-w // 8), 2)
    m = n - sum(flags)
    flows = torch.empty(m, b, h, w, 2, device=frames.device)
    lows = torch.empty(m, *grid, device=frames.device)
    prepare_raft(model, precision)
    j = 0
    with spans.span("zt.flowseq.chunk"), torch.no_grad(), numerics(precision):
        for k in range(n):
            image = pad8_replicate(frames[k].float())
            if flags[k]:
                carry = {"frame": image, "flow_low": None, "flow_init": torch.zeros(grid, device=frames.device)}
                continue
            with spans.span("zt.flowseq.pair"):
                spans.count_flowseq(warm=carry["flow_low"] is not None)
                low, up = model.flow_graphed(carry["frame"], image, iters, carry["flow_init"])
                flows[j].copy_(up[:, top:top + h, left:left + w])
                lows[j].copy_(low)  # a replay's outputs are overwritten by the next one
                with spans.span("zt.flowseq.warm"):
                    carry = {"frame": image, "flow_low": lows[j], "flow_init": forward_interpolate(lows[j])}
            j += 1
    return (flows, lows), carry
