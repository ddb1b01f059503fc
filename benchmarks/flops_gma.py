"""GMA's model FLOP a pair at its Sintel evaluation, counted as ``flops.py``
counts RAFT's: RAFT's pass (``flops.raft``), the GRU's gate convolutions
widened from 384 to 512 input channels, the attention's ``to_qk`` and
logits (2 x positions^2 x 128) once a pair, and each iteration's ``to_v``
and aggregation (2 x positions^2 x 128). The softmax, the residual add and
the concatenations are left out, as RAFT's elementwise work is.
"""

from __future__ import annotations

from flops import conv, raft
from roofline import raft_grid

DIM_HEAD = 128


def attention(cfg: dict) -> float:
    """The logits once a pair and every iteration's aggregation: the GMA
    mechanism's matrix products."""
    gh, gw = raft_grid(cfg)
    n = gh * gw
    return 2.0 * n * n * DIM_HEAD * (1 + cfg["raft_iters"])


def gma(cfg: dict) -> float:
    gh, gw = raft_grid(cfg)
    wider = 2 * (conv(gh, gw, (1, 5), 128, 256) + conv(gh, gw, (1, 5), 128, 128))  # the GRU's 128 more inputs
    per_iter = wider + conv(gh, gw, (1, 1), 128, DIM_HEAD)  # + to_v
    return raft(cfg) + cfg["raft_iters"] * per_iter + conv(gh, gw, (1, 1), 128, 2 * DIM_HEAD) + attention(cfg)
