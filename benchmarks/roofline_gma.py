"""Roofline bounds of GMA's kernels at its configuration (``roofline.py``'s
peaks and bound).

K1's launches a pair are RAFT's (the ``raft.*`` rows of
``roofline.k1_layers``) with the GRU's four gate convolutions reading four
parts of 128 channels, [net | inp | mf | glob] (512), and one more launch
each iteration, ``to_v`` (1x1, 128 -> 128, f32 out, gamma folded): 10 an
iteration and 2 for the mask head, 322 at 32 iterations.

The mechanism's bound is its matrix products (``flops_gma.attention``:
the logits once a pair and the 32 aggregations) at the f32 peak; they run
in f32 whatever the precision. Its bytes (the 198 MB attention read 33
times, 1.95 ms at Sintel's grid) lie under it.
"""

from __future__ import annotations

from flops_gma import attention
from roofline import PEAK_F32, k1_bound_ms, k1_layers

GRU_PARTS = [128, 128, 128, 128]


def k1_layers_gma(cfg: dict) -> list[tuple]:
    """(name, kh, kw, input parts, Cout, (h, w), anchor parts, f32 output, launches a pair)."""
    rows = []
    for name, kh, kw, parts, cout, hw, anchor, out_f32, n in k1_layers(cfg):
        if not name.startswith("raft."):
            continue
        if name.startswith("raft.gru."):
            name, parts = "gma." + name[5:], GRU_PARTS
        rows.append((name, kh, kw, parts, cout, hw, anchor, out_f32, n))
        if name == "raft.conv":
            rows.append(("gma.to_v", 1, 1, [128], 128, hw, [], True, cfg["raft_iters"]))
    return rows


def k1_pair_bound_ms(cfg: dict) -> float:
    """The sum of a pair's K1 launch bounds, in ms."""
    return sum(k1_bound_ms(layer, cfg["precision"]) * layer[-1] for layer in k1_layers_gma(cfg))


def attention_bound_ms(cfg: dict) -> float:
    """The least time of the mechanism's matrix products a pair, in ms."""
    return attention(cfg) / PEAK_F32 * 1e3
