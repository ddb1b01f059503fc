"""The whole GMA pair's share of the card's peak, in %: GMA's FLOP a pair
(``flops_gma.gma``: RAFT's pass, the wider GRU, the attention and the 32
aggregations, 2.0690 TFLOP at Sintel's size) over the window's ms a flow,
untraced, times the peak of the configuration's operand type
(``roofline.py``)."""

from flops_gma import gma
from roofline import peak_flops


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "gma":
        return None
    return 100.0 * gma(config) / (summary["untraced_ms_per_frame"] * 1e-3 * peak_flops(config["precision"]))
