"""The whole pair's share of the card's peak, in %: RAFT's FLOP a pair
(``flops.raft``: both encoders at the padded size, the correlation volume and
every iteration) over the window's ms a flow, untraced, times the peak of the
configuration's operand type (``roofline.py``)."""

from flops import raft
from roofline import peak_flops


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "flowseq":
        return None
    return 100.0 * raft(config) / (summary["untraced_ms_per_frame"] * 1e-3 * peak_flops(config["precision"]))
