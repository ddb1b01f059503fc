"""The whole streamed frame's share of the card's peak, in %: the model FLOP
a frame (``flops.py``) over the window's ms a frame, untraced, times the peak
of the configuration's operand type (``roofline.py``)."""

from flops import infer_frame
from roofline import peak_flops


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "stream":
        return None
    return 100.0 * infer_frame(config) / (summary["untraced_ms_per_frame"] * 1e-3 * peak_flops(config["precision"]))
