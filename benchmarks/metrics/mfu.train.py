"""The whole training step's share of the card's peak, in %: the training
FLOP a step (``flops.py``) over the window's ms a step, untraced, times the
peak of the configuration's operand type (``roofline.py``)."""

from flops import train_step
from roofline import peak_flops


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "train":
        return None
    return 100.0 * train_step(config) / (summary["untraced_ms_per_frame"] * 1e-3 * peak_flops(config["precision"]))
