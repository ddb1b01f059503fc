"""The share of the traced chunks' host-clock span in which no operation ran
on the device, in %: the graph's replays, the warm start's launches between
them and the copies of frames and flows."""


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "flowseq":
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
