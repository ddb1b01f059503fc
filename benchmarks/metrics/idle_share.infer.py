"""The share of the traced chunks' host-clock span in which no operation ran
on the device, in %."""


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "stream":
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
