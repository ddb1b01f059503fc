"""Device kernels a training step launches (copies and fills left out), from
the trace: what the host has to dispatch for ``train_step``."""


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "train":
        return None
    return summary["kernels"] / summary["frames"]
