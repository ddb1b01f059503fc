"""Device kernels a streamed frame launches (copies and fills left out), from
the trace: what the host has to dispatch for ``predict_chunk``."""


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "stream":
        return None
    return summary["kernels"] / summary["frames"]
