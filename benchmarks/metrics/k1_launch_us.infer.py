"""Host us a K1 launch in a streamed frame: the program's session counters
``k1.host_ns`` over ``k1.launches`` (``ops/fused_conv.py::launch_k1`` from
entry to return: checks, plan, the packed record, the ctypes call)."""

from program_spans import session


def read(summary: dict, config: dict) -> float | None:
    found = session(summary, "stream")
    if found is None or not found[1].get("k1.launches"):
        return None
    counts = found[1]
    return counts["k1.host_ns"] / counts["k1.launches"] / 1e3
