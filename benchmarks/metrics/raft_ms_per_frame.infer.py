"""Device ms a streamed frame between the stream markers of the program's
``zt.raft`` spans (``models/raft/raft.py``: encoders, correlation pyramid,
the 12 K2 iterations, upsample): RAFT's device time where the device sets
the pace, how long RAFT held the stream where the host does."""

from program_spans import ms_per_frame


def read(summary: dict, config: dict) -> float | None:
    return ms_per_frame(summary, "stream", "zt.raft", "device_ms")
