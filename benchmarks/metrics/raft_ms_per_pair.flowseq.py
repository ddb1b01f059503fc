"""Device ms a warm-started pair between the stream markers of the
program's ``zt.raft`` spans (``models/raft/raft.py``: the replay of RAFT's
graph, encoders, correlation pyramid, the iterations and the upsample)."""

from flowseq_spans import ms_per_pair


def read(summary: dict, config: dict) -> float | None:
    return ms_per_pair(summary, "zt.raft")
