"""Device ms a warm-started pair between the stream markers of the
program's ``zt.raft`` spans around GMA's pass: the replay of its graph,
encoders, correlation pyramid, attention, the 32 iterations and the
upsample (``models/raft/raft.py::RAFT.flow_graphed`` on a ``RAFTGMA``)."""

from gma_spans import ms_per_pair


def read(summary: dict, config: dict) -> float | None:
    return ms_per_pair(summary, "zt.raft")
