"""Device ms a warm-started pair of GMA's mechanism: the program's graph
spans ``zt.gma.attention`` (``to_qk``, the logits and the softmax, once a
pair) and ``zt.gma.aggregate`` (each iteration's ``attn @ v`` with the
residual), summed (``models/raft/gma.py``, timed by the events the
capture recorded into the graph)."""

from gma_spans import ms_per_pair


def read(summary: dict, config: dict) -> float | None:
    return ms_per_pair(summary, "zt.gma.attention", "zt.gma.aggregate")
