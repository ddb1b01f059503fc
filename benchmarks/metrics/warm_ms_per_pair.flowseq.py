"""Device ms a pair between the stream markers of the program's
``zt.flowseq.warm`` spans: the forward interpolation of the pair's 1/8 flow
(``ops/splat.py``), outside RAFT's graph, that warm-starts the next pair."""

from flowseq_spans import ms_per_pair


def read(summary: dict, config: dict) -> float | None:
    return ms_per_pair(summary, "zt.flowseq.warm")
