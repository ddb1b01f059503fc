"""The share, in %, of the traced pairs that started from the previous
pair's forward-interpolated flow: the program's session counters
``flowseq.warm_starts`` over ``flowseq.pairs``
(``flowtools/sequence.py::flow_chunk``). The traced chunks lie inside a
scene, so under 100 means the warm start was bypassed."""

from flowseq_spans import session


def read(summary: dict, config: dict) -> float | None:
    found = session(summary)
    if found is None or not found[1].get("flowseq.pairs"):
        return None
    counts = found[1]
    return 100.0 * counts["flowseq.warm_starts"] / counts["flowseq.pairs"]
