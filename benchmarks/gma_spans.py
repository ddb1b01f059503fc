"""The program's spans of a GMA flow-sequence cell's traced chunks
(``zero_tig_torch/core/spans.py``), for the per-layer metrics that read
them: the unit span is ``zt.flowseq.pair``, one a flow; ``zt.raft`` holds
the graph's replay, and inside it the graph spans ``zt.gma.attention``
(once a pair) and ``zt.gma.aggregate`` (once an iteration), each a pair of
timing events captured into the graph and read after each traced replay.

A summary of another kind, a program without the module, a session in
which it recorded nothing, one whose count of pair spans differs from the
summary's flows, or a span without a device time gives no number.
"""

from __future__ import annotations

UNIT = "zt.flowseq.pair"
KIND = "gma"


def ms_per_pair(summary: dict, *names: str) -> float | None:
    """The device ms of the spans called any of ``names``, summed, a traced
    pair; None unless each name recorded at least once."""
    if summary.get("kind") != KIND:
        return None
    try:
        from zero_tig_torch.core import spans
    except ImportError:
        return None
    recs = spans.records()
    if not recs or sum(r["name"] == UNIT for r in recs) != summary["frames"]:
        return None
    values = {n: [r["device_ms"] for r in recs if r["name"] == n] for n in names}
    if not all(values.values()) or any(None in v for v in values.values()):
        return None
    return sum(sum(v) for v in values.values()) / summary["frames"]
