"""The program's spans and counters of a flow-sequence cell's traced chunks
(``zero_tig_torch/core/spans.py``, recorded by
``flowtools/sequence.py::flow_chunk``), for the per-layer metrics that read
them: ``program_spans.py`` for the ``flowseq`` kind, whose unit span is
``zt.flowseq.pair``, one a flow.

A program without the module, a session in which it recorded nothing, or
one whose count of pair spans differs from the summary's flows gives no
number.
"""

from __future__ import annotations

UNIT = "zt.flowseq.pair"


def session(summary: dict) -> tuple[list[dict], dict] | None:
    """(records, counters) of the session that traced a flowseq cell's chunks, or None."""
    if summary.get("kind") != "flowseq":
        return None
    try:
        from zero_tig_torch.core import spans
    except ImportError:
        return None
    recs = spans.records()
    if not recs or sum(r["name"] == UNIT for r in recs) != summary["frames"]:
        return None
    return recs, spans.counters()


def ms_per_pair(summary: dict, name: str) -> float | None:
    """The device ms of the spans called ``name``, summed, a traced pair."""
    found = session(summary)
    if found is None:
        return None
    values = [r["device_ms"] for r in found[0] if r["name"] == name]
    if not values or None in values:
        return None
    return sum(values) / summary["frames"]
