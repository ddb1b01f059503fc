"""The program's own spans and counters of the traced units
(``zero_tig_torch/core/spans.py``), for the per-layer metrics that read
them.

The program records its ``zt.*`` spans while a profiler records, and each
profiler session starts its records anew, so after ``trace.profile_units``
they cover exactly the traced units. A program without the module, a
session in which it recorded nothing, or one whose count of unit spans
(``zt.infer.frame`` a streamed frame, ``zt.train.step`` a training step)
differs from the summary's frames gives no number.
"""

from __future__ import annotations

UNIT = {"stream": "zt.infer.frame", "train": "zt.train.step"}


def session(summary: dict, kind: str) -> tuple[list[dict], dict] | None:
    """(records, counters) of the session that traced a ``kind`` cell's units, or None."""
    if summary.get("kind") != kind:
        return None
    try:
        from zero_tig_torch.core import spans
    except ImportError:
        return None
    recs = spans.records()
    if not recs or sum(r["name"] == UNIT[kind] for r in recs) != summary["frames"]:
        return None
    return recs, spans.counters()


def ms_per_frame(summary: dict, kind: str, name: str, clock: str) -> float | None:
    """The ``clock`` ms ("host_ms" or "device_ms") of the spans called
    ``name``, summed, a traced frame or step."""
    found = session(summary, kind)
    if found is None:
        return None
    values = [r[clock] for r in found[0] if r["name"] == name]
    if not values or None in values:
        return None
    return sum(values) / summary["frames"]
