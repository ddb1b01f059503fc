"""Spans and counters of the port, on the profiler's clock.

``span(name)`` marks a stretch of the program (``zt.*``: the entry points,
the model's modules, the loss, backward and the optimizer). While a
``torch.profiler`` session records, a span

- opens a ``record_function`` range, so it lies in the profiler's trace on
  the clock of the device kernels;
- takes the host clock at entry and exit;
- where CUDA is in use, records a timing event on the current stream at
  entry and at exit (from a pool reused across sessions);
- appends one record: name, parent record, host start and end, the events.

With no profiler recording, ``span`` returns one shared null context and
does nothing else: its cost is one read of the profiler's own flag.

Recording starts empty with each profiler session: its start clears the
records and the session counters, so they cover exactly the work the
profiler traced. ``records()`` gives each span's name, parent, host ms and
device ms (the device-clock interval between its two events: the layer's
device time where the device is the bottleneck, how long the layer held
the stream where the host is).

Spans inside a CUDA graph. ``graph_span(name)`` is ``span(name)``, except
while a graph is captured under ``capturing()``: there it records a pair
of timing events into the graph (``torch.cuda.Event(enable_timing=True,
external=True)``, two event-record nodes) and adds (name, start, end) to
the capture's list, whether or not a profiler records. The graph's owner
keeps that list and, around each replay made while a profiler records,
calls ``before_replay()`` and then ``replayed(list)``: each captured span
appends one record, a child of the innermost open span, with no host clock
(host ms None) and the device ms between its two events in that replay.
The events hold one replay's times, so the records of a replay are read
before the next replay (which waits for the last of its events) or in
``records()``. Graph spans run only in GMA's pass
(``models/raft/gma.py``): RAFT's graph has no such nodes.

Counters. ``COUNTS`` holds the launches of each kernel wrapper since
``reset_counts()``, always on: a wrapper adds one where it calls into the
kernel library, and nowhere else. K1's wrapper counts its two kernels
apart: ``fused_conv`` the tensor-core kernel (bf16 operands),
``fused_conv_f32`` the FMA kernel (f32 operands); ``fused_conv_f32_grid``
counts those FMA launches whose tiling the grid rule of
``ops/fused_conv.py::_fma_plan`` chose (every f32 launch off the 1080p
branch: RAFT's and GMA's update grids), at the same dispatch
(``launch_k1``). ``corr_lookup`` counts
RAFT's correlation lookups on the card (``models/raft/corr.py::lookup_corr``,
one an iteration of the inference pass), and ``gma_aggregate`` GMA's
aggregations (``models/raft/gma.py::aggregate``, one an iteration of its
inference pass, on either device). A launch that a CUDA graph's
capture records counts like any other; a graph's replay calls no
wrapper and counts nothing there. ``GRAPHS``, also always on and reset with
them, counts the captures (``raft_graph_capture``) and replays
(``raft_graph_replay``) of RAFT's inference graph
(``models/raft/raft.py::RAFT.flow_graphed``). The session counters count
only while a profiler records: ``k1.launches``, the calls of
``ops/fused_conv.py::launch_k1``, and ``k1.host_ns``, the host time inside
them from entry to return; ``raft.calls``, the calls of ``flow_graphed``,
and ``raft.graph_replays``, those that replayed; ``flowseq.pairs``, the
pairs ``flowtools/sequence.py::flow_chunk`` computed, and
``flowseq.warm_starts``, those of them that started from the previous
pair's forward-interpolated flow. ``counters()`` returns ``COUNTS`` and
the session counters.

Spans nest on one thread: the program opens them on the thread that calls
its entry points (autograd's backward opens none).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _prof

COUNTS = {"fused_conv": 0, "fused_conv_f32": 0, "fused_conv_f32_grid": 0, "gru": 0, "equalize_u8": 0,
          "conv3x3_bf16": 0, "corr_lookup": 0, "gma_aggregate": 0}
GRAPHS = {"raft_graph_capture": 0, "raft_graph_replay": 0}
_SESSION = {"k1.launches": 0, "k1.host_ns": 0, "raft.calls": 0, "raft.graph_replays": 0,
            "flowseq.pairs": 0, "flowseq.warm_starts": 0}

_NULL = contextlib.nullcontext()
# [name, parent index, host start ns, host end ns, start event, end event, a graph span's device ms]
_records: list[list] = []
_open: list[int] = []  # indices of the open records, innermost last
_events: list = []  # the timing events' pool; the first _used are this session's
_used = 0
_session = 0  # profiler sessions started since import
_pending: list[tuple] = []  # (record, start, end) of replayed graph spans whose device ms is not read yet
_captured: list | None = None  # the graph spans of the capture under way, else None


def _on_profiler_start(_start=_prof._run_on_profiler_start) -> None:
    global _session, _used
    _session += 1
    _records.clear()
    _open.clear()
    _pending.clear()
    _used = 0
    for k in _SESSION:
        _SESSION[k] = 0
    _start()


# every profiler session (torch.profiler, autograd.profiler, emit_nvtx)
# starts through this module function: recording starts empty with each
_prof._run_on_profiler_start = _on_profiler_start


def on() -> bool:
    """Whether a profiler session records: the switch of the spans and the
    session counters."""
    return _prof._is_profiler_enabled


def reset_counts() -> None:
    for counts in (COUNTS, GRAPHS):
        for k in counts:
            counts[k] = 0


def _event():
    global _used
    if _used == len(_events):
        _events.append(torch.cuda.Event(enable_timing=True))
    ev = _events[_used]
    _used += 1
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "range", "rec", "session")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = _prof.record_function(self.name)
        self.range.__enter__()
        ev = _event() if torch.cuda.is_initialized() else None
        self.session = _session
        self.rec = [self.name, _open[-1] if _open else None, time.perf_counter_ns(), None, ev, None, None]
        _open.append(len(_records))
        _records.append(self.rec)
        return self

    def __exit__(self, *exc):
        if self.session == _session:  # no session started inside the span
            if self.rec[4] is not None:
                self.rec[5] = _event()
            self.rec[3] = time.perf_counter_ns()
            _open.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one stretch of the program: a recorded span
    while a profiler session records, else the shared null context."""
    if not _prof._is_profiler_enabled:
        return _NULL
    return _Span(name)


class _GraphSpan:
    """A span inside a capture: its two timing events become graph nodes."""

    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        _captured.append((self.name, self.start, end))
        return False


def graph_span(name: str):
    """``span(name)``, or inside a capture under ``capturing()`` a span
    recorded into the graph (see the module docstring)."""
    if _captured is not None and torch.cuda.is_current_stream_capturing():
        return _GraphSpan(name)
    return span(name)


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture: yields the list that collects the
    (name, start event, end event) of each graph span the capture records."""
    global _captured
    outer, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = outer


def _read_pending() -> None:
    """Fill in the device ms of the replayed graph spans (waits for their events)."""
    for rec, start, end in _pending:
        end.synchronize()
        rec[6] = start.elapsed_time(end)
    _pending.clear()


def before_replay() -> None:
    """Before a replay of a graph with graph spans: read the device ms of the
    spans earlier replays recorded, before this one overwrites their events."""
    if _pending:
        _read_pending()


def replayed(captured: list) -> None:
    """After a replay of a graph whose capture recorded ``captured`` graph
    spans: one record each while a profiler records."""
    if not _prof._is_profiler_enabled:
        return
    parent = _open[-1] if _open else None
    for name, start, end in captured:
        rec = [name, parent, None, None, None, None, None]
        _records.append(rec)
        _pending.append((rec, start, end))


def count_k1(host_ns: int) -> None:
    """One K1 launch that took ``host_ns`` on the host (while recording)."""
    _SESSION["k1.launches"] += 1
    _SESSION["k1.host_ns"] += host_ns


def count_raft(replayed: bool) -> None:
    """One call of RAFT's graphed inference path, ``replayed`` or run
    eagerly (while recording)."""
    if _prof._is_profiler_enabled:
        _SESSION["raft.calls"] += 1
        _SESSION["raft.graph_replays"] += replayed


def count_flowseq(warm: bool) -> None:
    """One pair of a flow sequence, ``warm``-started or not (while recording)."""
    if _prof._is_profiler_enabled:
        _SESSION["flowseq.pairs"] += 1
        _SESSION["flowseq.warm_starts"] += warm


def records() -> list[dict]:
    """This session's spans in the order they opened: name, parent (an index
    into this list, or None), host ms and device ms (None without CUDA
    events; either None while the span is open; host ms None for a graph
    span). Synchronises the device."""
    if any(r[5] is not None for r in _records):
        torch.cuda.synchronize()
    _read_pending()
    return [{"name": name, "parent": parent,
             "host_ms": None if t1 is None else (t1 - t0) / 1e6,
             "device_ms": ms if e1 is None else e0.elapsed_time(e1)}
            for name, parent, t0, t1, e0, e1, ms in _records]


def counters() -> dict[str, int]:
    """The launch counts since ``reset_counts()`` and this session's counters."""
    return {**COUNTS, **_SESSION}
