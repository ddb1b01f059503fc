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

Counters. ``COUNTS`` holds the launches of each kernel wrapper since
``reset_counts()``, always on: a wrapper adds one where it calls into the
kernel library, and nowhere else. K1's wrapper counts its two kernels
apart: ``fused_conv`` the tensor-core kernel (bf16 operands),
``fused_conv_f32`` the FMA kernel (f32 operands). The session counters
count only while a profiler records: ``k1.launches``, the calls of
``ops/fused_conv.py::launch_k1``, and ``k1.host_ns``, the host time inside
them from entry to return. ``counters()`` returns both kinds.

Spans nest on one thread: the program opens them on the thread that calls
its entry points (autograd's backward opens none).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _prof

COUNTS = {"fused_conv": 0, "fused_conv_f32": 0, "gru": 0, "equalize_u8": 0, "conv3x3_bf16": 0}
_SESSION = {"k1.launches": 0, "k1.host_ns": 0}

_NULL = contextlib.nullcontext()
_records: list[list] = []  # [name, parent index, host start ns, host end ns, start event, end event]
_open: list[int] = []  # indices of the open records, innermost last
_events: list = []  # the timing events' pool; the first _used are this session's
_used = 0
_session = 0  # profiler sessions started since import


def _on_profiler_start(_start=_prof._run_on_profiler_start) -> None:
    global _session, _used
    _session += 1
    _records.clear()
    _open.clear()
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
    for k in COUNTS:
        COUNTS[k] = 0


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
        self.rec = [self.name, _open[-1] if _open else None, time.perf_counter_ns(), None, ev, None]
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


def count_k1(host_ns: int) -> None:
    """One K1 launch that took ``host_ns`` on the host (while recording)."""
    _SESSION["k1.launches"] += 1
    _SESSION["k1.host_ns"] += host_ns


def records() -> list[dict]:
    """This session's spans in the order they opened: name, parent (an index
    into this list, or None), host ms and device ms (None without CUDA
    events; either None while the span is open). Synchronises the device."""
    if any(r[5] is not None for r in _records):
        torch.cuda.synchronize()
    return [{"name": name, "parent": parent,
             "host_ms": None if t1 is None else (t1 - t0) / 1e6,
             "device_ms": None if e1 is None else e0.elapsed_time(e1)}
            for name, parent, t0, t1, e0, e1 in _records]


def counters() -> dict[str, int]:
    """The launch counts since ``reset_counts()`` and this session's counters."""
    return {**COUNTS, **_SESSION}
