"""A torch.profiler trace of a few units of work, reduced to what the
per-layer metrics read.

The grouping is ``chip_smoke.py::trace_path``'s: device operations by exact
name (``kernel_id``), busy time as the union of their intervals. Its window
is repaired: the window here is the host-clock span of the traced units (a
``record_function`` range around them, in the trace's own clock), so time
the host spends before the first kernel and after the last counts as idle.
Idle gaps are charged to the innermost host range open at their midpoint:
an ATen operation, a CUDA runtime call, or one of the harness's own ranges
(``bench.*``) where the host runs Python between calls.
"""

from __future__ import annotations

import heapq
import re

WINDOW = "bench.traced"
TOP = 10


def kernel_id(name: str) -> str:
    """A device kernel's qualified name without return type, template and
    parameters: 'void zt::gru_reset_kernel<float, float>(...)' -> 'zt::gru_reset_kernel'."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anonymous")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel launch, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def profile_units(run_unit, units: int) -> dict:
    """Trace ``run_unit(i)`` for i < units (each ends with its results on
    the host) and reduce the trace with ``summarize``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(units):
                with record_function("bench.unit"):
                    run_unit(i)
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # a record_function range is mirrored on the device's timeline as an
    # annotation: it is no device operation
    events = [(e.name, e.device_type == cuda and not (getattr(e, "is_user_annotation", False)
                                                      or e.name.startswith("bench.")),
               e.time_range.start, e.time_range.end) for e in prof.events()]
    return summarize(events, units)


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events: list[tuple[str, bool, float, float]], units: int) -> dict:
    """``events``: (name, on the device, start us, end us). Returns the
    window and busy seconds, each device operation name's seconds and count,
    the top device operations and the idle time by host range."""
    win = [(s, e) for name, dev, s, e in events if not dev and name == WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = win[0]
    device = [(name, max(s, w0), min(e, w1)) for name, dev, s, e in events if dev and e > s]
    outside = sum(1 for _, s, e in device if e <= s)
    device = [d for d in device if d[2] > d[1]]
    if not device:
        raise RuntimeError("the profiler recorded no device operation in the traced window")
    by_name: dict[str, list[float]] = {}
    for name, s, e in device:
        acc = by_name.setdefault(kernel_id(name), [0.0, 0])
        acc[0] += (e - s) / 1e6
        acc[1] += 1
    busy = _union([(s, e) for _, s, e in device])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    idle = _charge(gaps, [(s, e, name) for name, dev, s, e in events if not dev and e > s])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "units": units,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "ops": by_name,
        "kernels": sum(n for name, (_, n) in by_name.items() if is_kernel(name)),
        "device_ops": [[name, sec] for name, (sec, _) in top_ops],
        "idle_gaps": sorted(([name, sec] for name, sec in idle.items()), key=lambda kv: -kv[1])[:TOP],
        "outside_window": outside,
    }


def _charge(gaps: list[tuple[float, float]], host: list[tuple[float, float, str]]) -> dict[str, float]:
    """Seconds of idle time by the innermost host range open at each gap's midpoint."""
    host.sort()
    out: dict[str, float] = {}
    heap: list[tuple[float, float, str]] = []  # (-start, end, name): innermost on top
    i = 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host range)"
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out
