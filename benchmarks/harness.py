"""What every driver shares: the run's settings, the clock since the process
started, the cell's files found by name, and the per-layer metric readers.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose "driver" names
``drivers/<driver>.py``); its limits for ``correct`` are
``limits/<cell>.json`` and each per-layer metric is read by
``metrics/<metric>.py``. A new cell, mix, configuration or metric is new
files and new entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time, in clock ticks since boot, against CLOCK_BOOTTIME)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Run:
    """One run of one cell: what a driver is given."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool = False
    device: str = "cuda"
    min_units: int = 1  # the window runs at least this many units
    options: dict = field(default_factory=dict)  # a driver's extra settings (the calibration's)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    module_spec = importlib.util.spec_from_file_location(name, path)
    if module_spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def find_cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry, configuration, traffic, limits and driver path."""
    bench = bench or spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[cell["config"]]["file"])
    traffic = read_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "limits": read_json(BENCH / "limits" / f"{name}.json")["limits"],
        "driver": BENCH / "drivers" / f"{traffic['driver']}.py",
    }



def cell_metrics(name: str, kind: str, bench: dict | None = None) -> list[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those that list
    it, and those with no list whose end-to-end metric the cell reports."""
    bench = bench or spec()
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]


def read_per_layer(metrics: list[dict], summary: dict, config: dict) -> dict:
    """Each metric's reader, ``metrics/<name>.py::read(summary, config)``;
    a reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py", "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(summary, config)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
