"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 benchmarks/run.py --workload CELL --seed N --seconds S --trace 0|1

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer ones, read from a torch.profiler trace of a few
units after the window, with the device's busy and window seconds and the
trace's breakdown. It runs on the CUDA card this process sees and exits
non-zero, printing no result, without one. The numbers that decided
``correct`` close standard error and the result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# one host thread: nothing in the window computes on the host's CPU, and a
# thread pool only adds load that spreads the host-bound cells' times
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [str(BENCH), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "zero_tig_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    import check
    import harness

    bench = harness.spec()
    found = harness.find_cell(args.workload, bench)
    chips = found["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); this process sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    driver = harness.load_module(found["driver"], "bench_driver")
    run = harness.Run(cell=args.workload, config=found["config"], traffic=found["traffic"], limits=found["limits"],
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    out = driver.run(run)

    left = forbidden_modules()
    if left:
        harness.log(f"the process holds modules it must not: {left}")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        s = out["summary"]
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["metrics"] = harness.read_per_layer(harness.cell_metrics(args.workload, "per_layer", bench), s,
                                                   found["config"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
        harness.log(f"trace: {s['units']} units, busy {s['busy_s']!r} of {s['window_s']!r} s, "
                    f"{s['kernels']} kernels, {s['outside_window']} device operations outside the window")
    else:
        metrics = {}
        for m in harness.cell_metrics(args.workload, "end_to_end", bench):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = device
    result["checks"] = out["checks"]
    check.print_checks(out["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
