"""Readings that set a cell's limits for ``correct``: the program's, and its
controls', over many seeds in one process.

    python3 benchmarks/calibrate.py --workload CELL --seeds 12 --first-seed N \\
        [--controls tf32 fp8 half_rows] [--out DIR]

For each seed it runs the cell's driver with no measured window (one scene,
or the training checks' steps, and one unit), then each control in the
program's place: the reference in a lower operand precision ("tf32" or
"fp8") or, for training, with its loss over half of each map's rows
("half_rows"). It prints one line of readings per seed and side, and writes
them all to DIR/<cell>.json.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1 << 31)
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    found = harness.find_cell(args.workload)
    driver = harness.load_module(found["driver"], "bench_driver")
    tr = found["traffic"]
    units = tr["scene_frames"] // tr["chunk"] if tr["driver"] == "stream" else 1
    rows = []
    for n in range(args.seeds):
        seed = args.first_seed + 7919 * n
        run = harness.Run(cell=args.workload, config=found["config"], traffic=tr, limits=found["limits"], seed=seed,
                          seconds=0.0, min_units=units, options={"controls": args.controls})
        out = driver.run(run)
        rows.append({"seed": seed, "program": out["readings"], **out["controls"]})
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        with open(Path(args.out) / f"{args.workload}.json", "w") as f:
            json.dump({"cell": args.workload, "device": torch.cuda.get_device_name(0), "rows": rows}, f, indent=1)
    for side in ["program", *args.controls]:
        for key in rows[0]["program"]:
            vals = [r[side][key] for r in rows]
            print(f"{side:10s} {key:14s} min {min(vals):.4g} max {max(vals):.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
