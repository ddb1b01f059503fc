#!/usr/bin/env python3
"""Time K1's f32 launches, the port's highest-mode convolutions, of one
checkout on one card.

    python3 compare_k1.py [--tree DIR] [--out FILE] [--sweep [NAME,...]]

Imports ``zero_tig_torch`` from DIR (default: the checkout beside this
script), builds its kernels there, and runs ``chip_smoke.k1_timing_rows`` of
the checkout beside this script on that package: every f32 K1 launch of a
highest-mode 1080p frame (``chip_smoke.K1_LAYERS``), a flow-sidecar pair's
RAFT launches at 63x125, a Sintel pair's at 55x128 and GMA's gates and
``to_v`` there, on the seeded highest-mode model, each timed beside
its plain twin, cuDNN's f32 convolution with TF32 off and its bound
(``chip_smoke.k1_bound_ms``). Prints one JSON line with the card's name and
power limit, the rows and their sums per grid.

Two trees are compared in one call on one card, in turns (old, new, new,
old). With --out FILE the line is also appended to FILE.

--sweep times each layer (those whose name and grid, as in
``raft.mask2@45x80``, hold one of the NAMEs, in the NAMEs' order; default
all, RAFT's also at KITTI's 47x156) on its ``k1_plan`` plan and on every
other tiling of a grid of ``fma_plan`` tilings the kernel takes (tile rows,
channel groups, k-groups, chunk, resident blocks; at the RAFT grids the
rows 2, 4 and 8 and those that cut the grid's height into tiles of one
height, give or take a row), and adds, per layer, the fastest five and the
fastest that launch at least 132 blocks, and every tiling's time: how
``k1_plan``'s choices were made. It needs a tree with ``fma_plan``.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description="Time one checkout's f32 K1 launches on one CUDA card.")
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--sweep", nargs="?", const="", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: compare_k1.py needs one card", file=sys.stderr)
        return 2
    # chip_smoke of this checkout, on the package of the tree under test
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from zero_tig_torch.core import precision
    from zero_tig_torch.kernels import build
    from zero_tig_torch.models import build_model, init_random_state_dict

    build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    highest = build_model(init_random_state_dict(cs.SEED), device="cuda", precision="highest")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    with precision.numerics("highest"):
        rows = cs.k1_timing_rows(highest, cs.K1_F32_LAYERS, gen)
    result = {"tree": str(args.tree), "device": smi, "per_grid": cs.k1_grid_sums(rows), "rows": rows}
    if args.sweep is not None:
        # each layer under its name and grid (RAFT's also at KITTI's 47x156),
        # in the order of the first NAME its label holds
        kitti = cs.FLOW_GRIDS["KITTI 375x1242"]
        labelled = {la[0] if "@" in la[0] else f"{la[0]}@{la[3][0]}x{la[3][1]}": la for la in
                    cs.K1_F32_LAYERS + [(f"{la[0]}@47x156", la[1], la[2], kitti, *la[4:]) for la in cs.RAFT_K1_LAYERS]}
        names = [n for n in args.sweep.split(",") if n] or [""]
        layers = list({k: la for n in names for k, la in labelled.items() if n in k}.values())
        with precision.numerics("highest"):
            result["sweep"] = sweep(cs, highest, layers, gen)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


def sweep(cs, model, layers, gen) -> dict:
    """Each layer's f32 launch timed on its k1_plan plan and on a grid of
    other FMA-kernel tilings."""
    import torch

    from zero_tig_torch.ops.fused_conv import SM_COUNT, fma_plan, k1_plan, launch_k1

    out = {}
    for layer in layers:
        name, (h, w) = layer[0], layer[3]
        cw = cs.layer_weights(model, layer[1])
        kh, kw, cin, cout = cw.w.shape
        xs, kwargs = cs.k1_inputs(layer, torch.float32, gen)
        parts = tuple(layer[2])
        timer = cs.cuda_ms if (h, w) == cs.FULL else cs.graph_ms
        picked = k1_plan(torch.float32, kh, kw, parts, h, w, cout)
        # at the RAFT grids also the tile rows that cut h into tiles of one
        # height, give or take a row (7 at 55: 8 tiles, one row of padding)
        rows_s = (8, 16, 32) if (h, w) == cs.FULL else sorted({2, 4, 8} | {-(-h // n) for n in range(1, h + 1)} & set(range(5, 13)))
        cgs = (1,) if cout <= 8 else sorted({min(8, math.ceil(cout / 8)), 2, 4, 8} - {c for c in (2, 4, 8) if c * 8 > 2 * cout})
        times = []
        for rows, cg, kg, kc, resident in itertools.product(rows_s, cgs, (1, 2, 4, 8), (4, 8, 16, 32, 64), (1, 2)):
            if kc > max(4, cin):  # a chunk that is mostly padding
                continue
            try:
                plan = fma_plan(kh, kw, parts, h, w, cout, 1, None, rows=rows, cg=cg, kg=kg, kc=kc, resident=resident)
            except ValueError:
                continue
            ms = timer(lambda: launch_k1(xs, cw, **kwargs, plan=plan), **({"n": 5} if timer is cs.cuda_ms else {"reps": 10, "n": 3}))
            times.append((ms, plan.rows, plan.cg, plan.kg, plan.kc, plan.resident, plan.blocks))
        times.sort()
        ms = timer(lambda: launch_k1(xs, cw, **kwargs))
        wide = [t for t in times if t[-1] >= SM_COUNT]
        fmt = lambda t: f"{t[0]:.4f}@rows{t[1]}/cg{t[2]}/kg{t[3]}/kc{t[4]}/res{t[5]}/{t[6]}blk"  # noqa: E731
        print(f"sweep {name:25s} k1_plan {ms:.4f}@rows{picked.rows}/cg{picked.cg}/kg{picked.kg}/kc{picked.kc}/"
              f"res{picked.resident}/{picked.blocks}blk of {len(times)}; fastest " + " ".join(map(fmt, times[:5]))
              + "; fastest with >= 132 blocks " + " ".join(map(fmt, wide[:2])), flush=True)
        out[name] = {"k1_plan_ms": ms, "k1_plan": [picked.rows, picked.cg, picked.kg, picked.kc, picked.resident, picked.blocks],
                     "fastest": times[:5], "fastest_wide": wide[:2], "tilings": len(times), "all": times}
    return out


if __name__ == "__main__":
    sys.exit(main())
