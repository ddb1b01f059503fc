#!/usr/bin/env python3
"""Time K3, the port's histogram equalisation, of one checkout on one card.

    python3 compare_k3.py [--tree DIR] [--out FILE]

Imports ``zero_tig_torch`` from DIR (default: the checkout beside this
script), builds its kernels there, and prints one JSON line with the card's
name and power limit and, at the main path's (1, 360, 640, 3) on a uniform
and a low-light frame (bytes uint8(clamp(255 * U[0, 0.25)))):

- the device ms of ``equalize_u8`` on the frame's bytes and of
  ``equalize01`` on the f32 and the bf16 frame, as that tree computes them,
  inside a CUDA graph and with CUDA events over back-to-back calls;
- the device operations (kernels and memsets) of one call of each, from
  torch.profiler.

Two trees are compared in one call on one card, in turns (old, new, new,
old). With --out FILE the line is also appended to FILE.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description="Time one checkout's K3 on one CUDA card.")
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: compare_k3.py needs one card", file=sys.stderr)
        return 2
    from zero_tig_torch.kernels import build
    from zero_tig_torch.ops.equalize import equalize01, equalize_u8

    build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def events_ms(fn, n=200):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def graph_ms(fn, reps=20, n=10):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (n * reps)

    def device_ops(fn, n=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return len(ops) / n, sorted(set(ops))

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"tree": str(args.tree), "device": smi}
    for case, scale in (("uniform", 1.0), ("low-light", 0.25)):
        x = torch.rand(1, 360, 640, 3, generator=gen, device="cuda") * scale
        u8 = torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)
        xb = x.to(torch.bfloat16)
        for name, fn in (("equalize_u8", lambda: equalize_u8(u8)), ("equalize01 f32", lambda: equalize01(x)),
                         ("equalize01 bf16", lambda: equalize01(xb))):
            n_ops, names = device_ops(fn)
            result[f"{name} {case}"] = {"graph_ms": graph_ms(fn), "events_ms": events_ms(fn),
                                        "device_ops_per_call": n_ops, "device_ops": names}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
