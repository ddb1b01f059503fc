"""The numbers that decide ``correct``, and the verdict against a cell's limits.

Stream cells compare each sampled chunk's uint8 H2 and H3 (all but a scene's
first frame) and the carry after the chunk with the reference's replay of the
scene. Training cells compare the first steps of a job, past its first step
on running statistics: each step's loss, each leaf's first gradient as the
optimizer takes it, each leaf's change over the first few steps, and the
Enhancer's running statistics and the carry after all of them.

A norm gap is |‖a‖ - ‖r‖| / max(‖r‖, the median leaf's ‖r‖): the gap of
the norms, not the norm of the difference, since some gradients are all but
zero. A leaf whose reference gradient is under a thousandth of the median
leaf's is left out of both: its gradient is rounding (a conv bias before a
batch-statistics BatchNorm), and Adam moves it by round-off alone.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch


def rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """‖a - r‖ / ‖r‖ in float64."""
    a, r = a.double(), r.double()
    return float(torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r).clamp_min(1e-30))


def stream_readings(pairs: list[tuple], carries: list[tuple]) -> dict[str, float]:
    """``pairs``: (program uint8, reference uint8) frames; ``carries``:
    (program carry, reference carry), each a tensor of [last_H3 | last_s3]."""
    diffs = [(p.to(r.device).int() - r.int()).abs() for p, r in pairs]
    n = sum(d.numel() for d in diffs)
    return {
        "u8_max": float(max(int(d.max()) for d in diffs)),
        "u8_mean": sum(float(d.double().sum()) for d in diffs) / n,
        "u8_off_share": sum(int((d > 1).sum()) for d in diffs) / n,
        "carry_max": max(float((p.to(r.device) - r).abs().max()) for p, r in carries),
        "carry_rel": max(rel(p.to(r.device), r) for p, r in carries),
    }


def norm_gaps(prog: dict[str, float], ref: dict[str, float], keys) -> dict[str, float]:
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def train_readings(prog: dict, ref: dict, report=None) -> dict[str, float]:
    """``prog`` and ``ref``: "losses" (list), "grad" (leaf -> norm of the
    first gradient), "change" (leaf -> norm of the change), "bn" and
    "carry" (tensors)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    left_out = sorted(set(ref["grad"]) - set(moved))
    grad = norm_gaps(prog["grad"], ref["grad"], moved)
    change = norm_gaps(prog["change"], ref["change"], moved)
    if report is not None:
        worst = max(change, key=change.get)
        report(f"leaves left out (reference gradient under 1e-3 of the median leaf's): {left_out}; "
               f"worst change gap {worst}, worst gradient gap {max(grad, key=grad.get)}")
    return {
        "loss1_rel": losses[0],
        "loss_rel": max(losses),
        "grad_gap": max(grad.values()),
        "grad_med_gap": statistics.median(grad.values()),
        "change_gap": max(change.values()),
        "change_med_gap": statistics.median(change.values()),
        "bn_rel": rel(prog["bn"], ref["bn"]),
        "carry_rel": rel(prog["carry"], ref["carry"]),
    }


def verdict(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(all compared numbers finite and within their limits, {name: {value, limit}})."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
