"""Warm-started flow along video: one closed-loop client of ``flow_chunk``
(``zero_tig_torch/flowtools/sequence.py``), RAFT's published Sintel evaluation.

The client holds a host pool of ``scene_frames`` seeded uint8 frames (one
scene, replayed) and hands them to the card ``chunk`` at a time, with
``is_new_seq`` on the scene's first frame; it hands the next chunk once the
chunk's f32 flows at the frame's size are on the host. Within a scene every
pair after the first starts from the previous pair's forward-interpolated
flow. Set-up plays one scene, which captures RAFT's graph and warms every
shape the window uses. The window then plays on for ``seconds``; a chunk is
timed from handing its host frames over to holding its flows on the host.
The trace takes ``trace_chunks`` chunks after the window, from the middle of
a scene, so that every traced pair is warm-started.

Correctness: ``sample_chunks`` chunks of the window, drawn from the seed by
reservoir sampling, keep their flows, their 1/8 flows and the carry before
and after them. Once the window has closed and the program is freed, the
plain reference (``reference/raft_sintel.py``) computes each of their pairs
on the same weights and frames, pair by pair: each pair's ``flow_init`` is
the reference's own forward interpolation of the program's previous 1/8
flow, since the nearest splat is discontinuous (a rounding-level difference
can move a grid point's nearest source) and a chain of the reference's own
would drift from the program's along the scene. With no window
(``seconds`` 0, the calibration) the client plays and compares a whole scene.
"""

from __future__ import annotations

import random
import time

import torch

import check
import frames
import trace
import weights
from harness import Run, log, process_age
from reference.raft_sintel import RAFTSintelReference, check_raft_widths, forward_interpolate

OFF_PX = 1e-3  # a pixel whose end-point error passes this counts in ``epe_off_share``


def raft_model(state: dict, device):
    """The program's RAFT with the ``raft.*`` weights of the benchmark's state."""
    from zero_tig_torch.models.raft.raft import RAFT

    model = RAFT()
    missing, unexpected = model.load_state_dict({k[5:]: v for k, v in state.items() if k.startswith("raft.")},
                                                strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"RAFT state mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    return model.requires_grad_(False).to(device).eval()


def _nchw(frame: torch.Tensor, device) -> torch.Tensor:
    return frame.to(device).permute(0, 3, 1, 2).float()


def readings(entries: list, ref: RAFTSintelReference, pool: torch.Tensor, cfg: dict, chunk: int,
             per_scene: int) -> dict[str, float]:
    """Compare chunks (index, flows, 1/8 flows, carry before, carry after)
    with the reference, pair by pair, and each carry's ``flow_init`` with the
    reference's forward interpolation of the carry's ``flow_low``."""
    dev = next(iter(ref.p.values())).device
    iters = cfg["raft_iters"]
    epe_sum = epe_max = 0.0
    pixels = off = points = moved = 0

    def splat(low):
        return None if low is None else forward_interpolate(low.to(dev).permute(0, 3, 1, 2))

    for i, flows, lows, before, after in entries:
        pos, j, prev = i % per_scene, 0, before["flow_low"]
        for k in range(chunk):
            f = pos * chunk + k
            if f == 0:  # the scene's first frame: no pair, the warm start resets
                prev = None
                continue
            _, want = ref.pair(_nchw(pool[f - 1], dev), _nchw(pool[f], dev), iters, splat(prev))
            epe = torch.linalg.vector_norm(flows[j].to(dev).double() - want.permute(0, 2, 3, 1).double(), dim=-1)
            epe_sum += float(epe.sum())
            epe_max = max(epe_max, float(epe.max()))
            off += int((epe > OFF_PX).sum())
            pixels += epe.numel()
            prev = lows[j]
            j += 1
        for carry, low in ((before, before["flow_low"]), (after, prev)):
            want = splat(low)
            got = carry["flow_init"].to(dev).permute(0, 3, 1, 2)
            moved += int((got != (torch.zeros_like(got) if want is None else want)).any(1).sum())
            points += got[:, 0].numel()
    return {"epe_mean": epe_sum / pixels, "epe_max": epe_max, "epe_off_share": off / pixels,
            "init_mismatch": moved / points}


def control_entries(state: dict, operands: str, pool: torch.Tensor, cfg: dict, chunk: int, per_scene: int,
                    device) -> list:
    """The reference in ``operands`` in the program's place: a whole scene
    with its own warm start, as entries for ``readings``."""
    ref = RAFTSintelReference(state, operands, device)
    h, w = cfg["frame_height"], cfg["frame_width"]
    cold = {"flow_low": None, "flow_init": torch.zeros(1, -(-h // 8), -(-w // 8), 2, device=device)}
    entries, carry = [], cold
    for p in range(per_scene):
        before, flows, lows = carry, [], []
        for k in range(chunk):
            f = p * chunk + k
            if f == 0:
                carry = cold
                continue
            init = None if carry["flow_low"] is None else carry["flow_init"].permute(0, 3, 1, 2)
            low, flow = ref.pair(_nchw(pool[f - 1], device), _nchw(pool[f], device), cfg["raft_iters"], init)
            flows.append(flow.permute(0, 2, 3, 1))
            lows.append(low.permute(0, 2, 3, 1))
            carry = {"flow_low": lows[-1], "flow_init": forward_interpolate(low).permute(0, 2, 3, 1)}
        entries.append((p, flows, lows, before, carry))
    return entries


def run(r: Run) -> dict:
    from zero_tig_torch.flowtools.sequence import flow_chunk

    cfg, tr = r.config, r.traffic
    check_raft_widths(cfg)
    dev = torch.device(r.device)
    chunk, scene = tr["chunk"], tr["scene_frames"]
    per_scene = scene // chunk
    h, w, iters, precision = cfg["frame_height"], cfg["frame_width"], cfg["raft_iters"], cfg["precision"]
    state = weights.make_state(r.seed, dev)
    pool = frames.make_video(r.seed + 1, scene, h, w, dev, dim=tr["dim"], noise=tr["noise"])
    chunks = [pool[p * chunk:(p + 1) * chunk] for p in range(per_scene)]
    flags = [[p == 0 and k == 0 for k in range(chunk)] for p in range(per_scene)]
    model = raft_model(state, dev)
    carry: dict = {}

    def unit(i: int):
        nonlocal carry
        (flows, lows), carry = flow_chunk(model, chunks[i % per_scene].to(dev), carry, flags[i % per_scene],
                                          iters, precision)
        return flows.cpu(), lows

    for i in range(per_scene):  # warm-up: one scene; each unit ends on the host
        unit(i)
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rng = random.Random(r.seed)
    whole_scene = r.seconds <= 0
    keep = per_scene if whole_scene else tr["sample_chunks"]
    min_units = max(r.min_units, per_scene if whole_scene else 1)
    sample: list = []
    times: list[float] = []
    flows_done = 0
    setup_s = process_age()
    t_start = time.perf_counter()
    i = 0
    while True:
        before = carry
        t0 = time.perf_counter()
        flows, lows = unit(i)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        flows_done += flows.shape[0]
        slot = i if i < keep else rng.randrange(i + 1)
        if slot < keep:
            entry = (i, flows, lows, before, carry)
            if slot == len(sample):
                sample.append(entry)
            else:
                sample[slot] = entry
        i += 1
        if t1 - t_start >= r.seconds and i >= min_units:
            break
    window_s = t1 - t_start
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    times.sort()
    e2e = {
        "infer_ms_per_frame": window_s * 1e3 / flows_done,
        "infer_p90_chunk_ms": times[-(-9 * len(times) // 10) - 1] * 1e3,
        "setup_s": setup_s,
    }
    log(f"window: {i} chunks of {chunk} ({flows_done} flows) in {window_s:.3f} s, set-up {setup_s:.3f} s; chunk ms "
        f"min {times[0] * 1e3:.3f} median {times[len(times) // 2] * 1e3:.3f} max {times[-1] * 1e3:.3f}")
    summary = None
    if r.trace:
        n = tr["trace_chunks"]
        while i % per_scene == 0 or i % per_scene + n > per_scene:  # to the middle of a scene, untraced
            unit(i)
            i += 1
        summary = trace.profile_units(lambda j: unit(i + j), n)
        summary.update(kind="flowseq", frames=n * chunk, untraced_ms_per_frame=e2e["infer_ms_per_frame"])
    del model, carry, unit
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sample.sort(key=lambda s: s[0])
    values = readings(sample, RAFTSintelReference(state, "f32", dev), pool, cfg, chunk, per_scene)
    log(f"reference: {sum(s[1].shape[0] for s in sample)} pairs in {time.perf_counter() - t0:.3f} s; "
        f"compared chunks {[s[0] for s in sample]}; readings {values}")
    # the check's controls (the calibration asks for them): the reference in a
    # lower operand precision in the program's place, a whole scene
    controls = {}
    for operands in r.options.get("controls", ()):
        entries = control_entries(state, operands, pool, cfg, chunk, per_scene, dev)
        controls[operands] = readings(entries, RAFTSintelReference(state, "f32", dev), pool, cfg, chunk, per_scene)
    correct, checks = check.verdict(values, r.limits)
    return {"correct": correct, "attempted": i, "failed": 0 if correct else len(sample), "e2e": e2e,
            "summary": summary, "checks": checks, "readings": values, "memory_peak_bytes": peak,
            "controls": controls}
