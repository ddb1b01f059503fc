"""Streaming inference: one closed-loop client of ``predict_chunk(emit="u8")``.

The client holds a host pool of ``scene_frames`` seeded uint8 frames and plays
it as scenes, chunk after chunk: it hands a chunk of ``chunk`` frames from
host memory to ``predict_chunk`` with ``is_new_seq`` on each scene's first
frame, and hands the next once the chunk's uint8 H2 and H3 are on the host.
Set-up plays one scene, which warms every shape the window uses. The window
then plays on for ``seconds``; a chunk is timed from handing its frames over
to holding its outputs on the host.

Correctness: ``sample_chunks`` chunks of the window, drawn from the seed by
reservoir sampling, keep their outputs and the carry after them (a device
copy). Once the window has closed and the program is freed, the plain
reference replays the scene from its start on the same weights and frames,
and every sampled chunk's frames (a scene's first frame excepted: its warp
has nothing to move) and carry are compared with it.
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
from reference import ZeroTIGReference, check_widths, exact_f32


def _kw(cfg: dict) -> dict:
    return dict(of_scale=cfg["of_scale"], raft_iters=cfg["raft_iters"], enh_scale=cfg.get("enh_scale", 1))


def _u8(x: torch.Tensor) -> torch.Tensor:
    """NCHW [0, 1] -> NHWC uint8, as the program emits: clip(x * 255) truncated."""
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8).permute(0, 2, 3, 1)


def reference_scene(state: dict, pool: torch.Tensor, cfg: dict, chunk: int, device, operands: str = "f32"):
    """The reference's uint8 (H2, H3) of every frame of a scene, and its carry
    [last_H3 | last_s3] (NHWC) after each chunk."""
    ref = ZeroTIGReference(state, operands, device)
    n, b, h, w, _ = pool.shape
    carry = (torch.zeros(b, 3, h, w, device=device), torch.zeros(b, 3, h, w, device=device))
    outs, carries = [], []
    with exact_f32():
        for k in range(n):
            f = pool[k].to(device).permute(0, 3, 1, 2).float() / 255.0
            H2, H3, s3 = ref.infer_frame(f, carry, k == 0, **_kw(cfg))
            carry = (H3, s3)
            outs.append((_u8(H2), _u8(H3)))
            if k % chunk == chunk - 1:
                carries.append(torch.cat([H3, s3], 1).permute(0, 2, 3, 1))
    return outs, carries


def readings(sample: list, ref_outs: list, ref_carries: list, chunk: int, per_scene: int) -> dict:
    """Compare sampled chunks (index, (H2s, H3s), carry) with the reference's scene."""
    pairs, carries = [], []
    for i, (h2, h3), carry in sample:
        pos = i % per_scene
        for k in range(chunk):
            f = pos * chunk + k
            if f == 0:
                continue
            pairs += [(h2[k], ref_outs[f][0]), (h3[k], ref_outs[f][1])]
        carries.append((torch.cat([carry["last_H3"], carry["last_s3"]], -1), ref_carries[pos]))
    return check.stream_readings(pairs, carries)


def run(r: Run) -> dict:
    from zero_tig_torch.models import build_model
    from zero_tig_torch.pipeline import steps

    cfg, tr = r.config, r.traffic
    check_widths(cfg)
    dev = torch.device(r.device)
    chunk, scene = tr["chunk"], tr["scene_frames"]
    per_scene = scene // chunk
    h, w = cfg["frame_height"], cfg["frame_width"]
    state = weights.make_state(r.seed, dev)
    pool = frames.make_video(r.seed + 1, scene, h, w, dev, dim=tr["dim"], noise=tr["noise"])
    chunks = [pool[p * chunk:(p + 1) * chunk] for p in range(per_scene)]
    flags = [torch.tensor([p == 0 and k == 0 for k in range(chunk)]) for p in range(per_scene)]
    model = build_model(state, device=dev, precision=cfg["precision"])
    kw = dict(_kw(cfg), emit="u8")
    carry = steps.init_carry(model, (1, h, w, 3))

    def unit(i: int):
        nonlocal carry
        (h2, h3), carry = steps.predict_chunk(model, chunks[i % per_scene], carry, flags[i % per_scene], **kw)
        return h2.cpu(), h3.cpu()

    for i in range(per_scene):  # warm-up: one scene; each unit ends on the host
        unit(i)
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rng = random.Random(r.seed)
    keep = tr["sample_chunks"]
    sample: list = []
    times: list[float] = []
    setup_s = process_age()
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        out = unit(i)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        slot = i if i < keep else rng.randrange(i + 1)
        if slot < keep:
            entry = (i, out, {k: v.clone() for k, v in carry.items()})
            if slot == len(sample):
                sample.append(entry)
            else:
                sample[slot] = entry
        i += 1
        if t1 - t_start >= r.seconds and i >= r.min_units:
            break
    window_s = t1 - t_start
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    times.sort()
    e2e = {
        "infer_ms_per_frame": window_s * 1e3 / (i * chunk),
        "infer_p90_chunk_ms": times[-(-9 * len(times) // 10) - 1] * 1e3,
        "setup_s": setup_s,
    }
    log(f"window: {i} chunks of {chunk} in {window_s:.3f} s, set-up {setup_s:.3f} s; chunk ms "
        f"min {times[0] * 1e3:.3f} median {times[len(times) // 2] * 1e3:.3f} max {times[-1] * 1e3:.3f}")
    summary = None
    if r.trace:
        summary = trace.profile_units(lambda j: unit(i + j), tr["trace_chunks"])
        summary.update(kind="stream", frames=tr["trace_chunks"] * chunk, untraced_ms_per_frame=e2e["infer_ms_per_frame"])
    del model, carry, unit
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_outs, ref_carries = reference_scene(state, pool, cfg, chunk, dev)
    values = readings(sorted(sample, key=lambda s: s[0]), ref_outs, ref_carries, chunk, per_scene)
    log(f"reference: {scene} frames replayed in {time.perf_counter() - t0:.3f} s; "
        f"compared chunks {sorted(s[0] for s in sample)}; readings {values}")
    # the check's controls (the calibration asks for them): the reference in a
    # lower operand precision in the program's place, every chunk of the scene
    controls = {}
    for operands in r.options.get("controls", ()):
        c_outs, c_carries = reference_scene(state, pool, cfg, chunk, dev, operands)
        c_sample = [(p, tuple(torch.stack([o[j] for o in c_outs[p * chunk:(p + 1) * chunk]]) for j in (0, 1)),
                     {"last_H3": c_carries[p][..., :3], "last_s3": c_carries[p][..., 3:]}) for p in range(per_scene)]
        controls[operands] = readings(c_sample, ref_outs, ref_carries, chunk, per_scene)
    correct, checks = check.verdict(values, r.limits)
    return {"correct": correct, "attempted": i, "failed": 0 if correct else len(sample), "e2e": e2e,
            "summary": summary, "checks": checks, "readings": values, "memory_peak_bytes": peak,
            "controls": controls}
