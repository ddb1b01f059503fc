"""Warm-started GMA flow along video: one closed-loop client of ``flow_chunk``
(``zero_tig_torch/flowtools/sequence.py``) on ``RAFTGMA``
(``zero_tig_torch/models/raft/gma.py``), at GMA's Sintel evaluation, which
keeps RAFT's warm-started ``create_sintel_submission`` at 32 iterations.

Users: video tools that compute frame-to-frame flow along clips with GMA
(Sintel-style sequence evaluation, stabilisation, interpolation), where
occluded motion matters.

It follows ``drivers/flowseq.py`` step for step: a host pool of
``scene_frames`` seeded uint8 frames (one scene, replayed) handed to the
card ``chunk`` at a time, ``is_new_seq`` on the scene's first frame, the
next chunk handed once the chunk's f32 flows are on the host; set-up plays
one scene (which captures GMA's graph and warms every shape); the window
plays on for ``seconds``; the trace takes ``trace_chunks`` chunks from the
middle of a scene. The weights are ``weights_gma.py``'s, the reference is
``reference/gma_sintel.py`` and the traced summary's kind is "gma".

Correctness: as ``flowseq``, with that file's ``readings``: ``sample_chunks``
chunks of the window, drawn from the seed, compared pair by pair with the
plain reference on the same weights and frames, each pair's ``flow_init``
the reference's own forward interpolation of the program's previous 1/8
flow. Besides the compared numbers the readings hold ``attn_entropy``, the
mean row entropy (nats) of the reference's attention on the scene's first
pair: how peaked the seeded attention is (ln 7040 = 8.86 is uniform).
"""

from __future__ import annotations

import random
import time

import torch

import check
import frames
import harness
import trace
import weights_gma
from harness import Run, log, process_age
from reference.gma_sintel import GMASintelReference, check_gma_widths
from reference.raft_sintel import forward_interpolate

_flowseq = harness.load_module(harness.BENCH / "drivers" / "flowseq.py", "bench_driver_flowseq_for_gma")
readings, _nchw = _flowseq.readings, _flowseq._nchw


def gma_model(state: dict, device):
    """The program's RAFTGMA with the benchmark's state (GMA's published names)."""
    from zero_tig_torch.models.raft.gma import RAFTGMA

    model = RAFTGMA()
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"GMA state mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    return model.requires_grad_(False).to(device).eval()


def attn_entropy(ref: GMASintelReference, pool: torch.Tensor) -> float:
    """The mean row entropy, in nats, of the reference's attention on the scene's first frame."""
    dev = next(iter(ref.p.values())).device
    a = ref.context_attention(_nchw(pool[0], dev))
    return float(-(a * a.clamp_min(1e-38).log()).sum(-1).mean())


def control_entries(state: dict, operands: str, pool: torch.Tensor, cfg: dict, chunk: int, per_scene: int,
                    device) -> list:
    """The reference in ``operands`` in the program's place: a whole scene
    with its own warm start, as entries for ``readings``."""
    ref = GMASintelReference(state, operands, device)
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
    from zero_tig_torch.core import spans
    from zero_tig_torch.flowtools import sequence

    cfg, tr = r.config, r.traffic
    check_gma_widths(cfg)
    dev = torch.device(r.device)
    chunk, scene = tr["chunk"], tr["scene_frames"]
    per_scene = scene // chunk
    h, w, iters, precision = cfg["frame_height"], cfg["frame_width"], cfg["raft_iters"], cfg["precision"]
    state = weights_gma.make_state(r.seed, dev)
    model = gma_model(state, dev)
    pool = frames.make_video(r.seed + 1, scene, h, w, dev, dim=tr["dim"], noise=tr["noise"])
    chunks = [pool[p * chunk:(p + 1) * chunk] for p in range(per_scene)]
    flags = [[p == 0 and k == 0 for k in range(chunk)] for p in range(per_scene)]
    carry: dict = {}

    def unit(i: int):
        nonlocal carry
        (flows, lows), carry = sequence.flow_chunk(model, chunks[i % per_scene].to(dev), carry,
                                                   flags[i % per_scene], iters, precision)
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
        f"min {times[0] * 1e3:.3f} median {times[len(times) // 2] * 1e3:.3f} max {times[-1] * 1e3:.3f}; "
        f"peak {peak} bytes")
    summary = None
    if r.trace:
        n = tr["trace_chunks"]
        while i % per_scene == 0 or i % per_scene + n > per_scene:  # to the middle of a scene, untraced
            unit(i)
            i += 1
        summary = trace.profile_units(lambda j: unit(i + j), n)
        summary.update(kind="gma", frames=n * chunk, iters=iters, untraced_ms_per_frame=e2e["infer_ms_per_frame"])
        recs, counts = spans.records(), spans.counters()
        log("trace: " + ", ".join(f"{k} {counts.get(k)}" for k in ("raft.calls", "raft.graph_replays",
                                                                    "flowseq.pairs", "flowseq.warm_starts"))
            + ", records " + ", ".join(f"{k} {sum(x['name'] == k for x in recs)}"
                                       for k in ("zt.raft", "zt.gma.attention", "zt.gma.aggregate")))
    del model, carry, unit
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sample.sort(key=lambda s: s[0])
    ref = GMASintelReference(state, "f32", dev)
    values = readings(sample, ref, pool, cfg, chunk, per_scene)
    entropy = attn_entropy(ref, pool)
    log(f"reference: {sum(s[1].shape[0] for s in sample)} pairs in {time.perf_counter() - t0:.3f} s; "
        f"compared chunks {[s[0] for s in sample]}; readings {values}; attention row entropy {entropy!r}")
    # the check's controls (the calibration asks for them): the reference in a
    # lower operand precision in the program's place, a whole scene
    controls = {}
    for operands in r.options.get("controls", ()):
        entries = control_entries(state, operands, pool, cfg, chunk, per_scene, dev)
        controls[operands] = dict(readings(entries, ref, pool, cfg, chunk, per_scene), attn_entropy=entropy)
    correct, checks = check.verdict(values, r.limits)
    return {"correct": correct, "attempted": i, "failed": 0 if correct else len(sample), "e2e": e2e,
            "summary": summary, "checks": checks, "readings": dict(values, attn_entropy=entropy),
            "memory_peak_bytes": peak, "controls": controls}
