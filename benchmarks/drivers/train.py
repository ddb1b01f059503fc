"""Zero-shot training: one user's jobs, one after another, each an
``scene_frames``-frame clip trained ``epochs`` epochs from the seeded weights
with fresh Adam moments (``init_train_state``), one ``train_step`` a frame in
temporal order, ``is_new_seq`` on each epoch's first frame, batch-statistics
BatchNorm in epoch 0 and running statistics after (the published schedule,
train.py:115-138). The frames come from host memory and each step's loss is
read back, as the training CLI logs it.

Set-up builds the first job's state and drives it through its first
``check_steps`` steps, past the end of epoch 0 into the first step on
running statistics; the window carries on with that same state, and builds
each later job's in the window. Correctness: each of those steps' losses,
the first gradient as the optimizer took it (its first moment after one step
over 1 - beta1), each leaf's change after ``change_steps`` steps, and after
all of them the Enhancer's running statistics and the carry, against the
plain reference run from the same weights and frames once the window has
closed. With ``--trace 1`` a fresh job is advanced to step ``trace_from``
after the window and its next ``trace_steps`` steps are traced, so every run
traces the same steps of a job.
"""

from __future__ import annotations

import math
import time

import torch

import check
import frames
import trace
import weights
from harness import Run, log, process_age
from reference import TRAINABLE, TrainerReference, check_widths, exact_f32, zero_tig_loss

OPT_KEYS = ("lr", "weight_decay", "grad_clip", "adam_beta1", "adam_beta2")
BN_STATS = ("enhance.conv.1.running_mean", "enhance.conv.1.running_var")


def schedule(traffic: dict, j: int) -> tuple[int, bool, bool]:
    """Step j of a job: (frame index, is_new_seq, bn_train)."""
    n = traffic["scene_frames"]
    return j % n, j % n == 0, j // n == 0


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def changes(params: dict, initial: dict) -> dict[str, float]:
    """The norm of each trainable leaf's change from ``initial``."""
    return _norms({k: params[k].detach() - initial[k] for k in TRAINABLE})


def program_snapshot(state, losses: list, grads: dict, change: dict) -> dict:
    sd = state.model.state_dict()
    return {
        "losses": losses,
        "grad": grads,
        "change": change,
        "bn": torch.cat([sd[k].detach().flatten() for k in BN_STATS]),
        "carry": torch.cat([state.carry["last_H3"], state.carry["last_s3"]], -1),
    }


def first_gradients(state, beta1: float) -> dict[str, float]:
    """Each leaf's gradient as the optimizer took it at step 1: its first
    moment over 1 - beta1."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt = state.optimizer
    return _norms({names[id(p)]: mu / (1.0 - beta1) for p, mu in zip(opt.params, opt.mu)})


def reference_steps(state_dict, pool, cfg, traffic, device, operands="f32", loss_fn=None,
                    freeze_stats=False) -> dict:
    """The reference's readings over a job's first ``check_steps`` steps."""
    opt = {k: cfg[k] for k in OPT_KEYS}
    _, b, h, w, _ = pool.shape
    tr = TrainerReference(state_dict, opt, (b, 3, h, w), operands, device)
    tr.model.freeze_stats = freeze_stats
    initial = {k: state_dict[k].to(device) for k in TRAINABLE}
    losses, change = [], {}
    kw = {} if loss_fn is None else {"loss_fn": loss_fn}
    with exact_f32():
        for j in range(traffic["check_steps"]):
            k, new, bn_train = schedule(traffic, j)
            f = pool[k].to(device).permute(0, 3, 1, 2).float() / 255.0
            losses.append(tr.step(f, new, cfg["of_scale"], cfg["raft_iters"], bn_train, **kw))
            if j + 1 == traffic["change_steps"]:
                change = changes(tr.model.p, initial)
    p = tr.model.p
    return {
        "losses": losses,
        "grad": _norms(tr.first_grads),
        "change": change,
        "bn": torch.cat([p[k].flatten() for k in BN_STATS]),
        "carry": torch.cat(tr.carry, 1).permute(0, 2, 3, 1),
    }


def run(r: Run) -> dict:
    from zero_tig_torch.core.config import Config
    from zero_tig_torch.pipeline import steps

    cfg, tr = r.config, r.traffic
    check_widths(cfg)
    dev = torch.device(r.device)
    cuda = dev.type == "cuda"
    h, w = cfg["frame_height"], cfg["frame_width"]
    state_dict = weights.make_state(r.seed, dev, for_training=True)
    pool = frames.make_video(r.seed + 1, tr["scene_frames"], h, w, dev, dim=tr["dim"], noise=tr["noise"])
    flags = [torch.tensor(k == 0) for k in range(tr["scene_frames"])]
    config = Config(precision=cfg["precision"], of_scale=cfg["of_scale"], raft_iters=cfg["raft_iters"],
                    frame_height=h, frame_width=w, **{k: cfg[k] for k in OPT_KEYS})
    job_steps = tr["scene_frames"] * tr["epochs"]
    initial = {k: state_dict[k].clone() for k in TRAINABLE}

    def new_job():
        return steps.init_train_state(config, state_dict, (1, h, w, 3), device=dev)

    st, j = new_job(), 0

    def unit(_: int) -> float:
        nonlocal st, j
        if j == job_steps:
            st, j = None, 0
            st = new_job()
        k, _, bn_train = schedule(tr, j)
        st, loss = steps.train_step(st, pool[k], flags[k], of_scale=cfg["of_scale"], raft_iters=cfg["raft_iters"],
                                    bn_train=bn_train)
        j += 1
        return float(loss)

    losses, grads, change = [], {}, {}
    for n in range(tr["check_steps"]):
        losses.append(unit(n))
        if n == 0:
            grads = first_gradients(st, cfg["adam_beta1"])
        if n + 1 == tr["change_steps"]:
            change = changes(dict(st.model.named_parameters()), initial)
    prog = program_snapshot(st, losses, grads, change)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()
    t_start = time.perf_counter()
    count, failed, times = 0, 0, []
    while True:
        t0 = time.perf_counter()
        loss = unit(count)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        failed += not math.isfinite(loss)
        count += 1
        if t1 - t_start >= r.seconds and count >= r.min_units:
            break
    window_s = t1 - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"train_ms_per_frame": window_s * 1e3 / count, "train_peak_gb": peak / 1e9, "setup_s": setup_s}
    log(f"window: {count} steps in {window_s:.3f} s, set-up {setup_s:.3f} s; step ms first five "
        f"{[round(t * 1e3, 3) for t in times[:5]]}, median {sorted(times)[len(times) // 2] * 1e3:.3f}; "
        f"set-up peak {setup_peak / 1e9 if cuda else 0:.3f} GB")
    summary = None
    if r.trace:  # a fresh job, advanced to the same step in every run
        st, j = None, job_steps
        for n in range(tr["trace_from"]):
            unit(n)
        summary = trace.profile_units(unit, tr["trace_steps"])
        summary.update(kind="train", frames=tr["trace_steps"], untraced_ms_per_frame=e2e["train_ms_per_frame"])
    st = unit = None
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_steps(state_dict, pool, cfg, tr, dev)
    values = check.train_readings(prog, ref, report=log)
    log(f"reference: {tr['check_steps']} steps in {time.perf_counter() - t0:.3f} s; losses program "
        f"{prog['losses']} reference {ref['losses']}; readings {values}")
    # the check's controls and planted faults (the calibration asks for them),
    # each the reference in the program's place
    controls = {}
    for name in r.options.get("controls", ()):
        if name == "half_rows":  # the loss taken over the top half of every map's rows
            kw = dict(loss_fn=lambda f, o: zero_tig_loss(f[..., :f.shape[-2] // 2, :],
                                                         {k: v[..., :v.shape[-2] // 2, :] for k, v in o.items()}))
        elif name == "frozen_stats":  # batch statistics that never move the running ones
            kw = dict(freeze_stats=True)
        else:
            kw = dict(operands=name)
        controls[name] = check.train_readings(reference_steps(state_dict, pool, cfg, tr, dev, **kw), ref)
    correct, checks = check.verdict(values, r.limits)
    return {"controls": controls, "correct": correct and failed == 0, "attempted": count, "failed": failed, "e2e": e2e,
            "summary": summary, "checks": checks, "readings": values,
            "memory_peak_bytes": max(setup_peak, peak) if cuda else 0}
