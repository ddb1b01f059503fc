#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an H100.

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card, nvcc and the repository beside this file; exits
non-zero, with no result line, otherwise. It builds the kernels of
zero_tig_torch/csrc from the checkout, then:

  1. prints the card's name and power limit and the build seconds;
  2. holds every kernel against its plain PyTorch twin on the card, at the
     shapes the main path gives it (K1 for every Denoise_1, Enhancer,
     Denoise_2 and RAFT-update layer in bf16, on its tensor-core kernel, and
     in f32, on its FMA kernel; the tensor-core kernel also where its tiling
     is ragged: Cout 2-126, odd channel parts, sizes off the tile, batch 2,
     every tap shape and epilogue, on each tile shape; the FMA kernel on
     every branch of its f32 plan (FMA_CASES: the GRU concat, a 4-byte
     aligned part, ragged H, W and Cout, batch 2, every tap shape and
     epilogue), two launches bit-equal; K2 on one update
     iteration at 45x80 against the twins on the CPU; K3's three entries
     (equalize_u8; equalize01 on f32 and on bf16) exactly, at 360x640x3 on
     a uniform image with a constant channel, a low-light and an all-equal
     one, and on a ragged batch of 2, 5 channels and 64 images of 540x960;
     conv3x3_bf16 at 1080p, 64->64 and 48->48, with bf16 and f32 outputs);
  3. drives the main path: predict_chunk(emit="u8") over 8 frames of
     1920x1080, of_scale=3, 12 RAFT iterations, fast mode, new sequences at
     frames 0 and 4, on seeded random weights; checks the outputs are finite
     and that each kernel's launch count is the one the design implies; and
     times ms/frame (median over chunks, after a warm-up chunk); then
     traces one more chunk with torch.profiler and prints the device time
     per frame of each kernel by exact name and the device's idle share, and
     fails unless every K1 launch of the trace ran the tensor-core kernel;
     then the same for the chunk in the default precision (highest: f32
     operands, every K1 launch on the FMA kernel);
  4. runs the whole path at 96x128 (3 iterations) on the card and through
     the twins on the CPU, in both precisions, and compares; the same for 2
     training steps;
  5. times each kernel at its main-path shapes beside its bound, its twin
     and the library calls that compute the same function (cuDNN for K1
     and conv3x3_bf16; torch.mul / torch.lerp for the GRU kernel), K1 per
     layer with the share of its bound it reaches, in bf16 (fast model) and
     in f32 (highest model; cuDNN's f32 convolution with TF32 off, the bound
     at the f32 FMA peak; also RAFT's layers at the sidecar's 63x125 grid),
     with sums per 1080p frame, 45x80 frame and 63x125 pair, the host's time for
     one K1 launch; K3's entries on a uniform and a low-light frame beside
     their plain chains and bounds. Work at full resolution is timed with
     CUDA events over back-to-back calls; work at the 45x80 RAFT grid and
     the GRU and K3 kernels, too small to outrun the host's launches, inside
     a CUDA graph;
  6. drives conv3x3_bf16's own path (it is on no model path): one 1080p
     call at 64->64 and one at 48->48, counted;
  7. drives the training path: train_chunk at 1920x1080, of_scale=3, 12
     RAFT iterations, from seeded random weights with the reference's
     Enhancer init, in each precision 4 frames with batch-statistics
     BatchNorm and 4 more on running statistics, a new sequence at the
     first frame of each; checks the losses are finite, the parameters
     moved and each kernel's launches per frame (the flow phase: K1, K2,
     K3); prints ms/frame and peak device memory per mode, and traces one
     more 4-frame chunk (batch statistics) per mode as phase 3 does: fast
     mode must run K1 on the tensor-core kernel only, highest on the FMA
     kernel only;
  8. drives the command-line entry points in this process at 1920x1080
     (of_scale=3, 12 RAFT iterations): on a fixture of 2 scenes x 4 frames
     (make_rlv_fixture, with ground truth and the occluder) and a .pt of the
     seeded weights (save_pt), predict in fast mode with --chunk 4, whose
     _denoise/_enhance PNGs must equal predict_chunk(emit="u8") on the
     frames iter_u8 yields byte for byte, twice (the second run timed: CLI
     wall ms/frame with its set-up, decode and PNG-write ms/frame, peak
     device memory); then on a stream of 6 scenes x 4 frames linked to the
     fixture's, equal the same way and timed at steady state from its PNGs'
     modification times; the port's PNG writer beside Pillow's and OpenCV's
     where they import; predict with --enh_scale 2 on 4 frames, equal to
     predict_chunk(enh_scale=2); predict in the default highest mode on 4
     frames, equal the same way;
     train in fast mode for 2 epochs with --chunk 2 (finite losses,
     weights_<e>.pt and state_<e>.pt, 8 eval PNGs per epoch and kind, ms per
     training frame), then --resume from state_0.pt on the first scene,
     which must start at epoch 1; evals with weights_1.pt on 2 frames
     (Metrics.json with its 6 keys, finite PSNR and SSIM, LPIPS null). Each
     CLI run's kernel launches are counted from 0 and must be those of its
     frames;
  9. drives the serve daemon (python -m zero_tig_torch.cli.serve) in this
     process on 2 scenes x 6 frames of the fixture at 1080p, fast, --chunk 4
     (one chunk of 4 and 2 single frames a scene), with a STOP written after
     the last output: its PNGs must equal predict_chunk(emit="u8") and
     predict_step on the same frames in the same grouping byte for byte,
     its manifest the frames' flags, its launches per frame phase 3's; a
     second run on the served inbox must serve nothing; prints ms/frame at
     steady state from the manifest's stamps and peak device memory;
 10. drives banded training (pipeline/spatial.py) at 1080p: 4 bands x halo
     32 against train_step from one state and frame, in each precision and
     BatchNorm schedule (losses, gradients, running statistics, and the
     flow phase's launches, which must be phase 7's per frame), then
     ms/frame and peak device memory for 1, 2 and 4 bands in each, and a
     trace of one highest-mode step on running statistics by 1 and 2 bands;
 11. drives multi-device runs (zero_tig_torch/parallel) at 1080p, of_scale=3,
     12 RAFT iterations: two ranks spawned by parallel.launch share the card
     over gloo (the backend rule for ranks on one card) and run, in one
     launch, (a) mesh 2x1 predict_scenes_spmd in fast mode on phase 8's
     fixture (2 scenes x 4 frames), whose u8 outputs must equal the
     single-process predict_step loop's byte for byte, with phase 3's
     launches per frame on each rank, and ms/frame per rank with both
     streaming together; (b) mesh 1x2 predict_step_banded (halo 32) on the
     same frames, within 1/64 and 4 PNG levels of the whole frame; (c) mesh
     2x1 and 1x2 training in highest mode, 2 steps (batch, then running
     statistics) from a random carry, each step's loss and gradients
     against the single-process step within phase 10's limits (a leaf's
     gradient limit raised by how far the single-process step itself moves
     when its batch holds the same frames twice over) and the
     parameters bit-equal across the ranks, with phase 7's launches per
     frame; and 1x2 training ms/step and peak device memory per rank in
     each precision and schedule; then (d) one NCCL rank (world size 1,
     through make_mesh) takes a training step, held against train_step, and
     times predict_step alone; (e) predict --mesh_data 2 must write PNGs
     byte-equal to the single-process CLI's; (f) each run's backend;
 12. drives the flow sidecar (zero_tig_torch/flowtools) on seeded weights
     and a fixture made here (textured frames moved by a known smooth flow,
     .flo ground truth, Sintel layout at 436x1024 and KITTI at 375x1242):
     K1 against its twin and timed, and the GRU kernel timed, at RAFT's
     update-core grid of each operating point (63x125, 55x128, 47x156);
     (a) benchmark_model of lk_pyramid, pwc_lite, raft and raft_small at
     500x1000 in both precisions (median ms, parameters, FLOPs, peak
     bytes); (b) RAFT's launches on one Sintel pair through infer_pair,
     counted from 0 (12 x (9 K1 + 4 GRU) + 2 K1), and each model on the
     card against its plain version on the CPU on that pair in highest
     mode; (c) validate_folder (RAFT, PWC-lite card against CPU, LK against
     the known flow) and the Sintel and KITTI submissions read back against
     the flow in memory; the benchmark and demo CLIs (python -m) run beside
     (b) and (c), the demo's flow PNGs equal to flow_to_image of the
     registry's RAFT; (d) flow training on FlowAugmentor's 368x496 crops,
     batch 4: RAFT 1 warm-up + 3 timed steps a precision (ms/step, peak
     memory, the loss falling on one fixed batch), raft_small and pwc_lite
     2 steps, and RAFT's first step at 96x128 on the card against the CPU.

Before phase 2 it prints one line on whether the native frame pipeline
(zero_tig_torch/native/frameio.cc, libpng and libjpeg) builds and loads;
that line is information, and no phase depends on it.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel numbers. With --out DIR, the details also go to
DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import io
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

import torch
import torch.nn.functional as F

from zero_tig_torch import native
from zero_tig_torch.cli import evals as cli_evals
from zero_tig_torch.cli import predict as cli_predict
from zero_tig_torch.cli import serve as cli_serve
from zero_tig_torch.cli import train as cli_train
from zero_tig_torch.core import precision
from zero_tig_torch.core.checkpoint import save_pt
from zero_tig_torch.core.config import Config
from zero_tig_torch.data import FlowAugmentor, create_dataset, make_rlv_fixture
from zero_tig_torch.flowtools import (
    benchmark_model,
    flow_train_step,
    get_flow_model,
    infer_pair,
    init_flow_train_state,
    validate_folder,
    write_kitti_submission,
    write_sintel_submission,
)
from zero_tig_torch.core import spans
from zero_tig_torch.kernels import build
from zero_tig_torch.losses.zero_tig_loss import zero_tig_loss
from zero_tig_torch.models import build_model, init_random_state_dict, init_state_dict
from zero_tig_torch.models.network import forward_train, reinit_enhancer
from zero_tig_torch.native import frameio
from zero_tig_torch.models.raft.update import update_core
from zero_tig_torch.ops import gru
from zero_tig_torch.ops.conv3x3 import conv3x3_bf16, conv3x3_bf16_reference
from zero_tig_torch.ops.equalize import equalize01, equalize01_reference, equalize_u8, equalize_u8_reference
from zero_tig_torch.ops.fused_conv import ConvWeights, conv_weights, fused_conv, fused_conv_reference, k1_plan, launch_k1
from zero_tig_torch.pipeline.spatial import spatial_loss_and_grads, train_step_spatial
from zero_tig_torch.utils.flow_io import read_flo, read_flow_kitti, write_flo
from zero_tig_torch.utils.flow_viz import flow_to_image
from zero_tig_torch.utils.misc import resize_u8
from zero_tig_torch.pipeline.steps import (
    init_carry,
    init_train_state,
    predict_chunk,
    predict_step,
    train_chunk,
    train_step,
)

REPO = Path(__file__).resolve().parent
H, W, OF_SCALE, ITERS, CHUNK = 1080, 1920, 3, 12, 8
HR, WR = 45, 80  # RAFT grid: (1080/3, 1920/3) padded to /8, over 8
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12  # H100 SXM f32 FMA FLOP/s on the CUDA cores (no tensor cores)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
SEED = 0

# (name, weights key, input channel parts, grid, act, residual, anchor parts,
#  f32 output, launches per frame) -- every K1 launch of one main-path frame
FULL, RAFT = (H, W), (HR, WR)
K1_LAYERS = [
    ("d1.conv1", ("denoise_1", "conv1"), [3], FULL, "leaky", False, [], False, 1),
    ("d1.conv2", ("denoise_1", "conv2"), [48], FULL, "leaky", False, [], False, 1),
    ("d1.conv3+anchor", ("denoise_1", "conv3"), [48], FULL, "none", False, [3], False, 1),
    ("enh.in_conv", ("enhance", "in"), [6, 3], FULL, "relu", False, [], False, 1),
    ("enh.block+res", ("enhance", "block"), [64], FULL, "relu", True, [], False, 3),
    ("enh.out_conv", ("enhance", "out"), [64], FULL, "sigmoid_clip", False, [], False, 1),
    ("d2.conv1", ("denoise_2", "conv1"), [6, 3, 3], FULL, "leaky", False, [], False, 1),
    ("d2.conv2", ("denoise_2", "conv2"), [48], FULL, "leaky", False, [], False, 1),
    ("d2.conv3+anchor", ("denoise_2", "conv3"), [48], FULL, "none", False, [3, 3], False, 1),
    ("raft.convc1", ("raft", "convc1"), [324], RAFT, "relu", False, [], False, ITERS),
    ("raft.convc2", ("raft", "convc2"), [256], RAFT, "relu", False, [], False, ITERS),
    ("raft.conv", ("raft", "conv"), [192, 64], RAFT, "relu", False, [], False, ITERS),
    ("raft.gru.zr1", ("raft", "zr1"), [128, 128, 126, 2], RAFT, "sigmoid", False, [], True, ITERS),
    ("raft.gru.q1", ("raft", "q1"), [128, 128, 126, 2], RAFT, "tanh", False, [], True, ITERS),
    ("raft.gru.zr2", ("raft", "zr2"), [128, 128, 126, 2], RAFT, "sigmoid", False, [], True, ITERS),
    ("raft.gru.q2", ("raft", "q2"), [128, 128, 126, 2], RAFT, "tanh", False, [], True, ITERS),
    ("raft.fh1", ("raft", "fh1"), [128], RAFT, "relu", False, [], False, ITERS),
    ("raft.fh2", ("raft", "fh2"), [256], RAFT, "none", False, [], True, ITERS),
    ("raft.mask0", ("raft", "mask0"), [128], RAFT, "relu", False, [], False, 1),
    ("raft.mask2", ("raft", "mask2"), [256], RAFT, "none", False, [], False, 1),
]
GRU_PER_FRAME = 4 * ITERS
EQ_PER_FRAME = 1
K1_PER_FRAME = sum(layer[-1] for layer in K1_LAYERS)
# a training frame runs K1 only inside RAFT (its conv stacks are library
# convolutions under autograd): the update core and the mask head
K1_PER_TRAIN_FRAME = sum(layer[-1] for layer in K1_LAYERS if layer[0].startswith("raft."))
TRAIN_FRAMES = 4
RAFT_K1_LAYERS = [layer for layer in K1_LAYERS if layer[0].startswith("raft.")]
SIDECAR = (63, 125)  # RAFT's update grid at the flow sidecar's 500x1000
# K1's f32 launches as phase 5 times them: a highest-mode frame's, and a
# sidecar pair's at 63x125
K1_F32_LAYERS = K1_LAYERS + [(f"{la[0]}@63x125", la[1], la[2], SIDECAR, *la[4:]) for la in RAFT_K1_LAYERS]
GRID_LABELS = {FULL: "1080p", RAFT: "45x80", SIDECAR: "63x125"}
# conv3x3_bf16's own path: (Cin, Cout) of its 1080p calls
CONV3X3_CALLS = [(64, 64), (48, 48)]

K1_SITES = ("zero_tig_tpu/ops/pack_conv.py:214 (conv3x3_packed), :394 (conv3x3_packed_multi), "
            ":546 (residual1x1_packed), :491 (residual1x1_packed_multi); "
            "zero_tig_tpu/models/raft/update_kernel.py:248 (update_core_kernel convs)")
REPLACES = {
    "fused_conv": K1_SITES + ", bf16 operands (fast mode)",
    "fused_conv_f32": K1_SITES + ", f32 operands (highest mode)",
    "gru": "zero_tig_tpu/models/raft/update_kernel.py:248 (update_core_kernel GRU gates)",
    "equalize_u8": "zero_tig_tpu/ops/pallas_equalize.py:112 (equalize_uint8_pallas)",
    "conv3x3_bf16": "zero_tig_tpu/ops/pallas_conv.py:125 (conv3x3_bf16)",
}
# the kernels of csrc/*.cu by exact name, and the wrapper that launches each
OWN_KERNELS = {
    "zt::fused_conv_mma_kernel": "fused_conv",  # bf16 operands: tensor cores
    "zt::fused_conv_kernel": "fused_conv_f32",  # f32 operands: FMAs
    "zt::gru_reset_kernel": "gru",
    "zt::gru_update_kernel": "gru",
    "zt::equalize_kernel": "equalize_u8",  # both K3 entries: equalize_u8 and equalize01
}
SOURCES = {
    "fused_conv": "zero_tig_torch/csrc/fused_conv_mma.cu",
    "fused_conv_f32": "zero_tig_torch/csrc/fused_conv.cu",
    "gru": "zero_tig_torch/csrc/gru.cu",
    "equalize_u8": "zero_tig_torch/csrc/equalize.cu",
    "conv3x3_bf16": "zero_tig_torch/csrc/fused_conv_mma.cu",
}
MMA, FMA = "zt::fused_conv_mma_kernel", "zt::fused_conv_kernel"
KERNELS = ("fused_conv", "fused_conv_f32", "gru", "equalize_u8", "conv3x3_bf16")


def launches(k1: int = 0, gru: int = 0, eq: int = 0, c3: int = 0, *, f32: bool = False) -> dict:
    """The launch counts a path must show: K1's under fused_conv_f32 where
    its operands are f32 (highest mode), under fused_conv where bf16."""
    return {"fused_conv": 0 if f32 else k1, "fused_conv_f32": k1 if f32 else 0, "gru": gru, "equalize_u8": eq,
            "conv3x3_bf16": c3}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Mean ms of fn on the card over n calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, reps: int = 20, n: int = 10) -> float:
    """Device ms of one fn call, for work too small to outrun the host's
    launches: reps calls captured in one CUDA graph, replayed n times and
    timed with CUDA events."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


def k1_inputs(layer, dtype, gen):
    name, _, parts, (h, w), act, residual, anchor, out_f32, _ = layer
    xs = [torch.randn(1, h, w, c, generator=gen, device="cuda").to(dtype) for c in parts]
    if name.startswith("raft.gru.q") or name.startswith("raft.gru.zr"):
        xs[-1] = xs[-1] * 4  # the flow channels are a few pixels
    anc = [torch.rand(1, h, w, c, generator=gen, device="cuda").to(dtype) for c in anchor]
    kwargs = dict(act=act, residual=xs[0] if residual else None, anchor=anc,
                  out_dtype=torch.float32 if out_f32 else None)
    return xs, kwargs


def k1_bound_ms(layer, cw) -> tuple[float, float, str]:
    """(bound ms, FLOP, what bounds it) of one K1 launch: the larger of its
    FLOP at the peak of its operands (bf16 tensor cores, or f32 FMAs on the
    CUDA cores) and its bytes (each input, weight and output once) at the
    HBM rate. A residual is the layer's own input xs[0] (the Enhancer block
    adds its input), so it adds no bytes."""
    _, _, parts, (h, w), _, _, anchor, out_f32, _ = layer
    kh, kw, cin, cout = cw.w.shape
    esz = cw.w.element_size()
    peak = PEAK_F32 if cw.w.dtype == torch.float32 else PEAK_BF16
    flops = 2.0 * h * w * cin * cout * kh * kw
    nbytes = h * w * (cin + sum(anchor)) * esz
    nbytes += cw.w.numel() * esz + h * w * cout * (4 if out_f32 else esz)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), flops, ("operations" if t_ops >= t_bytes else "bytes")


def layer_weights(model, key):
    owner, name = key
    if owner == "raft":
        return model.raft.update_block.kw[name]
    return getattr(model, owner).kw[name]


def phase2_kernels(fast, highest, gen, report):
    """Every kernel against its twin at main-path shapes."""
    k1 = []
    for layer in K1_LAYERS:
        name = layer[0]
        for mode, model in (("bf16", fast), ("f32", highest)):
            cw = layer_weights(model, layer[1])
            xs, kwargs = k1_inputs(layer, cw.w.dtype, gen)
            got = fused_conv(xs, cw, **kwargs).float()
            ref = fused_conv_reference(xs, cw, **kwargs).float()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            # bf16: one output ulp (2^-8 relative) plus sums in another order;
            # f32: sums of up to 2304 terms in another order
            atol, rtol = (1e-2, 1e-2) if mode == "bf16" else (1e-4, 1e-4)
            bad = float(((got - ref).abs() - (atol + rtol * ref.abs())).max())
            ok = bool(torch.isfinite(got).all()) and bad <= 0 and scale > 0
            print(f"K1 {name:18s} {mode:4s} max_abs_err={err:.3e} max|ref|={scale:.3g} "
                  f"tol=atol {atol:g} + rtol {rtol:g}*|ref| "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K1 {name} {mode} disagrees with its twin")
            k1.append({"layer": name, "mode": mode, "max_abs_err": err})
    report["k1_checks"] = k1

    # ragged edges and a batch of 2: every tap shape and epilogue of K1
    odd = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for kh, kw in ((1, 1), (3, 3), (1, 5), (5, 1)):
            xs = [torch.randn(2, 37, 53, c, generator=gen, device="cuda").to(dt) for c in (5, 7, 3, 1)]
            cw = ConvWeights(
                (0.2 * torch.randn(kh, kw, 16, 16, generator=gen, device="cuda")).to(dt),
                torch.rand(16, generator=gen, device="cuda") + 0.5,
                torch.randn(16, generator=gen, device="cuda") * 0.1,
            )
            anc = [torch.rand(2, 37, 53, c, generator=gen, device="cuda").to(dt) for c in (10, 6)]
            res = torch.randn(2, 37, 53, 16, generator=gen, device="cuda").to(dt)
            for kwargs in (dict(act="tanh", residual=res), dict(anchor=anc),
                           dict(act="sigmoid", out_dtype=torch.float32)):
                out = fused_conv(xs, cw, **kwargs)
                got, ref = out.float(), fused_conv_reference(xs, cw, **kwargs).float()
                # bf16 output: one rounding apart (2^-8 relative); f32: sums
                # in another order
                atol, rtol = (2.0**-6, 2.0**-8) if out.dtype == torch.bfloat16 else (1e-5, 1e-5)
                err = float((got - ref).abs().max())
                if not err <= atol + rtol * float(ref.abs().max()):
                    fail(f"K1 on (2,37,53) {dt} {kh}x{kw} {sorted(kwargs)} err {err}")
                odd = max(odd, err)
    print(f"K1 ragged (2,37,53) batch 2, 4 inputs, 1x1/3x3/1x5/5x1, residual/anchor/f32-out: "
          f"max_abs_err={odd:.3e} tol=bf16 2^-6 + 2^-8*max|ref|, f32 1e-5 + 1e-5*max|ref| ok", flush=True)

    report["k1_mma_ragged_max_abs_err"] = k1_mma_ragged(gen)
    report["k1_fma_ragged_max_abs_err"] = fma_err = k1_fma_ragged(gen)

    # K2: one update iteration at 45x80, kernels on the card vs twins on the CPU
    k2 = {}
    for mode, model, tol in (("bf16", fast, 3e-2), ("f32", highest, 1e-3)):
        ub = model.raft.update_block
        dt = ub.dtype
        x = {k: torch.randn(1, HR, WR, c, generator=gen, device="cuda")
             for k, c in (("net", 128), ("inp", 128), ("corr", 324), ("flow", 2))}
        x["net"], x["inp"] = torch.tanh(x["net"]).to(dt), torch.relu(x["inp"]).to(dt)
        x["flow"] = 3 * x["flow"]
        flo = ub.flow_features(x["flow"])
        net, delta = update_core(ub.kw, x["net"], x["inp"], x["corr"], flo, x["flow"])
        kw_cpu = {k: type(v)(*(t if t is None else t.cpu() for t in v)) for k, v in ub.kw.items()}
        rnet, rdelta = update_core(kw_cpu, x["net"].cpu(), x["inp"].cpu(), x["corr"].cpu(),
                                   flo.cpu(), x["flow"].cpu())
        e_net = float((net.cpu().float() - rnet.float()).abs().max())
        e_delta = float((delta.cpu() - rdelta).abs().max())
        ok = e_net <= tol and e_delta <= tol and bool(torch.isfinite(delta).all())
        print(f"K2 update_core {mode:4s} (1,{HR},{WR}) net max_abs_err={e_net:.3e} "
              f"delta max_abs_err={e_delta:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K2 update_core {mode} disagrees with its CPU twin")
        k2[mode] = {"net": e_net, "delta": e_delta}
    report["k2_checks"] = k2

    # the GRU kernel alone against its twin on the card: f32 outputs to f32
    # rounding (the kernel may fuse a multiply-add), bf16 outputs to one bf16
    # ulp of a value in [-1, 1] (2^-7)
    gru_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        zr = torch.rand(1, HR, WR, 256, generator=gen, device="cuda")
        q = torch.rand(1, HR, WR, 128, generator=gen, device="cuda") * 2 - 1
        net = (torch.rand(1, HR, WR, 128, generator=gen, device="cuda") * 2 - 1).to(dt)
        pairs = [(gru.gru_reset(zr, net, dt), gru.gru_reset_reference(zr, net, dt))]
        outs = (torch.float32, torch.bfloat16) if dt == torch.bfloat16 else (torch.float32,)
        pairs += list(zip(gru.gru_update(zr, q, net, outs), gru.gru_update_reference(zr, q, net, outs)))
        for a, b in pairs:
            err = float((a.float() - b.float()).abs().max())
            tol = 2.0**-7 if a.dtype == torch.bfloat16 else 1e-6
            ok = err <= tol
            print(f"GRU kernel {a.dtype} out (net {dt}) max_abs_err={err:.3e} tol={tol:g} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail("GRU kernel disagrees with its twin")
            gru_err = max(gru_err, err)

    eq_err = k3_checks(gen, report)
    report["gru_max_abs_err"] = gru_err

    # conv3x3_bf16 (K1 with no epilogue) at 1080p: the same bf16 products,
    # f32 sums in another order: f32 outputs within 1e-5 + 1e-5 |ref|, bf16
    # outputs within one bf16 ulp (2^-7 |ref|) plus that 1e-5, by which a
    # sum near 0 may change sign
    c3 = {}
    for cin, cout in CONV3X3_CALLS:
        x, w, b = conv3x3_inputs(cin, cout, gen)
        for out_dtype in (torch.bfloat16, torch.float32):
            got = conv3x3_bf16(x, w, b, out_dtype=out_dtype)
            ref = conv3x3_bf16_reference(x, w, b, out_dtype=out_dtype)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            rel = 2.0**-7 if out_dtype == torch.bfloat16 else 1e-5
            ok = bool((diff <= 1e-5 + rel * ref.float().abs()).all()) and bool(torch.isfinite(got).all())
            tol = f"1e-5 + {rel:g} |ref|"
            err = float(diff.max())
            name = f"{cin}->{cout} {str(out_dtype).removeprefix('torch.')}"
            print(f"conv3x3_bf16 (1,{H},{W}) {name} max_abs_err={err:.3e} max|ref|={float(ref.float().abs().max()):.3g} "
                  f"tol={tol} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"conv3x3_bf16 {name} disagrees with its twin")
            c3[name] = err
    report["conv3x3_bf16_checks"] = c3

    k1_bf16 = max(c["max_abs_err"] for c in k1 if c["mode"] == "bf16")
    k1_f32 = max([c["max_abs_err"] for c in k1 if c["mode"] == "f32"] + [fma_err])
    c3_bf16 = max(v for k, v in c3.items() if k.endswith("bfloat16"))
    return {"fused_conv": k1_bf16, "fused_conv_f32": k1_f32, "gru": gru_err, "equalize_u8": float(eq_err),
            "conv3x3_bf16": c3_bf16}


def k3_cases(gen):
    """(name, f32 image in [0, 1]) of the cases K3 is held to: uniform with a
    constant channel, low-light (bytes uint8(clamp(255 * U[0, 0.25))), as
    the main path's denoised frames fill bins 0-63), all equal, at the main
    path's (1, 360, 640, 3); a batch of 2 at an odd size (the scalar loads
    of unaligned groups, and a 9-pixel tail); 5 channels (the scalar path);
    64 images of 540x960 (more groups than the registers hold)."""
    h, w = H // OF_SCALE, W // OF_SCALE
    uniform = torch.rand(1, h, w, 3, generator=gen, device="cuda")
    uniform[..., 1] = 0.357
    odd = torch.rand(2, 37, 53, 3, generator=gen, device="cuda")
    odd[1, ..., 0] = 0.02
    return [
        ("uniform, constant channel", uniform),
        ("low-light", torch.rand(1, h, w, 3, generator=gen, device="cuda") * 0.25),
        ("all equal", torch.full((1, h, w, 3), 0.5, device="cuda")),
        ("batch 2 odd", odd),
        ("5 channels", torch.rand(1, 37, 53, 5, generator=gen, device="cuda")),
        ("64 images", torch.rand(64, 540, 960, 3, generator=gen, device="cuda") * 0.5),
    ]


def to_u8(x):
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def k3_checks(gen, report) -> int:
    """K3's three entries bit-exact against their twins on the card: the
    uint8 one (equalize_u8) and the fused one (equalize01) on f32 and bf16."""
    rows = []
    for name, x in k3_cases(gen):
        for entry, inp, run, twin in (
            ("equalize_u8", to_u8(x), equalize_u8, equalize_u8_reference),
            ("equalize01 f32", x, equalize01, equalize01_reference),
            ("equalize01 bf16", x.to(torch.bfloat16), equalize01, equalize01_reference),
        ):
            got, ref = run(inp), twin(inp)
            torch.cuda.synchronize()
            err = int((got.int() - ref.int()).abs().max()) if got.shape == ref.shape else -1
            ok = got.dtype == ref.dtype and err == 0
            if name.startswith("uniform"):  # a constant channel keeps its bytes (step == 0)
                ok = ok and torch.equal(got[..., 1], (inp if inp.dtype == torch.uint8 else to_u8(inp))[..., 1].to(got.dtype))
            print(f"K3 {entry:15s} {name:25s} {tuple(x.shape)} max_abs_err={err} tol=0 (exact) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K3 {entry} is not exact on {name}")
            rows.append({"entry": entry, "case": name, "shape": list(x.shape), "max_abs_err": err})
    report["k3_checks"] = rows
    return max(r["max_abs_err"] for r in rows)


def k1_mma_ragged(gen) -> float:
    """The tensor-core kernel where its tiling is ragged: Cout of 2, 3, 6, 48
    and 126, input parts that are no multiples of 8 (copied 1, 2 or 4
    elements at a time), H and W no multiples of the tile, a batch of 2, all
    four tap shapes and every epilogue, on each of its tile shapes."""
    bf = torch.bfloat16
    shapes = ((2, 37, 53), (1, 203, 333))  # 4-row tiles; 8-row tiles
    part_sets = ((5, 7, 3, 1), (126, 2, 9), (324,), (6, 3, 3), (20, 12))
    worst, n, tiles = 0.0, 0, set()
    for si, (b, h, w) in enumerate(shapes):
        for ti, (kh, kw) in enumerate(((1, 1), (3, 3), (1, 5), (5, 1))):
            for ci, cout in enumerate((2, 3, 6, 48, 126)):
                parts = part_sets[(ti + ci + si) % len(part_sets)]
                cin = sum(parts)
                xs = [torch.randn(b, h, w, c, generator=gen, device="cuda").to(bf) for c in parts]
                cw = ConvWeights(
                    (torch.randn(kh, kw, cin, cout, generator=gen, device="cuda") / (kh * kw * cin) ** 0.5).to(bf),
                    torch.rand(cout, generator=gen, device="cuda") + 0.5,
                    torch.randn(cout, generator=gen, device="cuda") * 0.1,
                )
                split = max(1, cout // 3)
                anc = [torch.rand(b, h, w, c, generator=gen, device="cuda").to(bf) for c in (split, cout - split)]
                res = torch.randn(b, h, w, cout, generator=gen, device="cuda").to(bf)
                variants = (dict(act="tanh", residual=res), dict(anchor=anc),
                            dict(act="sigmoid", out_dtype=torch.float32), dict(act="leaky"))
                plan = k1_plan(bf, kh, kw, tuple(parts), h, w, cout, b)
                tiles.add(plan.tile)
                for kwargs in (variants[(ti + ci) % 4], variants[(ti + ci + 1) % 4]):
                    out = fused_conv(xs, cw, **kwargs)
                    got, ref = out.float(), fused_conv_reference(xs, cw, **kwargs).float()
                    # as the ragged case above: a bf16 output one rounding
                    # apart (2^-8 relative); f32: sums in another order
                    atol, rtol = (2.0**-6, 2.0**-8) if out.dtype == bf else (1e-5, 1e-5)
                    err = float((got - ref).abs().max())
                    if not err <= atol + rtol * float(ref.abs().max()):
                        fail(f"K1 tensor-core kernel on {(b, h, w)} {kh}x{kw} parts {parts} -> {cout} "
                             f"{sorted(kwargs)} tile {plan.tile}: err {err}")
                    worst, n = max(worst, err), n + 1
    if tiles != set(range(5)):
        fail(f"the ragged cases reached tile shapes {sorted(tiles)} of 0-4")
    print(f"K1 tensor-core kernel, {n} ragged cases on (2,37,53) and (1,203,333): Cout 2/3/6/48/126, parts "
          f"{part_sets}, 1x1/3x3/1x5/5x1, residual/anchor/f32-out/leaky, all 5 tile shapes: "
          f"max_abs_err={worst:.3e} tol=bf16 2^-6 + 2^-8*max|ref|, f32 1e-5 + 1e-5*max|ref| ok", flush=True)
    return worst


# every branch of k1_plan's f32 choice (see fma_branch): (batch, h, w), input
# parts, taps, Cout, epilogue
FMA_CASES = [
    ((2, 200, 528), (5, 7, 3, 1), (1, 1), 3, "anchor"),  # 1080p-like: a head
    ((2, 200, 528), (6, 3, 3), (3, 3), 6, "f32"),
    ((2, 200, 528), (20, 12, 32), (3, 3), 64, "residual"),  # 64 channels, 2 resident
    ((2, 200, 528), (48,), (3, 3), 61, "anchor"),
    ((2, 200, 528), (64,), (5, 1), 48, "leaky"),  # fewer channels, 1 resident
    ((2, 201, 531), (9, 3), (3, 3), 20, "residual"),
    ((1, 45, 80), (128, 128, 126, 2), (3, 3), 2, "f32"),  # the RAFT grids: a head
    ((1, 45, 80), (128, 128, 126, 2), (1, 5), 256, "f32"),  # 64 channels, k-split
    ((1, 63, 125), (128, 128, 126, 2), (1, 5), 256, "leaky"),  # 64 channels
    ((1, 45, 80), (128, 128, 126, 2), (5, 1), 128, "f32"),  # 32 channels, k-split
    ((1, 63, 125), (256,), (1, 1), 576, "residual"),  # 32 channels
    ((1, 45, 80), (192, 64), (3, 3), 192, "residual"),  # 16 channels, k-split; part 1 a 4-byte aligned view
    ((1, 45, 80), (256,), (1, 1), 576, "anchor"),  # 16 channels
    ((2, 37, 53), (5, 7, 3, 1), (1, 5), 126, "anchor"),  # ragged, batch 2
    ((2, 23, 41), (324,), (5, 1), 126, "residual"),
]


def fma_branch(plan) -> str:
    """Which of k1_plan's f32 choices a plan is (ops/fused_conv.py::_fma_plan)."""
    if plan.rows == 16:
        return "full, head" if plan.cg == 1 else f"full, {plan.resident} resident"
    if plan.cg == 1:
        return "grid, head"
    return f"grid, {8 * plan.cg} channels, {'k-split' if plan.kg > 1 else 'one k-group'}"


FMA_BRANCHES = 10  # full: head, 1 or 2 resident; grid: head, 64/32/16 channels with and without a k-split


def k1_fma_ragged(gen) -> float:
    """The FMA kernel on every branch of k1_plan's f32 choice (FMA_CASES):
    the 4-part GRU concat (128, 128, 126, 2), odd parts copied by element, a
    part that is a view aligned to 4 bytes only, all four tap shapes, H, W
    and Cout off the tile, batches of 2, every epilogue; against the twin
    within 1e-5 + 1e-5*max|ref| (f32 sums in another order), and two
    launches on the same inputs bit-equal."""
    worst, branches = 0.0, set()
    for (b, h, w), parts, (kh, kw), cout, epi in FMA_CASES:
        cin = sum(parts)
        xs = [torch.randn(b, h, w, c, generator=gen, device="cuda") for c in parts]
        if parts == (192, 64):  # a contiguous view one float into its buffer
            xs[1] = torch.randn(b * h * w * 64 + 1, generator=gen, device="cuda")[1:].view(b, h, w, 64)
        cw = conv_weights(torch.randn(kh, kw, cin, cout, generator=gen, device="cuda") / (kh * kw * cin) ** 0.5,
                          torch.rand(cout, generator=gen, device="cuda") + 0.5,
                          torch.randn(cout, generator=gen, device="cuda") * 0.1)
        split = max(1, cout // 3)
        kwargs = {
            "residual": dict(act="tanh", residual=torch.randn(b, h, w, cout, generator=gen, device="cuda")),
            "anchor": dict(anchor=[torch.rand(b, h, w, c, generator=gen, device="cuda") for c in (split, cout - split)]),
            "f32": dict(act="sigmoid", out_dtype=torch.float32),
            "leaky": dict(act="leaky"),
        }[epi]
        aligns = None if not any(x.data_ptr() % 16 for x in xs) else tuple(min(16, x.data_ptr() & -x.data_ptr()) for x in xs)
        plan = k1_plan(torch.float32, kh, kw, parts, h, w, cout, b, aligns)
        branches.add(fma_branch(plan))
        got, again = fused_conv(xs, cw, **kwargs), fused_conv(xs, cw, **kwargs)
        ref = fused_conv_reference(xs, cw, **kwargs)
        err = float((got - ref).abs().max())
        if not err <= 1e-5 + 1e-5 * float(ref.abs().max()):
            fail(f"K1 FMA kernel on {(b, h, w)} {kh}x{kw} parts {parts} -> {cout} {epi} ({fma_branch(plan)}, {plan}): "
                 f"err {err}")
        if not torch.equal(got, again):
            fail(f"K1 FMA kernel: two launches on {(b, h, w)} {kh}x{kw} parts {parts} -> {cout} differ")
        worst = max(worst, err)
    if len(branches) != FMA_BRANCHES:
        fail(f"the f32 cases reached {len(branches)} of k1_plan's {FMA_BRANCHES} f32 branches: {sorted(branches)}")
    print(f"K1 FMA kernel, {len(FMA_CASES)} cases on all {FMA_BRANCHES} f32 plan branches ({', '.join(sorted(branches))}): "
          f"GRU concat, odd parts, a 4-byte aligned view, 1x1/3x3/1x5/5x1, ragged H/W/Cout, batch 2, "
          f"residual/anchor/f32-out/leaky: max_abs_err={worst:.3e} tol=1e-5 + 1e-5*max|ref|, "
          f"two launches bit-equal ok", flush=True)
    return worst


def conv3x3_inputs(cin, cout, gen):
    """A 1080p bf16 activation in [0, 1) (a relu output), bf16 weights and
    an f32 bias at the scale of a trained layer."""
    x = torch.rand(1, H, W, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.1 * torch.randn(3, 3, cin, cout, generator=gen, device="cuda")).to(torch.bfloat16)
    b = 0.01 * torch.randn(cout, generator=gen, device="cuda")
    return x, w, b


def phase3_main_path(fast, highest, gen, report, smi):
    frames = torch.rand(CHUNK, 1, H, W, 3, generator=gen, device="cuda")
    frames = (frames * 255).to(torch.uint8)
    flags = torch.zeros(CHUNK, dtype=torch.bool)
    flags[0] = flags[4] = True
    carry = init_carry(fast, (1, H, W, 3))
    kw = dict(of_scale=OF_SCALE, raft_iters=ITERS, emit="u8")

    (h2, h3), carry = predict_chunk(fast, frames, carry, flags, **kw)  # warm-up
    torch.cuda.synchronize()
    spans.reset_counts()
    (h2, h3), carry = predict_chunk(fast, frames, carry, flags, **kw)
    torch.cuda.synchronize()
    counts = dict(spans.COUNTS)
    expect = launches(K1_PER_FRAME * CHUNK, GRU_PER_FRAME * CHUNK, EQ_PER_FRAME * CHUNK)
    print(f"main path launches over {CHUNK} frames: {counts} (expected {expect})", flush=True)
    if counts != expect:
        fail("launch counts differ from the design")
    if h2.shape != (CHUNK, 1, H, W, 3) or h3.dtype != torch.uint8:
        fail(f"unexpected output {tuple(h2.shape)} {h3.dtype}")
    for k, v in carry.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"carry {k} is not finite")
    if int(h3.max()) == 0:
        fail("H3 is all zero")

    per_frame = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict_chunk(fast, frames, carry, flags, **kw)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t0) * 1e3 / CHUNK)
    ms = statistics.median(per_frame)
    print(f"main path 1080p of_scale={OF_SCALE} iters={ITERS} fast chunk={CHUNK}: "
          f"{ms:.3f} ms/frame median of {[round(v, 3) for v in per_frame]} on {smi}", flush=True)
    report["main_path"] = {"ms_per_frame": ms, "per_chunk_ms_per_frame": per_frame,
                           "launches": counts, "frames": CHUNK,
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["trace"] = trace_path(lambda: predict_chunk(fast, frames, carry, flags, **kw), CHUNK, "main path",
                               {MMA: K1_PER_FRAME, FMA: 0})

    # the same chunk in the default precision (highest: f32 operands, K1 on
    # the FMA kernel), after a warm-up chunk: its launches, ms/frame and trace
    carry32 = init_carry(highest, (1, H, W, 3))
    predict_chunk(highest, frames, carry32, flags, **kw)
    torch.cuda.synchronize()
    spans.reset_counts()
    (h2, h3), carry32 = predict_chunk(highest, frames, carry32, flags, **kw)
    torch.cuda.synchronize()
    counts32 = dict(spans.COUNTS)
    expect = launches(K1_PER_FRAME * CHUNK, GRU_PER_FRAME * CHUNK, EQ_PER_FRAME * CHUNK, f32=True)
    print(f"main path, highest, launches over {CHUNK} frames: {counts32} (expected {expect})", flush=True)
    if counts32 != expect:
        fail("highest-mode launch counts differ from the design")
    if h3.dtype != torch.uint8 or int(h3.max()) == 0 or not all(bool(torch.isfinite(v).all()) for v in carry32.values()):
        fail("the highest-mode chunk's outputs are not what the fast one's are")
    per_frame = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict_chunk(highest, frames, carry32, flags, **kw)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t0) * 1e3 / CHUNK)
    ms = statistics.median(per_frame)
    print(f"main path 1080p of_scale={OF_SCALE} iters={ITERS} highest chunk={CHUNK}: "
          f"{ms:.3f} ms/frame median of {[round(v, 3) for v in per_frame]} on {smi}", flush=True)
    report["main_path_highest"] = {"ms_per_frame": ms, "per_chunk_ms_per_frame": per_frame, "launches": counts32,
                                   "frames": CHUNK}
    report["main_path_highest"]["trace"] = trace_path(
        lambda: predict_chunk(highest, frames, carry32, flags, **kw), CHUNK, "main path highest",
        {MMA: 0, FMA: K1_PER_FRAME})
    return counts, counts32


def kernel_id(name: str) -> str:
    """A device kernel's qualified name without its return type, template and
    parameter lists: 'void zt::gru_reset_kernel<float, float>(...)' ->
    'zt::gru_reset_kernel'."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anonymous")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def trace_path(run, frames: int, label: str, k1_per_frame: dict) -> dict:
    """torch.profiler over ``run`` (``frames`` frames of a path): device ms
    and kernels per frame for each of the port's kernels and for the
    heaviest other kernels, all by exact name, and the device's idle share
    (1 - union of kernel intervals / traced window). ``k1_per_frame``: how
    often a frame must run each of K1's two kernels; the trace fails on any
    other count."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start]
    if not events:
        fail("the profiler recorded no device kernels")
    by_name: dict[str, list[float]] = {}
    for e in events:
        ms_n = by_name.setdefault(kernel_id(e.name), [0.0, 0.0])
        ms_n[0] += (e.time_range.end - e.time_range.start) / 1e3 / frames
        ms_n[1] += 1 / frames
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    missing = sorted(set(OWN_KERNELS) - set(k1_per_frame) - set(by_name))
    if missing:
        fail(f"the trace holds no device kernel named {missing}")
    k1_seen = {k: round(by_name.get(k, [0.0, 0.0])[1], 6) for k in k1_per_frame}
    print(f"{label} trace K1 kernels per frame: {k1_seen} (expected {k1_per_frame})", flush=True)
    if k1_seen != {k: float(v) for k, v in k1_per_frame.items()}:
        fail(f"{label}: K1 ran on the wrong kernel")
    own = [(k, v) for k, v in rows if k in OWN_KERNELS]
    other = [(k, v) for k, v in rows if k not in OWN_KERNELS]
    print(f"{label} trace of {frames} frames: device busy {busy / 1e3 / frames:.3f} of a {window / 1e3 / frames:.3f} "
          f"ms/frame window, idle share {1 - busy / window:.4f}, {len(events) / frames:.1f} device "
          f"kernels/frame", flush=True)
    for k, (ms, n) in own + other[:12]:
        name = f"{k} ({OWN_KERNELS[k]})" if k in OWN_KERNELS else k
        print(f"{label} trace {ms:9.4f} ms/frame {n:7.2f} kernels/frame  {name}", flush=True)
    rest = other[12:]
    print(f"{label} trace {sum(v[0] for _, v in rest):9.4f} ms/frame {sum(v[1] for _, v in rest):7.2f} "
          f"kernels/frame  {len(rest)} other kernel names", flush=True)
    return {
        "busy_ms_per_frame": busy / 1e3 / frames, "window_ms_per_frame": window / 1e3 / frames,
        "idle_share": 1 - busy / window, "kernels_per_frame": len(events) / frames,
        "ms_and_kernels_per_frame_by_name": dict(rows),
    }


def phase4_card_vs_cpu(sd, gen, report):
    h, w = 96, 128
    frames = torch.rand(4, 1, h, w, 3, generator=torch.Generator().manual_seed(SEED))
    flags = torch.tensor([True, False, True, False])
    kw = dict(of_scale=2, raft_iters=3)
    out = {}
    # f32: every sum in f32 on both sides, in another order; fast: bf16
    # activations, where one rounding apart can move a value by 2^-8
    for mode, tol in (("highest", 1e-3), ("fast", 5e-2)):
        res = {}
        for dev in ("cuda", "cpu"):
            m = build_model(sd, device=dev, precision=mode)
            (H2, H3, s3), _ = predict_chunk(m, frames, init_carry(m, (1, h, w, 3)), flags, **kw)
            res[dev] = [t.float().cpu() for t in (H2, H3, s3)]
        err = max(float((a - b).abs().max()) for a, b in zip(res["cuda"], res["cpu"]))
        finite = all(bool(torch.isfinite(t).all()) for t in res["cuda"])
        ok = finite and err <= tol
        print(f"whole path {h}x{w} {mode:7s} card vs CPU max_abs_err={err:.3e} tol={tol:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"card and CPU disagree on the whole path ({mode})")
        out[mode] = err

    # 2 training steps (reset, then a carried frame): the losses and the
    # parameter update. Adam normalises each step, so a gradient component
    # at rounding level moves by +-lr whichever sign rounding gives it: the
    # update is held by its cosine, not element by element
    for mode, loss_tol, cos_tol in (("highest", 1e-4, 0.999), ("fast", 2e-2, 0.98)):
        res = {}
        for dev in ("cuda", "cpu"):
            state = init_train_state(Config(precision=mode, **kw), sd, (1, h, w, 3), device=dev)
            before = [p.detach().clone() for p in state.optimizer.params]
            state, losses = train_chunk(state, frames[:2], flags[:2], **kw)
            delta = torch.cat([(p.detach() - b).flatten() for p, b in zip(state.optimizer.params, before)])
            res[dev] = (losses.cpu(), delta.cpu())
        (lc, dc), (lh, dh) = res["cuda"], res["cpu"]
        loss_err = float(((lc - lh).abs() / lh.abs()).max())
        cos = float(torch.dot(dc, dh) / (dc.norm() * dh.norm()))
        ok = bool(torch.isfinite(lc).all()) and loss_err <= loss_tol and cos >= cos_tol
        print(f"2 training steps {h}x{w} {mode:7s} card vs CPU: loss rel err={loss_err:.3e} (tol {loss_tol:g}), "
              f"update cosine={cos:.6f} (tol >= {cos_tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"card and CPU disagree on 2 training steps ({mode})")
        out[f"train_{mode}"] = {"loss_rel_err": loss_err, "update_cosine": cos}
    report["card_vs_cpu"] = out


def k1_bound_by(rows) -> str:
    """What bounds most of one frame's K1 bound time."""
    ops = sum(r["bound_ms"] * r["per_frame"] for r in rows if r["bound_by"] == "operations")
    total = sum(r["bound_ms"] * r["per_frame"] for r in rows)
    return "operations" if ops >= total / 2 else "bytes"


def k1_timing_rows(model, layers, gen) -> list[dict]:
    """Each layer's K1 launch on ``model``'s operands beside its twin, one
    library convolution (cuDNN ``F.conv2d`` on the same channels_last
    tensors, in the operands' dtype: the caller sets the TF32 switches) and
    its bound. Full-resolution calls are timed with CUDA events over
    back-to-back calls; at the RAFT grids the twin's and the library's calls
    are shorter than their host launches, so those are timed inside a CUDA
    graph."""
    rows = []
    for layer in layers:
        name, grid = layer[0], layer[3]
        cw = layer_weights(model, layer[1])
        xs, kwargs = k1_inputs(layer, cw.w.dtype, gen)
        timer = cuda_ms if grid == FULL else graph_ms
        ms = timer(lambda: fused_conv(xs, cw, **kwargs))
        plain = timer(lambda: fused_conv_reference(xs, cw, **kwargs))
        x_cl = torch.cat(xs, -1).permute(0, 3, 1, 2)
        w_cl = cw.w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bias = cw.shift.to(cw.w.dtype)
        pad = ((cw.w.shape[0] - 1) // 2, (cw.w.shape[1] - 1) // 2)
        lib = timer(lambda: F.conv2d(x_cl, w_cl, bias, padding=pad))
        bound, flops, by = k1_bound_ms(layer, cw)
        mode = "f32" if cw.w.dtype == torch.float32 else "bf16"
        rows.append({"layer": name, "mode": mode, "grid": GRID_LABELS[grid], "shape": [1, *grid, *cw.w.shape[2:]],
                     "taps": cw.w.shape[0] * cw.w.shape[1], "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9, "per_frame": layer[-1]})
        print(f"time K1 {mode:4s} {name:25s} ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bound:.4f} ({by}, {bound / ms:.1%} of it reached) x{layer[-1]}/frame", flush=True)
    return rows


def k1_grid_sums(rows) -> dict:
    """Per grid, the sums over a frame's (or a pair's) launches of each
    timing, and the launches."""
    sums = {}
    for label in GRID_LABELS.values():
        sub = [r for r in rows if r["grid"] == label]
        if not sub:
            continue
        tot = {k: sum(r[k] * r["per_frame"] for r in sub) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        tot["launches"] = sum(r["per_frame"] for r in sub)
        sums[label] = tot
        print(f"time K1 {rows[0]['mode']} per {'pair' if label == '63x125' else 'frame'} at {label}: "
              f"ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} library_ms={tot['library_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f} over {tot['launches']} launches", flush=True)
    return sums


def phase5_timings(fast, highest, gen, report):
    rows = k1_timing_rows(fast, K1_LAYERS, gen)
    report["k1_layers"] = rows
    report["k1_per_frame"] = k1_grid_sums(rows)
    # f32 operands (highest mode) on the FMA kernel; the library is cuDNN's
    # f32 convolution with TF32 off, as highest mode's arithmetic
    with precision.numerics("highest"):
        rows32 = k1_timing_rows(highest, K1_F32_LAYERS, gen)
    report["k1_f32_layers"] = rows32
    report["k1_f32_per_grid"] = k1_grid_sums(rows32)
    rows32 = [r for r in rows32 if r["grid"] != "63x125"]  # a highest-mode frame's 121 launches

    # the host's side of one launch_k1 call (checks, plan, ctypes): calls
    # made back to back with no synchronisation, on a layer short enough
    # on the device (raft.fh1) that the host sets the pace
    layer = next(la for la in K1_LAYERS if la[0] == "raft.fh1")
    cw = layer_weights(fast, layer[1])
    xs, kwargs = k1_inputs(layer, cw.w.dtype, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        launch_k1(xs, cw, **kwargs)
    host_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    print(f"host time of one launch_k1 call (Python + ctypes, no synchronisation): {host_us:.2f} us", flush=True)
    report["launch_k1_host_us"] = host_us

    # K2: a whole update iteration, and the GRU kernel's share
    ub = fast.raft.update_block
    dt = ub.dtype
    net = torch.tanh(torch.randn(1, HR, WR, 128, generator=gen, device="cuda")).to(dt)
    inp = torch.relu(torch.randn(1, HR, WR, 128, generator=gen, device="cuda")).to(dt)
    corr = torch.randn(1, HR, WR, 324, generator=gen, device="cuda")
    flow = 3 * torch.randn(1, HR, WR, 2, generator=gen, device="cuda")
    flo = ub.flow_features(flow)
    iter_ms = cuda_ms(lambda: update_core(ub.kw, net, inp, corr, flo, flow))
    zr = torch.rand(1, HR, WR, 256, generator=gen, device="cuda")
    q = torch.rand(1, HR, WR, 128, generator=gen, device="cuda")
    net_f = net.float()
    hd = net.shape[-1]
    z, r = zr[..., :hd], zr[..., hd:]
    rh = torch.empty(net.shape, dtype=dt, device="cuda")

    # the four GRU launches of one main-path iteration (models/raft/update.py)
    def gru_four():
        gru.gru_reset(zr, net, dt)
        gru.gru_update(zr, q, net, (torch.float32, dt))
        gru.gru_reset(zr, net_f, dt)
        gru.gru_update(zr, q, net_f, (dt,))

    def gru_four_plain():
        gru.gru_reset_reference(zr, net, dt)
        gru.gru_update_reference(zr, q, net, (torch.float32, dt))
        gru.gru_reset_reference(zr, net_f, dt)
        gru.gru_update_reference(zr, q, net_f, (dt,))

    # the same four functions as library calls: torch.mul with the output
    # dtype's out=, torch.lerp on f32 net, and the casts they need
    def gru_four_library():
        torch.mul(r, net, out=rh)
        torch.lerp(net.float(), q, z).to(dt)
        torch.mul(r, net_f, out=rh)
        torch.lerp(net_f, q, z).to(dt)

    gru_ms = graph_ms(gru_four) / 4
    gru_plain = graph_ms(gru_four_plain) / 4
    gru_lib = graph_ms(gru_four_library) / 4
    n = HR * WR * 128
    # bytes of the four launches of one iteration, each tensor once
    gru_bytes = (n * (4 + 2 + 2) + n * (4 + 4 + 2 + 4 + 2) + n * (4 + 4 + 2) + n * (4 + 4 + 4 + 2))
    gru_bound = gru_bytes / PEAK_BYTES * 1e3 / 4
    print(f"time K2 update_core iteration ms={iter_ms:.4f} (13 launches); GRU kernel ms={gru_ms:.4f} "
          f"plain_ms={gru_plain:.4f} library_ms={gru_lib:.4f} bound_ms={gru_bound:.5f} (bytes), "
          f"CUDA-graph device time per launch", flush=True)

    report["k2"] = {"iteration_ms": iter_ms, "gru_ms": gru_ms, "gru_plain_ms": gru_plain,
                    "gru_library_ms": gru_lib, "gru_bound_ms": gru_bound, "launches_per_iteration": 13}
    report["k3"] = k3 = phase5_k3(gen)
    eq = k3["low-light"]["bf16"]  # the main path's call: a fast-mode frame

    # conv3x3_bf16 at the calls of its own path (phase 6), bf16 output; the
    # library call is one cuDNN conv on the same channels_last bf16 tensors
    c3 = []
    for cin, cout in CONV3X3_CALLS:
        x, w, b = conv3x3_inputs(cin, cout, gen)
        ms = cuda_ms(lambda: conv3x3_bf16(x, w, b))
        plain = cuda_ms(lambda: conv3x3_bf16_reference(x, w, b))
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = b.to(torch.bfloat16)
        lib = cuda_ms(lambda: F.conv2d(x_cl, w_cl, b16, padding=1))
        flops = 2.0 * H * W * cin * cout * 9
        nbytes = H * W * (cin + cout) * 2 + w.numel() * 2 + b.numel() * 4
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"call": f"{cin}->{cout}", "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        c3.append(row)
        print(f"time conv3x3_bf16 1080p {cin}->{cout} ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    report["conv3x3_bf16_timings"] = c3
    c3_sum = lambda key: sum(r[key] for r in c3)  # noqa: E731
    by = max(c3, key=lambda r: r["bound_ms"])["bound_by"]

    def per_frame(rs):
        return dict(**{k: sum(r[k] * r["per_frame"] for r in rs) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                    bound_by=k1_bound_by(rs))

    return {
        "fused_conv": per_frame(rows),
        "fused_conv_f32": per_frame(rows32),
        "gru": dict(ms=gru_ms * GRU_PER_FRAME, plain_ms=gru_plain * GRU_PER_FRAME,
                    bound_ms=gru_bound * GRU_PER_FRAME, library_ms=gru_lib * GRU_PER_FRAME,
                    bound_by="bytes"),
        "equalize_u8": dict(ms=eq["ms"], plain_ms=eq["plain_ms"], bound_ms=eq["bound_ms"], library_ms=None,
                            bound_by="bytes"),
        "conv3x3_bf16": dict(ms=c3_sum("ms"), plain_ms=c3_sum("plain_ms"), bound_ms=c3_sum("bound_ms"),
                             library_ms=c3_sum("library_ms"), bound_by=by),
    }


def phase5_k3(gen) -> dict:
    """K3 at the main path's (1, 360, 640, 3) on a uniform and a low-light
    frame (bins 0-63): the uint8 entry and the fused entry on f32 and bf16
    (fast mode's call), each beside its plain chain on the card (the ATen
    casts and the twin) and its bound, the bytes it must move: 2 * numel for
    the uint8 entry, numel * (sizeof(x) + 4) for the fused one. Device time
    inside a CUDA graph: one call is far shorter than its host launch."""
    h, w = H // OF_SCALE, W // OF_SCALE
    out = {}
    for case, scale in (("uniform", 1.0), ("low-light", 0.25)):
        x = torch.rand(1, h, w, 3, generator=gen, device="cuda") * scale
        rows = {}
        for entry, inp, run, twin, in_bytes, out_bytes in (
            ("u8", to_u8(x), equalize_u8, equalize_u8_reference, 1, 1),
            ("f32", x, equalize01, equalize01_reference, 4, 4),
            ("bf16", x.to(torch.bfloat16), equalize01, equalize01_reference, 2, 4),
        ):
            row = {"ms": graph_ms(lambda: run(inp)), "plain_ms": graph_ms(lambda: twin(inp)),
                   "bound_ms": inp.numel() * (in_bytes + out_bytes) / PEAK_BYTES * 1e3}
            rows[entry] = row
            name = "equalize_u8" if entry == "u8" else f"equalize01 {entry}"
            print(f"time K3 {name:15s} {case:9s} (1,{h},{w},3) ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.6f} (bytes, {row['bound_ms'] / row['ms']:.1%} of it reached), "
                  f"CUDA-graph device time", flush=True)
        out[case] = rows
    return out


def phase6_conv3x3_path(gen, report) -> int:
    """conv3x3_bf16 is on no model path (as in the JAX package): its path
    is its calls at 1080p, counted like every other."""
    inputs = [conv3x3_inputs(cin, cout, gen) for cin, cout in CONV3X3_CALLS]
    torch.cuda.synchronize()
    spans.reset_counts()
    outs = [conv3x3_bf16(x, w, b) for x, w, b in inputs]
    torch.cuda.synchronize()
    counts = dict(spans.COUNTS)
    expect = launches(c3=len(CONV3X3_CALLS))
    print(f"conv3x3_bf16 path launches: {counts} (expected {expect})", flush=True)
    if counts != expect:
        fail("conv3x3_bf16 path launch counts differ from the design")
    for (cin, cout), y in zip(CONV3X3_CALLS, outs):
        if y.shape != (1, H, W, cout) or y.dtype != torch.bfloat16 or not bool(torch.isfinite(y).all()):
            fail(f"conv3x3_bf16 {cin}->{cout}: {tuple(y.shape)} {y.dtype}")
    report["conv3x3_bf16_path"] = counts
    return counts["conv3x3_bf16"]


def phase7_training(sd, report, smi) -> dict:
    """train_chunk at the full 1080p operating point in each precision."""
    frames = torch.rand(TRAIN_FRAMES, 1, H, W, 3, generator=torch.Generator().manual_seed(SEED)) * 0.25
    frames = frames.cuda()
    flags = torch.zeros(TRAIN_FRAMES, dtype=torch.bool)
    flags[0] = True
    kw = dict(of_scale=OF_SCALE, raft_iters=ITERS)
    out = {}
    for mode in ("fast", "highest"):
        expect = launches(K1_PER_TRAIN_FRAME * 2 * TRAIN_FRAMES, GRU_PER_FRAME * 2 * TRAIN_FRAMES,
                          EQ_PER_FRAME * 2 * TRAIN_FRAMES, f32=mode == "highest")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(Config(precision=mode, **kw), sd, (1, H, W, 3), device="cuda")
        reinit_enhancer(state.model, torch.Generator(device="cuda").manual_seed(SEED))
        state, _ = train_chunk(state, frames[:1], flags[:1], **kw)  # warm-up frame
        before = [p.detach().clone() for p in state.optimizer.params]
        bn = state.model.enhance.conv[1]
        stats0 = bn.running_mean.clone()
        torch.cuda.synchronize()
        spans.reset_counts()
        ms, losses = {}, []
        for bn_train in (True, False):
            t0 = time.perf_counter()
            state, loss = train_chunk(state, frames, flags, bn_train=bn_train, **kw)
            torch.cuda.synchronize()
            ms[bn_train] = (time.perf_counter() - t0) * 1e3 / TRAIN_FRAMES
            losses.append(loss)
            if bn_train:
                stats1 = bn.running_mean.clone()
        counts = dict(spans.COUNTS)
        losses = torch.cat(losses).cpu()
        peak = torch.cuda.max_memory_allocated() / 1e9
        moved = [bool((p.detach() != b).any()) for p, b in zip(state.optimizer.params, before)]
        print(f"training 1080p of_scale={OF_SCALE} iters={ITERS} {mode}: {ms[True]:.3f} ms/frame with batch-statistics "
              f"BatchNorm, {ms[False]:.3f} with running statistics ({TRAIN_FRAMES} frames each); peak device memory "
              f"{peak:.2f} GB; losses {[round(v, 3) for v in losses.tolist()]} on {smi}", flush=True)
        per_frame = {k: v / (2 * TRAIN_FRAMES) for k, v in counts.items()}
        print(f"training launches over {2 * TRAIN_FRAMES} frames: {counts} (expected {expect}); per frame "
              f"{per_frame}: K1 only in RAFT, K2's GRU, K3 once", flush=True)
        if counts != expect:
            fail(f"training launch counts differ from the design ({mode})")
        if not bool(torch.isfinite(losses).all()):
            fail(f"training losses are not finite ({mode})")
        if not all(moved):
            fail(f"{moved.count(False)} trainable parameter tensors did not move ({mode})")
        if torch.equal(stats1, stats0):
            fail(f"the running statistics did not move with batch-statistics BatchNorm ({mode})")
        if not torch.equal(bn.running_mean, stats1):
            fail(f"the running statistics moved while they normalised ({mode})")
        out[mode] = {"ms_per_frame_bn_train": ms[True], "ms_per_frame_bn_eval": ms[False], "peak_mem_gb": peak,
                     "losses": losses.tolist(), "launches": counts, "frames": 2 * TRAIN_FRAMES}
        out[mode]["trace"] = trace_path(
            lambda: train_chunk(state, frames, flags, **kw), TRAIN_FRAMES, f"training {mode}",
            {MMA: K1_PER_TRAIN_FRAME, FMA: 0} if mode == "fast" else {MMA: 0, FMA: K1_PER_TRAIN_FRAME},
        )
        del state, before
    report["training"] = out
    return out


CLI_FRAMES = 8  # the fixture's test frames: 2 scenes x 4
FIXTURE_SCENES, FIXTURE_FRAMES = ("S01", "S02"), 4
LONG_SCENES = 6  # the steady-state predict run: 6 scenes x 4 frames, linked to the fixture's two
CLI_FLAGS = ["--dataset", "RLV", "--of_scale", str(OF_SCALE), "--raft_iters", str(ITERS),
             "--frame_width", str(W), "--frame_height", str(H)]


def run_cli(label: str, main, argv: list[str]) -> tuple[float, str]:
    """One CLI ``main(argv)`` in this process with its standard output
    captured: (wall seconds, output). Any exception fails the smoke."""
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - reported, and the run fails
        print(out.getvalue()[-4000:], flush=True)
        fail(f"{label}: {type(e).__name__}: {e}")
    finally:
        root = logging.getLogger()  # the CLI's handlers write to files of this run's temporary directory
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
    return time.perf_counter() - t0, out.getvalue()


def expect_counts(label: str, counts: dict, frames: int, train_frames: int = 0, *, f32: bool = False) -> None:
    """The launches ``frames`` inference frames and ``train_frames`` training
    (or training-model eval) frames make, in highest mode where ``f32``."""
    want = launches(K1_PER_FRAME * frames + K1_PER_TRAIN_FRAME * train_frames, GRU_PER_FRAME * (frames + train_frames),
                    EQ_PER_FRAME * (frames + train_frames), f32=f32)
    print(f"{label} launches: {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"{label}: launch counts differ from the design")


def reference_u8(model, frames, flags, chunk: int, enh_scale: int = 1):
    """predict_chunk(emit="u8") over the frames in chunks of ``chunk``, the
    carry threaded through: what the predict CLI must have written."""
    carry = init_carry(model, (1, H, W, 3))
    h2s, h3s = [], []
    for i in range(0, len(frames), chunk):
        (h2, h3), carry = predict_chunk(model, frames[i:i + chunk], carry, flags[i:i + chunk],
                                        of_scale=OF_SCALE, raft_iters=ITERS, enh_scale=enh_scale, emit="u8")
        h2s.append(h2.cpu())
        h3s.append(h3.cpu())
    return torch.cat(h2s)[:, 0].numpy(), torch.cat(h3s)[:, 0].numpy()


def check_predict_pngs(label: str, save: Path, recs, h2, h3) -> None:
    """The predict CLI's 2 PNGs per frame, at <save>/<scene>/<brightness>/,
    decode to exactly the reference's bytes."""
    want = {f"{Path(r.path).parts[-3]}/{Path(r.path).parts[-2]}/{r.name}_{kind}.png"
            for r in recs for kind in ("denoise", "enhance")}
    got = {str(p.relative_to(save)) for p in save.rglob("*.png")}
    if got != want:
        fail(f"{label}: wrote {sorted(got)[:4]}..., expected {sorted(want)[:4]}... ({len(got)} vs {len(want)})")
    worst = 0
    for i, r in enumerate(recs):
        d = save / Path(r.path).parts[-3] / Path(r.path).parts[-2]
        for kind, ref in (("denoise", h3[i]), ("enhance", h2[i])):
            img = native.read_rgb(d / f"{r.name}_{kind}.png")
            diff = int(np.abs(img.astype(np.int32) - ref.astype(np.int32)).max())
            worst = max(worst, diff)
            if diff:
                fail(f"{label}: {r.name}_{kind}.png differs from predict_chunk by up to {diff} levels")
    print(f"{label}: {len(want)} PNGs, each byte-equal to predict_chunk(emit='u8') (max diff {worst})",
          flush=True)


def steady_ms_per_frame(save: Path, first_scene: str, frames: int, chunk: int) -> float:
    """ms per frame of a predict CLI run at steady state, from its PNGs'
    modification times: from the last PNG of its first chunk (the scene
    ``first_scene``) to the last PNG of the run, over the frames between."""
    first = max(p.stat().st_mtime_ns for p in (save / first_scene).rglob("*.png"))
    last = max(p.stat().st_mtime_ns for p in save.rglob("*.png"))
    return (last - first) / 1e6 / (frames - chunk)


def time_png_writers(tmp: Path, images) -> dict:
    """ms per 1080p PNG of the port's writer, and of Pillow's and OpenCV's
    where they import (the port needs neither), on the same images."""
    writers = {"port": lambda path, img: native.write_png(path, img)}
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        writers["pillow"] = lambda path, img: Image.fromarray(img).save(path)
    if importlib.util.find_spec("cv2") is not None:
        import cv2

        writers["opencv"] = lambda path, img: cv2.imwrite(str(path), img[..., ::-1])
    out = {}
    for name, write in writers.items():
        t0 = time.perf_counter()
        for img in images:
            write(tmp / f"w_{name}.png", img)
        out[name] = (time.perf_counter() - t0) * 1e3 / len(images)
    return out


def log_epoch_ms(log: str, epoch: int, frames: int, chunk: int) -> float | None:
    """ms per training frame of one epoch's loop, from log.txt's stamps:
    from the end of its first chunk to the end of its last."""
    stamps = []
    for line in log.splitlines():
        m = re.match(rf"(\S+ \S+) train-epoch {epoch:03d} (\d+) ", line)
        if m:
            stamps.append((int(m.group(2)), time.mktime(time.strptime(m.group(1)[:19], "%Y-%m-%d %H:%M:%S"))
                           + int(m.group(1)[20:]) / 1e3))
    ends = [t for i, t in stamps if i % chunk == chunk - 1]
    if len(ends) < 2:
        return None
    return (ends[-1] - ends[0]) * 1e3 / (frames - chunk)


def phase8_cli(sd, report, smi, main_ms: float) -> None:
    """The command-line entry points at 1080p, in this process."""
    found = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    print(f"importable on this machine (the port needs neither for PNG frames): Pillow {found['PIL']}, "
          f"OpenCV {found['cv2']}", flush=True)
    out: dict = {"pillow_importable": found["PIL"], "cv2_importable": found["cv2"]}
    with tempfile.TemporaryDirectory(prefix="zt_cli_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        fx = make_rlv_fixture(str(tmp / "rlv"), scenes=FIXTURE_SCENES, frames_per_scene=FIXTURE_FRAMES,
                              size=(W, H), occluder=True)
        fx4 = tmp / "rlv4"  # the first scene alone: 4 frames
        fx4.mkdir()
        (fx4 / "input").symlink_to(Path(fx) / "input", target_is_directory=True)
        (fx4 / "gt").symlink_to(Path(fx) / "gt", target_is_directory=True)
        for lst in ("train_list.txt", "test_list.txt"):
            (fx4 / lst).write_text(FIXTURE_SCENES[0] + "\n")
        fx2 = tmp / "rlv2"  # its first 2 frames, for evals (its metrics take seconds a 1080p frame on the host)
        (fx2 / "input" / FIXTURE_SCENES[0] / "low_light_10").mkdir(parents=True)
        for f in sorted((Path(fx) / "input" / FIXTURE_SCENES[0] / "low_light_10").glob("*.png"))[:2]:
            (fx2 / "input" / FIXTURE_SCENES[0] / "low_light_10" / f.name).symlink_to(f)
        (fx2 / "gt").symlink_to(Path(fx) / "gt", target_is_directory=True)
        for lst in ("train_list.txt", "test_list.txt"):
            (fx2 / lst).write_text(FIXTURE_SCENES[0] + "\n")
        fx_long = tmp / "rlv_long"  # LONG_SCENES scenes, each a link to a scene of the fixture: a longer stream
        for i in range(LONG_SCENES):
            (fx_long / "input").mkdir(parents=True, exist_ok=True)
            (fx_long / "input" / f"L{i}").symlink_to(Path(fx) / "input" / FIXTURE_SCENES[i % 2],
                                                     target_is_directory=True)
        for lst in ("train_list.txt", "test_list.txt"):
            (fx_long / lst).write_text("".join(f"L{i}\n" for i in range(LONG_SCENES)))
        pt = tmp / "seeded.pt"
        save_pt(pt, build_model(sd, device="cpu", precision="highest"))
        print(f"fixture: {len(FIXTURE_SCENES)} scenes x {FIXTURE_FRAMES} frames of {W}x{H} with ground truth and "
              f"the occluder, and the seeded weights as a .pt, in {time.perf_counter() - t0:.1f} s", flush=True)

        # the frames as the CLI reads them, and the decode's own time (the
        # codec's one-time build first: a checkout builds it at first use)
        t0 = time.perf_counter()
        native.library()
        print(f"PNG codec built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
        ds = create_dataset("RLV", fx, "test", size=(W, H))
        t0 = time.perf_counter()
        recs = list(ds.iter_u8())
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(recs)
        if len(recs) != CLI_FRAMES:
            fail(f"the fixture's test split holds {len(recs)} frames, not {CLI_FRAMES}")
        frames = torch.from_numpy(np.stack([r.image for r in recs])[:, None]).cuda()
        flags = torch.tensor([r.is_new_seq for r in recs])
        if flags.tolist() != [True, False, False, False] * 2:
            fail(f"is_new_seq over the fixture: {flags.tolist()}")

        # (b) predict, fast, chunks of 4: twice, the second run timed
        fast = build_model(sd, device="cuda", precision="fast")
        ref_h2, ref_h3 = reference_u8(fast, frames, flags, 4)
        common = CLI_FLAGS + ["--lowlight_images_path", fx, "--model_pretrain", str(pt)]
        runs = []
        for run in range(2):
            save = tmp / f"pred_fast_{run}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            spans.reset_counts()
            secs, _ = run_cli(f"predict fast run {run}", cli_predict.main,
                              common + ["--save", str(save), "--precision", "fast", "--chunk", "4"])
            counts = dict(spans.COUNTS)
            peak = torch.cuda.max_memory_allocated() / 1e9
            expect_counts(f"predict CLI fast run {run}", counts, CLI_FRAMES)
            check_predict_pngs(f"predict CLI fast run {run}", save, recs, ref_h2, ref_h3)
            runs.append({"ms_per_frame": secs * 1e3 / CLI_FRAMES, "peak_mem_gb": peak, "launches": counts})
        # the same CLI on a stream of LONG_SCENES x 4 frames, timed at steady
        # state: what a user streaming a folder sees a frame, set-up excluded
        long_recs = list(create_dataset("RLV", str(fx_long), "test", size=(W, H)).iter_u8())
        long_flags = torch.tensor([r.is_new_seq for r in long_recs])
        long_h2, long_h3 = reference_u8(
            fast, torch.from_numpy(np.stack([r.image for r in long_recs])[:, None]).cuda(), long_flags, 4)
        save = tmp / "pred_fast_long"
        spans.reset_counts()
        secs, _ = run_cli("predict fast long", cli_predict.main,
                          CLI_FLAGS + ["--lowlight_images_path", str(fx_long), "--model_pretrain", str(pt),
                                       "--save", str(save), "--precision", "fast", "--chunk", "4"])
        expect_counts("predict CLI fast long", dict(spans.COUNTS), len(long_recs))
        steady_ms = steady_ms_per_frame(save, "L0", len(long_recs), 4)
        check_predict_pngs("predict CLI fast long", save, long_recs, long_h2, long_h3)
        del long_recs, long_h2, long_h3
        # the PNG writes of one run on their own: 2 per frame; then the
        # port's writer beside Pillow's and OpenCV's on the first 2 frames
        t0 = time.perf_counter()
        for i in range(CLI_FRAMES):
            native.write_png(tmp / "w_denoise.png", ref_h3[i])
            native.write_png(tmp / "w_enhance.png", ref_h2[i])
        write_ms = (time.perf_counter() - t0) * 1e3 / CLI_FRAMES
        writers = time_png_writers(tmp, [ref_h3[0], ref_h2[0], ref_h3[1], ref_h2[1]])
        cli_ms = runs[1]["ms_per_frame"]
        print(f"predict CLI 1080p fast chunk=4: {steady_ms:.3f} ms/frame at steady state over the last "
              f"{4 * LONG_SCENES - 4} of {4 * LONG_SCENES} frames (PNG times; {secs * 1e3 / (4 * LONG_SCENES):.3f} "
              f"wall with set-up); {cli_ms:.3f} ms/frame wall over {CLI_FRAMES} frames with model build, .pt load "
              f"and data set-up (first run {runs[0]['ms_per_frame']:.3f}); frame decode (iter_u8) "
              f"{decode_ms:.3f} ms/frame; PNG writes (2 a frame) {write_ms:.3f} ms/frame; phase 3's predict_chunk "
              f"{main_ms:.3f} ms/frame; peak device memory {runs[1]['peak_mem_gb']:.3f} GB on {smi}", flush=True)
        print("1080p PNG writers, ms per PNG on the first 2 frames' 4 outputs: "
              + ", ".join(f"{k} {v:.3f}" for k, v in writers.items()), flush=True)
        out["predict_fast"] = {"runs": runs, "cli_ms_per_frame": cli_ms, "decode_ms_per_frame": decode_ms,
                               "png_write_ms_per_frame": write_ms, "predict_chunk_ms_per_frame": main_ms,
                               "frames": CLI_FRAMES, "steady_ms_per_frame": steady_ms,
                               "long_frames": 4 * LONG_SCENES, "long_wall_ms_per_frame": secs * 1e3 / (4 * LONG_SCENES),
                               "png_writer_ms_per_png": writers}

        # the Enhancer at half resolution (--enh_scale 2), 4 frames
        ref_h2, ref_h3 = reference_u8(fast, frames[:4], flags[:4], 4, enh_scale=2)
        save = tmp / "pred_enh2"
        spans.reset_counts()
        secs, _ = run_cli("predict enh_scale 2", cli_predict.main,
                          CLI_FLAGS + ["--lowlight_images_path", str(fx4), "--model_pretrain", str(pt),
                                       "--save", str(save), "--precision", "fast", "--chunk", "4",
                                       "--enh_scale", "2"])
        expect_counts("predict CLI fast --enh_scale 2", dict(spans.COUNTS), 4)
        check_predict_pngs("predict CLI fast --enh_scale 2", save, recs[:4], ref_h2, ref_h3)
        out["predict_enh_scale2"] = {"ms_per_frame": secs * 1e3 / 4, "frames": 4}
        del fast

        # (c) predict, the default precision (highest: the f32 K1), 4 frames
        highest = build_model(sd, device="cuda", precision="highest")
        ref_h2, ref_h3 = reference_u8(highest, frames[:4], flags[:4], 4)
        del highest
        save = tmp / "pred_highest"
        spans.reset_counts()
        secs, _ = run_cli("predict highest", cli_predict.main,
                          CLI_FLAGS + ["--lowlight_images_path", str(fx4), "--model_pretrain", str(pt),
                                       "--save", str(save), "--chunk", "4"])
        expect_counts("predict CLI highest", dict(spans.COUNTS), 4, f32=True)
        check_predict_pngs("predict CLI highest", save, recs[:4], ref_h2, ref_h3)
        out["predict_highest"] = {"ms_per_frame": secs * 1e3 / 4, "frames": 4}
        print(f"predict CLI 1080p highest chunk=4: {secs * 1e3 / 4:.3f} ms/frame wall over 4 frames", flush=True)

        # (d) train, fast, 2 epochs of 8 frames in chunks of 2, then a resume
        exp = tmp / "exp"
        train_flags = CLI_FLAGS + ["--lowlight_images_path", fx, "--precision", "fast", "--chunk", "2",
                                   "--epochs", "2"]
        spans.reset_counts()
        secs, _ = run_cli("train", cli_train.main, train_flags + ["--save", str(exp)])
        # 2 epochs of 8 training frames and 8 eval frames, all on the training model
        expect_counts("train CLI", dict(spans.COUNTS), 0, 4 * CLI_FRAMES)
        (run_dir,) = glob.glob(str(exp / "Train-*"))
        run_dir = Path(run_dir)
        log = (run_dir / "log.txt").read_text()
        losses = [float(v) for v in re.findall(r"train-epoch \d{3} \d{3} (\S+)", log)]
        if len(losses) != 2 * CLI_FRAMES or not all(math.isfinite(v) for v in losses):
            fail(f"train CLI losses: {losses}")
        for name in ("weights_0.pt", "weights_1.pt", "state_0.pt", "state_1.pt"):
            if not (run_dir / "model_epochs" / name).exists():
                fail(f"train CLI wrote no model_epochs/{name}")
        for kind in ("denoise", "enhance"):
            for e in (0, 1):
                n = len(list((run_dir / "result" / kind).glob(f"*_{kind}_{e}.png")))
                if n != CLI_FRAMES:
                    fail(f"train CLI: {n} {kind} PNGs for epoch {e}, expected {CLI_FRAMES}")
        train_ms = {e: log_epoch_ms(log, e, CLI_FRAMES, 2) for e in (0, 1)}
        print(f"train CLI 1080p fast chunk=2, 2 epochs x {CLI_FRAMES} frames: losses "
              f"{[round(v, 3) for v in losses]}; training loop {train_ms[0]:.3f} ms/frame in epoch 0 (batch "
              f"statistics), {train_ms[1]:.3f} in epoch 1 (running statistics), from log.txt's stamps; "
              f"{secs:.1f} s wall with the eval dumps and saves", flush=True)
        # the resumed run's epoch on the first scene alone: what is checked is where it starts
        resume_flags = [f if f != fx else str(fx4) for f in train_flags]
        secs_r, _ = run_cli("train --resume", cli_train.main,
                            resume_flags + ["--save", str(tmp / "exp_resume"),
                                            "--resume", str(run_dir / "model_epochs" / "state_0.pt")])
        (resumed,) = glob.glob(str(tmp / "exp_resume" / "Train-*"))
        rlog = (Path(resumed) / "log.txt").read_text()
        if "(epoch 1)" not in rlog or "train-epoch 000" in rlog or "train-epoch 001 003" not in rlog:
            fail("train CLI --resume state_0.pt did not run epoch 1 alone")
        print(f"train CLI --resume state_0.pt: started at epoch 1 ({secs_r:.1f} s)", flush=True)
        out["train_fast"] = {"losses": losses, "loop_ms_per_frame": train_ms, "wall_s": secs, "resume_wall_s": secs_r}

        # (e) evals with weights_1.pt on 2 frames
        save = tmp / "eval"
        secs, _ = run_cli("evals", cli_evals.main,
                          CLI_FLAGS + ["--lowlight_images_path", str(fx2), "--precision", "fast",
                                       "--model_pretrain", str(run_dir / "model_epochs" / "weights_1.pt"),
                                       "--save", str(save)])
        metrics = json.loads((save / "Metrics.json").read_text())
        keys = {"Total_PSNR", "Total_SSIM", "Total_LPIPS", "Total_PSNR_HM", "Total_SSIM_HM", "Total_LPIPS_HM"}
        finite = all(math.isfinite(metrics[k]) for k in keys if "LPIPS" not in k)
        if set(metrics) != keys or not finite or metrics["Total_LPIPS"] is not None:
            fail(f"evals Metrics.json: {metrics}")
        print(f"evals CLI 1080p fast, 2 frames with weights_1.pt: {metrics} ({secs:.1f} s)", flush=True)
        out["evals"] = {"metrics": metrics, "wall_s": secs}
    report["cli"] = out


SERVE_SCENES, SERVE_FRAMES, SERVE_CHUNK = ("S01", "S02"), 6, 4  # 4 in one chunk, 2 frame by frame, a scene


def serve_reference(model, frames, flags):
    """What the daemon must write for one scene, as uint8 (H2, H3): a
    settled backlog of SERVE_FRAMES runs as one predict_chunk(emit="u8") of
    SERVE_CHUNK frames, then predict_step frame by frame, the carry threaded
    through; the per-frame outputs quantised with the PNG writer's formula."""
    carry = init_carry(model, (1, H, W, 3))
    kw = dict(of_scale=OF_SCALE, raft_iters=ITERS)
    (h2, h3), carry = predict_chunk(model, frames[:SERVE_CHUNK], carry, flags[:SERVE_CHUNK], emit="u8", **kw)
    h2s, h3s = list(h2[:, 0].cpu().numpy()), list(h3[:, 0].cpu().numpy())
    for k in range(SERVE_CHUNK, len(frames)):
        (H2, H3, _), carry = predict_step(model, frames[k], carry, bool(flags[k]), **kw)
        h2s.append(to_u8(H2[0]).cpu().numpy())
        h3s.append(to_u8(H3[0]).cpu().numpy())
    return h2s, h3s


def phase9_serve(sd, report, smi, main_ms: float) -> None:
    """The inbox daemon at 1080p, in this process: 2 scenes of 6 frames."""
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="zt_serve_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        fx = make_rlv_fixture(str(tmp / "rlv"), scenes=SERVE_SCENES, frames_per_scene=SERVE_FRAMES,
                              size=(W, H), occluder=True)
        pt = tmp / "seeded.pt"
        save_pt(pt, build_model(sd, device="cpu", precision="highest"))
        inbox, save = Path(fx) / "input", tmp / "served"
        recs = list(create_dataset("RLV", fx, "test", size=(W, H)).iter_u8())
        if len(recs) != len(SERVE_SCENES) * SERVE_FRAMES:
            fail(f"the serve fixture holds {len(recs)} frames")
        print(f"serve fixture: {len(SERVE_SCENES)} scenes x {SERVE_FRAMES} frames of {W}x{H} and the seeded .pt, "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        fast = build_model(sd, device="cuda", precision="fast")
        frames = torch.from_numpy(np.stack([r.image for r in recs])[:, None]).cuda()
        flags = torch.tensor([r.is_new_seq for r in recs])
        ref_h2, ref_h3 = [], []
        for i in range(0, len(recs), SERVE_FRAMES):
            h2, h3 = serve_reference(fast, frames[i:i + SERVE_FRAMES], flags[i:i + SERVE_FRAMES])
            ref_h2 += h2
            ref_h3 += h3
        del fast, frames
        argv = CLI_FLAGS + ["--lowlight_images_path", str(inbox), "--model_pretrain", str(pt), "--save", str(save),
                            "--precision", "fast", "--chunk", str(SERVE_CHUNK), "--serve_settle_sec", "0",
                            "--serve_poll_sec", "0.05", "--serve_max_idle_sec", "600"]
        manifest = save / "manifest.jsonl"

        def stop_after_last_output():
            while not manifest.exists() or len(manifest.read_text().splitlines()) < len(recs):
                time.sleep(0.05)
            (inbox / "STOP").touch()

        stopper = threading.Thread(target=stop_after_last_output, daemon=True)
        stopper.start()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        spans.reset_counts()
        secs, _ = run_cli("serve", cli_serve.main, argv)
        counts = dict(spans.COUNTS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        stopper.join(timeout=5)
        expect_counts("serve daemon", counts, len(recs))
        check_predict_pngs("serve daemon", save, recs, ref_h2, ref_h3)
        lines = [json.loads(line) for line in manifest.read_text().splitlines()]
        want = [(Path(r.path).parts[-3], int(r.name), bool(f)) for r, f in zip(recs, flags)]
        got = [(Path(rec["scene"]).parts[-2], rec["index"], rec["new_seq"]) for rec in lines]
        if got != want:
            fail(f"serve manifest: {got} != {want}")
        # steady state: from the end of the first chunk to the last frame
        stamps = sorted(rec["t"] for rec in lines)
        steady = (stamps[-1] - stamps[SERVE_CHUNK - 1]) * 1e3 / (len(stamps) - SERVE_CHUNK)
        (inbox / "STOP").unlink()
        again, _ = run_cli("serve again", cli_serve.main,
                           argv[:-1] + ["0.5"])  # nothing to serve: out after 0.5 s idle
        if len(manifest.read_text().splitlines()) != len(recs):
            fail("serve again: the manifest grew on an inbox already served")
        per_frame = {k: v / len(recs) for k, v in counts.items()}
        print(f"serve daemon 1080p fast --chunk {SERVE_CHUNK}, {len(recs)} frames: {steady:.3f} ms/frame at steady "
              f"state (manifest stamps, last {len(stamps) - SERVE_CHUNK} frames); {secs * 1e3 / len(recs):.3f} ms/frame "
              f"wall with set-up; launches per frame {per_frame} (phase 3's); peak device memory {peak:.3f} GB; "
              f"phase 3's predict_chunk {main_ms:.3f} ms/frame; a second run on the served inbox served 0 frames "
              f"({again:.1f} s) on {smi}", flush=True)
        out = {"steady_ms_per_frame": steady, "wall_ms_per_frame": secs * 1e3 / len(recs), "frames": len(recs),
               "launches": counts, "peak_mem_gb": peak, "second_run_s": again}
    report["serve"] = out


BAND_CASES = (1, 2, 4)  # bands; 1 is train_step itself
BAND_HALO = 32


def _grads(model) -> dict:
    out = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return out


def phase10_banded(sd, report, smi) -> None:
    """Banded training at 1080p: train_step_spatial against train_step."""
    g = torch.Generator().manual_seed(SEED)
    frame = (torch.rand(1, H, W, 3, generator=g) * 0.25).cuda()
    carry = {"last_H3": torch.rand(1, H, W, 3, generator=g).cuda() * 0.5,
             "last_s3": torch.rand(1, H, W, 3, generator=g).cuda() * 0.5 + 0.25}
    kw = dict(of_scale=OF_SCALE, raft_iters=ITERS)
    new = torch.tensor(False)
    # (1) losses and gradients, from one state and frame: the whole frame,
    # then 4 bands. Highest: f32 with TF32 off. The loss is held to the CPU
    # test's 3e-6 relative (tests/test_torch_spatial.py); each gradient to
    # 1e-4 of its leaf's largest plus 1e-4 of itself, 5x the CPU test's
    # 2e-5: with the Enhancer's reference init and batch statistics, the
    # shared block conv's gradient is a difference of the loss path's and
    # the statistics' terms that nearly cancel, and measured 3.2e-5 on the
    # CPU at 96x64 (4 bands, halo 24); on the card cuDNN picks each
    # convolution's algorithm by shape, so a band and the frame also sum in
    # other orders. Fast: bf16 activations, where one rounding apart moves a
    # value by 2^-8: losses within 1e-3, each leaf's gradient cosine >= 0.99.
    limits = {"highest": (3e-6, 1e-4, 1e-4), "fast": (1e-3, None, 0.0)}
    agree = {}
    for mode in ("highest", "fast"):
        for bn_train in (True, False):
            state = init_train_state(Config(precision=mode, **kw), sd, (1, H, W, 3), device="cuda")
            reinit_enhancer(state.model, torch.Generator(device="cuda").manual_seed(SEED))
            state = state._replace(carry={k: v.clone() for k, v in carry.items()})
            model, bn = state.model, state.model.enhance.conv[1]
            stats = (bn.running_mean.clone(), bn.running_var.clone())
            with precision.numerics(mode):
                outs, _ = forward_train(model, frame, carry, new.cuda(), bn_train=bn_train, **kw)
                loss_m = zero_tig_loss(frame, outs)
                loss_m.backward()
            del outs
            g_m = _grads(model)
            moved_m = (bn.running_mean.clone(), bn.running_var.clone())
            bn.running_mean.copy_(stats[0])
            bn.running_var.copy_(stats[1])
            torch.cuda.synchronize()
            spans.reset_counts()
            loss_b, _ = spatial_loss_and_grads(state, frame, new, bands=4, halo=BAND_HALO, bn_train=bn_train, **kw)
            torch.cuda.synchronize()
            counts = dict(spans.COUNTS)
            g_b = _grads(model)
            want = launches(K1_PER_TRAIN_FRAME, GRU_PER_FRAME, EQ_PER_FRAME, f32=mode == "highest")
            if counts != want:
                fail(f"banded training launches {counts} != phase 7's per frame {want}")
            loss_err = abs(float(loss_b) / float(loss_m.detach()) - 1)
            l_tol, g_tol, rtol = limits[mode]
            worst, worst_leaf, cos_min = 0.0, "", 1.0
            for name, gm in g_m.items():
                gb = g_b[name]
                if name == "enhance.conv.0.bias" and bn_train:
                    continue  # exactly 0 under batch statistics: both sides hold cancellation noise
                scale = max(float(gm.abs().max()), 1e-3)
                err = float(((gb - gm).abs() - rtol * gm.abs()).max()) / scale
                if err > worst:
                    worst, worst_leaf = err, name
                cos_min = min(cos_min, float(torch.dot(gb.flatten(), gm.flatten()) / (gb.norm() * gm.norm() + 1e-30)))
            # running statistics: the CPU test's atol 2e-4 + rtol 5e-3 under
            # batch statistics; without them neither side may move them at all
            s_atol, s_rtol = (2e-4, 5e-3) if bn_train else (0.0, 0.0)
            stat_err = max(float((bn.running_mean - moved_m[0]).abs().max()),
                           float((bn.running_var - moved_m[1]).abs().max()))
            stat_ok = all(bool(((b - m).abs() <= s_atol + s_rtol * m.abs()).all())
                          for b, m in ((bn.running_mean, moved_m[0]), (bn.running_var, moved_m[1])))
            ok = loss_err <= l_tol and (worst <= g_tol if g_tol else cos_min >= 0.99) and stat_ok
            print(f"banded 4 x halo {BAND_HALO} against the whole 1080p frame, {mode} bn_train={bn_train}: loss "
                  f"{float(loss_b):.6f} / {float(loss_m.detach()):.6f} rel {loss_err:.2e} (tol {l_tol:g}); gradients: worst "
                  f"|banded - whole| beyond {rtol} of itself {worst:.2e} of the leaf's largest ({worst_leaf}; tol {g_tol}), "
                  f"min cosine "
                  f"{cos_min:.6f}; running statistics max_abs_err {stat_err:.2e} (tol atol {s_atol:g} + rtol "
                  f"{s_rtol:g}); launches {counts} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"banded and whole-frame training disagree ({mode}, bn_train={bn_train})")
            agree[f"{mode}_bn{int(bn_train)}"] = {"loss_rel_err": loss_err, "grad_excess": worst, "worst_leaf": worst_leaf,
                                                  "grad_min_cosine": cos_min, "running_stats_err": stat_err,
                                                  "launches": counts}
            del state, model, g_m, g_b
    # (2) ms/frame and peak memory for bands 1 (train_step), 2 and 4
    timing = {}
    for mode in ("highest", "fast"):
        for bn_train in (True, False):
            for bands in BAND_CASES:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                state = init_train_state(Config(precision=mode, **kw), sd, (1, H, W, 3), device="cuda")
                reinit_enhancer(state.model, torch.Generator(device="cuda").manual_seed(SEED))

                def step(st):
                    if bands == 1:
                        return train_step(st, frame, new, bn_train=bn_train, **kw)
                    return train_step_spatial(st, frame, new, bands=bands, halo=BAND_HALO, bn_train=bn_train, **kw)

                state, _ = step(state)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(2):
                    state, loss = step(state)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / 2
                peak = torch.cuda.max_memory_allocated() / 1e9
                if not math.isfinite(float(loss)):
                    fail(f"banded training loss is not finite ({mode}, {bands} bands)")
                timing[f"{mode}_bn{int(bn_train)}_bands{bands}"] = {"ms_per_frame": ms, "peak_mem_gb": peak}
                if mode == "highest" and not bn_train and bands < 4:
                    # where the whole frame's step and the 2-band one spend their device time
                    timing[f"{mode}_bn0_bands{bands}"]["trace"] = trace_path(
                        lambda: step(state), 1, f"training highest, {bands} band(s)", {MMA: 0, FMA: K1_PER_TRAIN_FRAME})
                del state
        print(f"training 1080p {mode}, ms/frame (peak device GB) by bands "
              + "; ".join(f"bn_train={bt}: " + ", ".join(
                  f"{b}: {timing[f'{mode}_bn{int(bt)}_bands{b}']['ms_per_frame']:.3f} "
                  f"({timing[f'{mode}_bn{int(bt)}_bands{b}']['peak_mem_gb']:.2f})" for b in BAND_CASES)
                  for bt in (True, False))
              + f" (1 = train_step; halo {BAND_HALO}) on {smi}", flush=True)
    report["banded"] = {"agreement": agree, "timing": timing}


MESH_TIMED_FRAMES = 8  # each rank's timed predict stream
MESH_TRAIN_STEPS = 2  # timed training steps of the 1x2 mesh, after a warm-up step


def _train_reference(sd, trained, carry, frames, new: bool, bn_train: bool):
    """The single-process training step's loss and gradients (train_step's,
    before its update) on ``frames`` (B, H, W, 3), highest mode: ``sd``
    with the trained tensors ``trained`` over it, from ``carry``."""
    state = init_train_state(Config(precision="highest", of_scale=OF_SCALE, raft_iters=ITERS), {**sd, **trained},
                             tuple(frames.shape), device="cuda")
    with precision.numerics("highest"):
        outs, _ = forward_train(state.model, frames, {k: v.cuda() for k, v in carry.items()},
                                torch.tensor(new, device="cuda"), bn_train=bn_train, of_scale=OF_SCALE,
                                raft_iters=ITERS)
        loss = zero_tig_loss(frames, outs)
        loss.backward()
    grads = {n: g.cpu() for n, g in _grads(state.model).items()}
    del state, outs
    return float(loss.detach()), grads


def _grad_excess(got: dict, ref: dict, bn_train: bool) -> dict[str, float]:
    """Phase 10's measure of two gradients, per leaf: the largest excess of
    |got - ref| over 1e-4 |ref|, relative to the leaf's largest; the shared
    block's conv bias, exactly 0 under batch statistics, is left out."""
    out = {}
    for name, gm in ref.items():
        if name == "enhance.conv.0.bias" and bn_train:
            continue
        scale = max(float(gm.abs().max()), 1e-3)
        out[name] = float(((got[name] - gm).abs() - 1e-4 * gm.abs()).max()) / scale
    return out


def _norm_rel(got: dict, ref: dict, leaves) -> float:
    """The worst of ``leaves``' |got - ref| / |ref|."""
    return max(float((got[n] - ref[n]).norm() / ref[n].norm()) for n in leaves)


def phase11_multidevice(sd, report, smi, main_ms: float) -> None:
    """Multi-device runs (zero_tig_torch/parallel) on the one card: two ranks
    spawned by parallel.launch share it over gloo; one NCCL rank alone."""
    from zero_tig_torch.parallel import launch, probe

    out: dict = {}
    kw = dict(of_scale=OF_SCALE, raft_iters=ITERS)
    train_sd = init_state_dict(SEED, for_training=True)  # the reference's Enhancer init, as training starts
    with tempfile.TemporaryDirectory(prefix="zt_mesh_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        fx = make_rlv_fixture(str(tmp / "rlv"), scenes=FIXTURE_SCENES, frames_per_scene=FIXTURE_FRAMES,
                              size=(W, H), occluder=True)
        recs = list(create_dataset("RLV", fx, "test", size=(W, H)))
        frames = torch.from_numpy(np.stack([r.image for r in recs])[:, None])  # (8, 1, H, W, 3) f32
        flags = [r.is_new_seq for r in recs]
        g = torch.Generator().manual_seed(SEED)
        t_frames = torch.rand(2, 2, 1, H, W, 3, generator=g) * 0.25  # (scene, step, 1, H, W, 3)
        t_carry = {"last_H3": torch.rand(2, 1, H, W, 3, generator=g) * 0.5,
                   "last_s3": torch.rand(2, 1, H, W, 3, generator=g) * 0.5 + 0.25}
        t_flags = [[False, False], [False, False]]  # both steps continue: the flow runs
        cfg_fast = Config(dataset="RLV", lowlight_images_path=fx, frame_width=W, frame_height=H, precision="fast",
                          spatial_halo=BAND_HALO, **kw)
        cfg_high = Config(precision="highest", **kw)
        calls = [
            (probe.predict_scenes, (2, 1), (cfg_fast, sd)),  # (a)
            (probe.time_predict, (2, 1), (sd, "fast", MESH_TIMED_FRAMES, (1, H, W, 3), kw)),
            (probe.predict_banded, (1, 2), (sd, "fast", frames, {k: torch.zeros(1, H, W, 3) for k in t_carry},
                                            flags, dict(halo=BAND_HALO, **kw))),  # (b)
            (probe.train_steps, (2, 1), (cfg_high, train_sd, t_frames, t_carry, t_flags, [True, False],
                                         BAND_HALO)),  # (c)
            (probe.train_steps, (1, 2), (cfg_high, train_sd, t_frames[:1], {k: v[:1] for k, v in t_carry.items()},
                                         t_flags[:1], [True, False], BAND_HALO)),
        ] + [(probe.time_train, (1, 2), (Config(precision=mode, **kw), train_sd, MESH_TRAIN_STEPS, (1, H, W, 3),
                                         bn_train, BAND_HALO))
             for mode in ("fast", "highest") for bn_train in (True, False)]
        print(f"mesh fixture {len(recs)} frames of {W}x{H} and the training inputs in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.run(probe.sequence, (calls,), n_data=2, device="cuda")
        out["spawned_ranks_s"] = time.perf_counter() - t0
        (pa0, ta0, pb0, c20, c120, *tt0), (pa1, ta1, pb1, c21, c121, *tt1) = ranks
        backends = {r["backend"] for rank in ranks for r in rank}
        print(f"two ranks on one card: {len(calls)} programs in {out['spawned_ranks_s']:.1f} s with start-up, "
              f"backend {backends}", flush=True)
        if backends != {"gloo"}:
            fail(f"two ranks sharing a card ran {backends}, not gloo")

        # (a) scene-parallel inference against the single-process predict_step loop
        fast = build_model(sd, device="cuda", precision="fast")
        ref, carry = {}, init_carry(fast, (1, H, W, 3))
        for r, f in zip(recs, frames):
            (H2, H3, s3), carry = predict_step(fast, f.cuda(), carry, r.is_new_seq, **kw)
            ref[r.path] = (H2[0].cpu(), H3[0].cpu(), s3[0].cpu())
        got = {**pa0["outputs"], **pa1["outputs"]}
        if sorted(got) != sorted(ref) or [pa0["count"], pa1["count"]] != [FIXTURE_FRAMES, FIXTURE_FRAMES]:
            fail(f"scene-parallel inference emitted {[pa0['count'], pa1['count']]} frames")
        same = all(torch.equal(to_u8(a), to_u8(b)) for p in ref for a, b in zip(got[p][:2], ref[p][:2]))
        err_a = max(float((a - b).abs().max()) for p in ref for a, b in zip(got[p], ref[p]))
        want = launches(K1_PER_FRAME * FIXTURE_FRAMES, GRU_PER_FRAME * FIXTURE_FRAMES, EQ_PER_FRAME * FIXTURE_FRAMES)
        print(f"(a) mesh 2x1 predict_scenes_spmd, fast, {len(recs)} frames: PNG bytes (u8 H2, H3) equal to the "
              f"single-process predict_step loop: {same}; f32 max_abs_err {err_a:.3e}; launches per rank "
              f"{[pa0['launches'], pa1['launches']]} (each {want}: phase 3's a frame)", flush=True)
        if not same:
            fail("scene-parallel inference differs from the single-process loop")
        if pa0["launches"] != want or pa1["launches"] != want:
            fail("scene-parallel inference launch counts differ from phase 3's per frame")
        agg_fps = 2 * 1e3 / max(ta0["ms_per_frame"], ta1["ms_per_frame"])

        # (b) row-sharded inference, the same frames
        err_b = max(float((a - b).abs().max()) for (o, r) in zip(pb0["outputs"], recs)
                    for a, b in zip(o, (x[None] for x in ref[r.path])))
        lv_b = max(int((to_u8(a).int() - to_u8(b).int()).abs().max()) for (o, r) in zip(pb0["outputs"], recs)
                   for a, b in zip(o[:2], (x[None] for x in ref[r.path][:2])))
        same_ranks = all(torch.equal(v, pb1["carry"][k]) for k, v in pb0["carry"].items())
        want_b = {k: v * len(recs) // FIXTURE_FRAMES for k, v in want.items()}
        print(f"(b) mesh 1x2 predict_step_banded (halo {BAND_HALO}), fast, {len(recs)} frames: against the whole "
              f"frame f32 max_abs_err {err_b:.3e}, PNG levels {lv_b} (limit: bf16 rounding, 1/64 and 4 levels); "
              f"both ranks hold the same carry: {same_ranks}; launches per rank {[pb0['launches'], pb1['launches']]} "
              f"(each {want_b})", flush=True)
        if err_b > 1 / 64 or lv_b > 4 or not same_ranks:
            fail("row-sharded inference differs from the whole frame beyond its limit")
        if pb0["launches"] != want_b or pb1["launches"] != want_b:
            fail("row-sharded inference launch counts differ from phase 3's per frame")
        del fast, got, ref

        # (c) training, highest, 2 steps (batch, then running statistics): each
        # step held against the single-process step from the mesh's own state
        # before it, within phase 10's limits. Under batch statistics the
        # Enhancer's in_conv gradient is the small difference of large terms:
        # the single-process step itself moves by ~2e-4 of it when only its
        # batch's layout changes (the same frames twice over: equal in exact
        # arithmetic; cuDNN and cuBLAS take other algorithms at another batch
        # size). That noise is measured per leaf and added to the limit.
        agree = {}
        want_t = launches(K1_PER_TRAIN_FRAME * 2, GRU_PER_FRAME * 2, EQ_PER_FRAME * 2, f32=True)
        for label, r0, r1 in (("2x1", c20, c21), ("1x2", c120, c121)):
            scenes = 2 if label == "2x1" else 1
            if not (r0["replicated"] and r1["replicated"]) or any(
                    not torch.equal(v, r1["steps"][-1]["trained"][k]) for k, v in r0["steps"][-1]["trained"].items()):
                fail(f"mesh {label} training: the ranks' parameters differ")
            if r0["launches"] != want_t or r1["launches"] != want_t:
                fail(f"mesh {label} training launches {[r0['launches'], r1['launches']]} != {want_t}")
            before, carries = {}, {k: v[:scenes].clone() for k, v in t_carry.items()}
            for k, bn_train in enumerate((True, False)):
                step = r0["steps"][k]
                batch = t_frames[:scenes, k, 0].cuda()
                carry_k = {n: v[:, 0] for n, v in carries.items()}
                loss_m, g_m = _train_reference(train_sd, before, carry_k, batch, False, bn_train)
                _, g_twice = _train_reference(train_sd, before, {n: v.repeat(2, 1, 1, 1) for n, v in carry_k.items()},
                                              batch.repeat(2, 1, 1, 1), False, bn_train)
                noise = _grad_excess(g_twice, g_m, bn_train)
                over = {n: e - max(noise[n], 0.0) for n, e in _grad_excess(step["grads"], g_m, bn_train).items()}
                leaf = max(over, key=over.get)
                loss_err = abs(float(step["loss"]) / loss_m - 1)
                rel = _norm_rel(step["grads"], g_m, over)
                ok = loss_err <= 3e-6 and over[leaf] <= 1e-4
                print(f"(c) mesh {label} training step {k + 1}, highest, bn_train={bn_train}: loss "
                      f"{float(step['loss']):.6f} against {loss_m:.6f} rel {loss_err:.2e} (tol 3e-6); gradients: worst "
                      f"excess beyond the single process's own layout noise {over[leaf]:.2e} ({leaf}; tol 1e-4; that "
                      f"leaf's noise {noise[leaf]:.2e}, worst noise {max(noise.values()):.2e}), worst norm rel "
                      f"{rel:.2e}; {'ok' if ok else 'FAIL'}", flush=True)
                agree[f"{label}_step{k + 1}"] = {"loss_rel_err": loss_err, "grad_excess": over[leaf], "worst_leaf": leaf,
                                                 "leaf_noise": noise[leaf], "grad_norm_rel": rel}
                if not ok:
                    fail(f"mesh {label} training step {k + 1} disagrees with the single-process step")
                before = step["trained"]
                carries = {n: torch.stack([rk["steps"][k]["carry"][n] for rk in ((r0, r1) if scenes == 2 else (r0,))])
                           for n in carries}
            print(f"(c) mesh {label}: the ranks' parameters bit-equal after 2 steps; launches per rank "
                  f"{r0['launches']} ({want_t}: phase 7's a frame)", flush=True)
        del c20, c21, c120, c121

        # (d) one NCCL training step at world size 1, through make_mesh, in this process
        torch.cuda.empty_cache()
        nccl = launch.run(probe.sequence, ([
            (probe.train_steps, (1, 1), (cfg_high, train_sd, t_frames[:1, :1], {k: v[:1] for k, v in t_carry.items()},
                                         [[False]], [True], BAND_HALO)),
            (probe.time_predict, (1, 1), (sd, "fast", MESH_TIMED_FRAMES, (1, H, W, 3), kw)),
        ],), device="cuda")[0]
        nstep = nccl[0]["steps"][0]
        loss_m, g_m = _train_reference(train_sd, {}, {k: v[:1, 0] for k, v in t_carry.items()},
                                       t_frames[:1, 0, 0].cuda(), False, True)
        excess = _grad_excess(nstep["grads"], g_m, True)
        leaf = max(excess, key=excess.get)
        worst = excess[leaf]
        loss_err = abs(float(nstep["loss"]) / loss_m - 1)
        print(f"(d) NCCL at world size 1 (backend {nccl[0]['backend']}): training step loss rel {loss_err:.2e}, "
              f"gradient excess {worst:.2e} ({leaf}) against train_step", flush=True)
        if nccl[0]["backend"] != "nccl" or loss_err > 3e-6 or worst > 1e-4:
            fail("the NCCL step at world size 1 failed its checks")
        single = nccl[1]

        # (e) predict --mesh_data 2 against the single-process CLI, byte for byte
        pt = tmp / "seeded.pt"
        save_pt(pt, build_model(sd, device="cpu", precision="highest"))
        common = CLI_FLAGS + ["--lowlight_images_path", fx, "--model_pretrain", str(pt), "--precision", "fast"]
        one_s, _ = run_cli("predict single process", cli_predict.main, common + ["--save", str(tmp / "p1"),
                                                                                  "--chunk", "4"])
        mesh_s, _ = run_cli("predict --mesh_data 2", cli_predict.main, common + ["--save", str(tmp / "p2"),
                                                                                  "--mesh_data", "2"])
        p1 = {str(q.relative_to(tmp / "p1")): native.read_rgb(q) for q in (tmp / "p1").rglob("*.png")}
        p2 = {str(q.relative_to(tmp / "p2")): native.read_rgb(q) for q in (tmp / "p2").rglob("*.png")}
        equal = p1.keys() == p2.keys() and len(p1) == 2 * len(recs) and all(np.array_equal(p1[k], p2[k]) for k in p1)
        cli_backend = re.search(r"backend (\w+)", (tmp / "p2" / "log.txt").read_text())
        print(f"(e) predict --mesh_data 2: {len(p2)} PNGs byte-equal to the single-process CLI's (--chunk 4): "
              f"{equal}; wall {mesh_s:.1f} s with the ranks' start-up, single process {one_s:.1f} s", flush=True)
        if not equal:
            fail("predict --mesh_data 2 PNGs differ from the single-process CLI's")

    # (f) the backends, and the numbers
    cli_backend = cli_backend.group(1) if cli_backend else None
    print(f"(f) backends: two ranks on one card {sorted(backends)}, one rank alone {nccl[0]['backend']}, predict "
          f"--mesh_data 2 {cli_backend}", flush=True)
    if cli_backend != "gloo":
        fail(f"predict --mesh_data 2 ran backend {cli_backend}")
    print(f"mesh 2x1 inference, fast, 1080p, predict_step per frame on frames on the card, two ranks sharing the "
          f"card: {ta0['ms_per_frame']:.3f} / {ta1['ms_per_frame']:.3f} ms/frame per rank, {agg_fps:.2f} frames/s "
          f"together; one rank alone {single['ms_per_frame']:.3f} ms/frame ({1e3 / single['ms_per_frame']:.2f} "
          f"frames/s); phase 3's predict_chunk {main_ms:.3f} ms/frame; peak device memory per rank "
          f"{ta0['peak_mem_gb']:.3f} / {ta1['peak_mem_gb']:.3f} GB on {smi}", flush=True)
    timing = {}
    for i, (mode, bn_train) in enumerate((m, b) for m in ("fast", "highest") for b in (True, False)):
        timing[f"{mode}_bn{int(bn_train)}"] = {"ms_per_step": [tt0[i]["ms_per_step"], tt1[i]["ms_per_step"]],
                                               "peak_mem_gb": [tt0[i]["peak_mem_gb"], tt1[i]["peak_mem_gb"]]}
    print(f"mesh 1x2 training 1080p (halo {BAND_HALO}), ms/step per rank (peak device GB per rank): " + "; ".join(
        f"{k}: {v['ms_per_step'][0]:.3f} / {v['ms_per_step'][1]:.3f} ({v['peak_mem_gb'][0]:.2f} / "
        f"{v['peak_mem_gb'][1]:.2f})" for k, v in timing.items()) + f" on {smi}", flush=True)
    out.update({"predict_2x1": {"ms_per_frame": [ta0["ms_per_frame"], ta1["ms_per_frame"]], "frames_per_s": agg_fps,
                                "peak_mem_gb": [ta0["peak_mem_gb"], ta1["peak_mem_gb"]],
                                "launches": [pa0["launches"], pa1["launches"]], "max_abs_err": err_a},
                "predict_1rank_nccl": single, "predict_1x2": {"max_abs_err": err_b, "png_levels": lv_b},
                "training": agree, "train_1x2_timing": timing, "predict_cli_equal": equal,
                "backends": {"shared_card": sorted(backends), "alone": nccl[0]["backend"], "cli": cli_backend}})
    report["multidevice"] = out


# ---------------------------------------------------------------------------
# phase 12: the flow sidecar at its operating points

# RAFT's update-core grid at each of the sidecar's operating points: the
# frame padded to /8, over 8
FLOW_GRIDS = {"500x1000": SIDECAR, "Sintel 436x1024": (55, 128), "KITTI 375x1242": (47, 156)}
FLOW_MODELS = ("lk_pyramid", "pwc_lite", "raft", "raft_small")
K1_PER_PAIR = sum(layer[-1] for layer in RAFT_K1_LAYERS)  # 12 x 9 in the update core + 2 in the mask head
GRU_PER_PAIR = 4 * ITERS
SINTEL, KITTI = (436, 1024), (375, 1242)


def known_flow(h: int, w: int) -> np.ndarray:
    """The fixture's smooth flow, (h, w, 2) px: 1.5 +- 0.5 across, -0.75 +- 0.5 down."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.stack([1.5 + 0.5 * np.sin(2 * np.pi * y / h), -0.75 + 0.5 * np.cos(2 * np.pi * x / w)], -1)


def textured_frame(h: int, w: int, phases: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """A smooth RGB texture at p - shift(p), uint8: frame k of the fixture is
    the texture moved by k times the known flow, so frame k+1 at x + f(x)
    shows frame k at x to within f . grad f (< 0.06 px here)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    xx, yy = x - shift[..., 0], y - shift[..., 1]
    chans = [127 + 50 * np.sin(xx / 5.3 + p[0]) * np.cos(yy / 7.1 + p[1]) + 40 * np.sin((xx + 2 * yy) / 11.7 + p[2])
             + 20 * np.sin((3 * xx - yy) / 23.0) for p in phases]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def write_flow_fixture(root: Path) -> dict:
    """Sintel layout (clean/alley/frame_0001-0004.png, flow/alley/frame_0001-0003.flo
    at 436x1024) and KITTI layout (image_2/000000_10.png, _11.png at
    375x1242), from SEED."""
    phases = np.random.default_rng(SEED).uniform(0, 2 * np.pi, (3, 3))
    paths = {"clean": root / "sintel" / "clean" / "alley", "flow": root / "sintel" / "flow" / "alley",
             "kitti": root / "kitti" / "image_2"}
    for p in paths.values():
        p.mkdir(parents=True)
    f = known_flow(*SINTEL)
    for k in range(4):
        native.write_png(paths["clean"] / f"frame_{k + 1:04d}.png", textured_frame(*SINTEL, phases, k * f))
        if k < 3:
            write_flo(str(paths["flow"] / f"frame_{k + 1:04d}.flo"), f.astype(np.float32))
    fk = known_flow(*KITTI)
    for k, name in enumerate(("000000_10.png", "000000_11.png")):
        native.write_png(paths["kitti"] / name, textured_frame(*KITTI, phases, k * fk))
    return paths


def read_frame(path, device: str) -> torch.Tensor:
    return torch.from_numpy(native.read_rgb(path).astype(np.float32)[None]).to(device)


def phase12_k1_grids(gen, out) -> dict:
    """K1 against its twin and timed at RAFT's update-core grid of each
    operating point (bf16 and f32 operands; tolerances as phase 2), and the
    GRU kernel timed there: ms per pair beside the bound, the twin and the
    library, as phase 5 at 45x80."""
    fm = get_flow_model("raft")
    models = {"bf16": fm.init_fn(SEED, device="cuda"), "f32": fm.init_fn(SEED, device="cuda")}
    models["bf16"].prepare(torch.bfloat16)
    models["f32"].prepare(torch.float32)
    grids = {}
    for label, grid in FLOW_GRIDS.items():
        row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
        bounds = []
        for base in RAFT_K1_LAYERS:
            layer = base[:3] + (grid,) + base[4:]
            name = layer[0]
            for mode, model in models.items():
                cw = model.update_block.kw[layer[1][1]]
                xs, kwargs = k1_inputs(layer, cw.w.dtype, gen)
                with precision.numerics("highest"):
                    got = fused_conv(xs, cw, **kwargs).float()
                    ref = fused_conv_reference(xs, cw, **kwargs).float()
                    torch.cuda.synchronize()
                atol, rtol = (1e-2, 1e-2) if mode == "bf16" else (1e-4, 1e-4)
                err = float((got - ref).abs().max())
                bad = float(((got - ref).abs() - (atol + rtol * ref.abs())).max())
                if not (bool(torch.isfinite(got).all()) and bad <= 0):
                    fail(f"K1 {name} {mode} at {grid} disagrees with its twin: max_abs_err {err}")
                if mode == "bf16":
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    ms = graph_ms(lambda: fused_conv(xs, cw, **kwargs))
                    plain = graph_ms(lambda: fused_conv_reference(xs, cw, **kwargs))
                    x_cl = torch.cat(xs, -1).permute(0, 3, 1, 2)
                    w_cl = cw.w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    pad = ((cw.w.shape[0] - 1) // 2, (cw.w.shape[1] - 1) // 2)
                    lib = graph_ms(lambda: F.conv2d(x_cl, w_cl, cw.shift.to(cw.w.dtype), padding=pad))
                    bound, _, by = k1_bound_ms(layer, cw)
                    n = layer[-1]
                    row["ms"] += ms * n
                    row["plain_ms"] += plain * n
                    row["library_ms"] += lib * n
                    row["bound_ms"] += bound * n
                    bounds.append((bound * n, by))
        row["bound_by"] = max(bounds)[1]
        # the GRU kernel: the four launches of one iteration at this grid
        dt = torch.bfloat16
        hr, wr = grid
        zr = torch.rand(1, hr, wr, 256, generator=gen, device="cuda")
        q = torch.rand(1, hr, wr, 128, generator=gen, device="cuda") * 2 - 1
        net = (torch.rand(1, hr, wr, 128, generator=gen, device="cuda") * 2 - 1).to(dt)
        net_f = net.float()
        for a, b in zip(gru.gru_update(zr, q, net, (torch.float32, dt)),
                        gru.gru_update_reference(zr, q, net, (torch.float32, dt))):
            tol = 2.0**-7 if a.dtype == dt else 1e-6
            if not float((a.float() - b.float()).abs().max()) <= tol:
                fail(f"GRU kernel at {grid} disagrees with its twin")

        def four(reset, update):
            def run():
                reset(zr, net, dt)
                update(zr, q, net, (torch.float32, dt))
                reset(zr, net_f, dt)
                update(zr, q, net_f, (dt,))
            return run

        n = hr * wr * 128
        gru_bytes = n * (4 + 2 + 2) + n * (4 + 4 + 2 + 4 + 2) + n * (4 + 4 + 2) + n * (4 + 4 + 4 + 2)
        row["gru_ms"] = graph_ms(four(gru.gru_reset, gru.gru_update)) * ITERS
        row["gru_plain_ms"] = graph_ms(four(gru.gru_reset_reference, gru.gru_update_reference)) * ITERS
        row["gru_bound_ms"] = gru_bytes / PEAK_BYTES * 1e3 * ITERS
        grids[label] = row
        print(f"phase 12 K1 at RAFT grid {grid} ({label}), {K1_PER_PAIR} launches a pair: ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}), bf16 max_abs_err={row['max_abs_err']:.3e} (f32 too, tol as phase 2); "
              f"GRU {GRU_PER_PAIR} launches: ms={row['gru_ms']:.4f} plain_ms={row['gru_plain_ms']:.4f} "
              f"bound_ms={row['gru_bound_ms']:.5f} (bytes); CUDA-graph device time", flush=True)
    out["k1_gru_grids"] = grids
    return grids


def phase12_flow_sidecar(report, smi, gen) -> dict:
    """The flow sidecar: (a) benchmark_model of each model at 500x1000 in
    both precisions and the benchmark CLI; (b) each model on the card
    against its plain version on the CPU on one 436x1024 pair, and RAFT's
    launches a pair counted through infer_pair; (c) validate_folder and the
    Sintel and KITTI submissions; (d) flow training at RAFT's FlyingChairs
    stage; (e) the demo CLI and the benchmark CLI, run beside (b) and (c).
    Returns the counted path's launches."""
    out: dict = {"device": smi}
    grids = phase12_k1_grids(gen, out)
    tmp = Path(tempfile.mkdtemp(prefix="zt_flow_"))
    try:
        paths = write_flow_fixture(tmp)
        frames = sorted(paths["clean"].glob("*.png"))
        gts = sorted(paths["flow"].glob("*.flo"))
        # (a) benchmark at the reference's operating point
        rows = []
        for name in FLOW_MODELS:
            for mode in ("fast", "highest"):
                r = benchmark_model(name, precision=mode, seed=SEED, device="cuda")
                ok = math.isfinite(r["time_ms_median"]) and r["time_ms_median"] > 0 and (
                    name == "lk_pyramid" or (r["flops"] > 0 and r["params"] > 0))
                print(f"phase 12 benchmark {name:10s} {mode:7s} 500x1000 iters={r['iters']}: "
                      f"time_ms_median={r['time_ms_median']:.3f} mean={r['time_ms_mean']:.3f} params={r['params']} "
                      f"flops={r['flops']:.4g} peak_bytes={r['peak_bytes']} on {smi}", flush=True)
                if not ok:
                    fail(f"benchmark of {name} ({mode}) gave {r}")
                rows.append(r)
        out["benchmark"] = rows

        # the CLIs run beside this process through (b) and (c), which time
        # nothing: the benchmark CLI on one model, the demo on the fixture's
        # 4 frames at its defaults (640x360, 15 iterations, a seeded RAFT)
        demo_dir, csv_path = tmp / "demo", tmp / "bench.csv"
        clis = [subprocess.Popen([sys.executable, "-m", mod, *argv], cwd=REPO, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for mod, argv in (("zero_tig_torch.cli.demo", ["--path", str(paths["clean"]), "--save", str(demo_dir)]),
                                  ("zero_tig_torch.flowtools.benchmark",
                                   ["--models", "pwc_lite", "--num_samples", "2", "--output_csv", str(csv_path)]))]

        # (b) one Sintel pair: the counted path (infer_pair, RAFT), then each
        # model on the card against its plain version on the CPU, highest
        i1, i2 = read_frame(frames[0], "cuda"), read_frame(frames[1], "cuda")
        raft = get_flow_model("raft").init_fn(SEED, device="cuda")
        infer_pair("raft", raft, str(frames[0]), str(frames[1]), device="cuda")  # warm-up
        torch.cuda.synchronize()
        spans.reset_counts()
        pair = infer_pair("raft", raft, str(frames[0]), str(frames[1]), gt_flow_path=str(gts[0]), device="cuda")
        torch.cuda.synchronize()
        side = dict(spans.COUNTS)
        want = launches(K1_PER_PAIR, GRU_PER_PAIR, f32=True)
        print(f"phase 12 counted path: infer_pair('raft') on one 436x1024 pair launches {side} "
              f"(expected {want}); its EPE against the fixture's flow {pair['epe']:.3f} (random weights)", flush=True)
        if side != want:
            fail("the sidecar's RAFT pair launched other counts than 12 x (9 + 4) + 2")
        out["launches_per_pair"] = side
        cmp = {}
        for name in FLOW_MODELS:
            fm = get_flow_model(name)
            card = raft if name == "raft" else fm.init_fn(SEED, device="cuda")
            cpu = fm.init_fn(SEED, device="cpu")
            got = fm.forward_fn(card, i1, i2, fm.default_iters, "highest")[1].cpu()
            ref = fm.forward_fn(cpu, i1.cpu(), i2.cpu(), fm.default_iters, "highest")[1]
            d = (got - ref).abs()
            err, scale = float(d.max()), float(ref.abs().max())
            if name == "lk_pyramid":
                # the Shi-Tomasi gate flips on a rounding at a pixel whose
                # eigenvalue sits at its threshold, and that pixel takes or
                # skips a whole step (up to 2 px), which the next levels
                # spread (tests/test_torch_flow_models.py): count those pixels
                off = float((d.amax(-1) > 1e-3).float().mean())
                ok, tol = off <= 0.01, f"<= 1% of pixels beyond 1e-3 px (here {off:.4%})"
            else:
                # f32 on both sides (TF32 off), sums in another order through the iterations
                ok, tol = err <= 1e-3 * scale + 1e-4, "1e-3 * max|flow| + 1e-4"
            ok = ok and bool(torch.isfinite(got).all()) and got.shape == ref.shape
            print(f"phase 12 card vs CPU {name:10s} 436x1024 highest iters={fm.default_iters}: max_abs_err={err:.3e} "
                  f"max|flow|={scale:.3g} tol {tol} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name} on the card disagrees with its plain version on the CPU")
            cmp[name] = {"max_abs_err": err, "max_flow": scale}
        out["card_vs_cpu"] = cmp

        # (c) validation and submissions
        val = {}
        for name in ("raft", "pwc_lite", "lk_pyramid"):
            fm = get_flow_model(name)
            card = raft if name == "raft" else fm.init_fn(SEED, device="cuda")
            val[name] = validate_folder(name, card, str(paths["clean"]), str(paths["flow"]), device="cuda",
                                        csv_path=str(tmp / f"{name}.csv"))
        val["pwc_lite_cpu"] = validate_folder("pwc_lite", get_flow_model("pwc_lite").init_fn(SEED, device="cpu"),
                                              str(paths["clean"]), str(paths["flow"]), device="cpu")
        for name, agg in val.items():
            print(f"phase 12 validate_folder {name:12s} Sintel fixture: {agg}", flush=True)
            if agg.get("num_pairs") != 3 or not all(math.isfinite(agg[k]) for k in ("epe", "fl_all", "px1", "wauc")):
                fail(f"validate_folder({name}) gave {agg}")
        a, b = val["pwc_lite"], val["pwc_lite_cpu"]
        # f32 both sides: the means to 1e-3 of themselves; a threshold count
        # may move by a pixel or two of 446k a pair at its threshold
        if not (abs(a["epe"] - b["epe"]) <= 1e-3 * b["epe"] and abs(a["wauc"] - b["wauc"]) <= 1e-3 * b["wauc"]
                and abs(a["fl_all"] - b["fl_all"]) <= 0.01 and abs(a["px1"] - b["px1"]) <= 1e-4):
            fail("validate_folder(pwc_lite) on the card and the CPU disagree")
        if not val["lk_pyramid"]["epe"] < 0.5:  # the known flow, |f| ~1.7 px: the limit set before the first run
            fail(f"lk_pyramid misses the fixture's known flow: EPE {val['lk_pyramid']['epe']}")
        out["validate"] = val

        n_s = write_sintel_submission("raft", raft, str(tmp / "sintel" / "clean"), str(tmp / "sub_sintel"), device="cuda")
        n_k = write_kitti_submission("raft", raft, str(paths["kitti"]), str(tmp / "sub_kitti"), device="cuda")
        fm = get_flow_model("raft")
        mem = fm.forward_fn(raft, i1, i2, 12, "highest")[1][0].cpu().numpy()
        flo = read_flo(str(tmp / "sub_sintel" / "alley" / "frame_0001.flo"))
        k1_, k2_ = (read_frame(paths["kitti"] / n, "cuda") for n in ("000000_10.png", "000000_11.png"))
        mem_k = fm.forward_fn(raft, k1_, k2_, 12, "highest")[1][0].cpu().numpy()
        kitti, valid = read_flow_kitti(str(tmp / "sub_kitti" / "000000_10.png"))
        kerr = float(np.abs(kitti - mem_k).max())
        print(f"phase 12 submissions: {n_s} Sintel .flo (frame_0001 equal to the flow in memory: "
              f"{np.array_equal(flo, mem)}), {n_k} KITTI PNG {kitti.shape} (max |file - memory| {kerr:.4f} px, "
              f"limit 1/64 px)", flush=True)
        if n_s != 3 or n_k != 1 or not np.array_equal(flo, mem) or not kerr < 1 / 64 or not np.all(valid == 1):
            fail("a submission file does not read back as the flow in memory")

        # (e) the CLIs started after (a): done before (d) times anything
        for proc, label in zip(clis, ("demo", "benchmark")):
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                print(log[-3000:], flush=True)
                fail(f"python -m zero_tig_torch ... {label} exited {proc.returncode}")
        with open(csv_path) as f:
            csv_rows = f.read().splitlines()
        if len(csv_rows) != 2 or "pwc_lite" not in csv_rows[1]:
            fail(f"the benchmark CLI's CSV holds {csv_rows}")
        names = sorted(p.name for p in demo_dir.iterdir())
        want_names = sorted(f"frame_{k:04d}_{kind}.png" for k in (2, 3, 4) for kind in ("flow", "overlap"))
        if names != want_names:
            fail(f"the demo wrote {names}, not {want_names}")
        seeded = get_flow_model("raft").init_fn(0, device="cuda")
        for k in range(3):
            a_, b_ = (torch.from_numpy(resize_u8(native.read_rgb(frames[j]), (360, 640)).astype(np.float32)[None]).cuda()
                      for j in (k, k + 1))
            want_img = flow_to_image(get_flow_model("raft").forward_fn(seeded, a_, b_, 15, "highest")[1][0].cpu().numpy())
            got_img = native.read_rgb(demo_dir / f"frame_{k + 2:04d}_flow.png")
            if not np.array_equal(got_img, want_img):
                fail(f"the demo's flow PNG of pair {k} differs from flow_to_image of the registry's RAFT")
        print(f"phase 12 CLIs: the benchmark CLI wrote its CSV ({csv_rows[1][:60]}...); the demo wrote "
              f"{len(names)} PNGs at 640x360, each _flow.png equal to flow_to_image of the registry's RAFT", flush=True)
        # (d) flow training at RAFT's FlyingChairs stage: 368x496 crops through
        # FlowAugmentor, batch 4, 12 iterations, gamma 0.8, lr 4e-4, wd 1e-4,
        # clip 1, the one-cycle schedule over 1000 steps
        f_np = read_flo(str(gts[0]))
        aug = FlowAugmentor(crop_size=(368, 496), seed=SEED)
        crops = [aug(native.read_rgb(frames[0]), native.read_rgb(frames[1]), f_np) for _ in range(4)]
        batch = [torch.from_numpy(np.stack([c[j] for c in crops]).astype(np.float32)).cuda() for j in range(3)]
        train = {}
        for name, mode, steps in (("raft", "fast", 4), ("raft", "highest", 4), ("raft_small", "fast", 2),
                                  ("pwc_lite", "fast", 2)):
            fm = get_flow_model(name)
            state = init_flow_train_state(fm.init_fn(SEED, device="cuda"), lr=4e-4, total_steps=1000)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, loss = flow_train_step(state, *batch, iters=fm.default_iters, gamma=0.8, lr=4e-4,
                                              total_steps=1000, predictions_fn=fm.predictions_fn, precision=mode)
                losses.append(float(loss))  # a sync
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 1e9
            ms = statistics.median(times[1:])
            print(f"phase 12 flow training {name:10s} {mode:7s} batch 4 368x496 iters={fm.default_iters}: "
                  f"losses {[round(v, 4) for v in losses]}, {ms:.1f} ms/step (median of {len(times) - 1} after "
                  f"a warm-up), peak {peak:.2f} GB on {smi}", flush=True)
            # the schedule's first steps (lr 1.6e-5 rising 7.7e-6 a step): in f32
            # RAFT's loss must fall on one fixed batch; a bf16 weight does not
            # see every such step
            if not all(math.isfinite(v) for v in losses) or (
                    (name, mode) == ("raft", "highest") and not losses[-1] < losses[0]):
                fail(f"flow training of {name} ({mode}): losses {losses}")
            train[f"{name}_{mode}"] = {"losses": losses, "ms_per_step": ms, "step_ms": times, "peak_gb": peak}
        # the first step at 96x128, 4 iterations, highest: card against CPU
        small = [t[:, :96, :128].contiguous() for t in batch]
        res = {}
        for dev in ("cuda", "cpu"):
            state = init_flow_train_state(get_flow_model("raft").init_fn(SEED, device=dev), lr=4e-4, total_steps=100)
            before = [p.detach().clone() for p in state.model.parameters()]
            state, loss = flow_train_step(state, *(t.to(dev) for t in small), iters=4, total_steps=100)
            delta = torch.cat([(p.detach() - b).flatten() for p, b in zip(state.model.parameters(), before)])
            res[dev] = (float(loss), delta.cpu())
        (lc, dc), (lh, dh) = res["cuda"], res["cpu"]
        loss_err = abs(lc - lh) / abs(lh)
        cos = float(torch.dot(dc, dh) / (dc.norm() * dh.norm()))
        # AdamW normalises the step: a gradient at rounding level moves its
        # weight by +-lr whichever sign it rounds to, so the update is held
        # by its cosine, as phase 4 holds Zero-TIG's
        ok = math.isfinite(lc) and loss_err <= 1e-4 and cos >= 0.999
        print(f"phase 12 flow training step 96x128 iters=4 highest card vs CPU: loss rel err={loss_err:.3e} "
              f"(tol 1e-4), update cosine={cos:.6f} (tol >= 0.999) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("the flow training step on the card disagrees with the CPU")
        train["card_vs_cpu"] = {"loss_rel_err": loss_err, "update_cosine": cos}
        out["training"] = train

    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["flow_sidecar"] = out
    return side


def frameio_build_line() -> str:
    """One line of information, not a phase: whether the native frame
    pipeline (host C++, libpng and libjpeg) builds where the script runs."""
    t0 = time.perf_counter()
    try:
        frameio.library()
        line = f"native frame pipeline (frameio.cc) built and loaded in {time.perf_counter() - t0:.2f} s"
    except (RuntimeError, OSError) as e:  # the compiler's message, or the loader's (a missing libpng)
        first = next((ln for ln in str(e).splitlines()[1:] if "error" in ln), str(e).splitlines()[0])
        line = f"native frame pipeline (frameio.cc) does not build or load here: {first.strip()}"
    print(line, flush=True)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description="Build the port's kernels and drive its main path on one card.")
    ap.add_argument("--out", type=Path, default=None, help="directory for chip_smoke.json (details)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"kernels built and loaded in {build_s:.1f} s", flush=True)
    frameio_line = frameio_build_line()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sd = init_random_state_dict(SEED)
    fast = build_model(sd, device="cuda", precision="fast")
    highest = build_model(sd, device="cuda", precision="highest")
    report: dict = {"device": smi, "build_s": build_s, "frameio": frameio_line}

    with precision.numerics("highest"):  # f32 twins hold f32 sums, not TF32
        errs = phase2_kernels(fast, highest, gen, report)
    # the main path and the timings run with PyTorch's default switches, as
    # a user's fast-mode model does
    counts, counts32 = phase3_main_path(fast, highest, gen, report, smi)
    phase4_card_vs_cpu(sd, gen, report)
    times = phase5_timings(fast, highest, gen, report)
    counts["conv3x3_bf16"] = phase6_conv3x3_path(gen, report)
    del fast, highest
    phase7_training(sd, report, smi)
    phase8_cli(sd, report, smi, report["main_path"]["ms_per_frame"])
    sidecar: dict = {}
    for label, phase in (("9", lambda: phase9_serve(sd, report, smi, report["main_path"]["ms_per_frame"])),
                         ("10", lambda: phase10_banded(sd, report, smi)),
                         ("11", lambda: phase11_multidevice(sd, report, smi, report["main_path"]["ms_per_frame"])),
                         ("12", lambda: sidecar.update(phase12_flow_sidecar(report, smi, gen)))):
        t0 = time.perf_counter()
        phase()
        report[f"phase{label}_s"] = time.perf_counter() - t0
        print(f"phase {label} took {report[f'phase{label}_s']:.1f} s", flush=True)

    # launches: the main path's (phases 3 and 6: fast mode, and for the f32
    # kernel the same chunk in highest mode) and the flow sidecar's counted
    # pair (phase 12, highest); beside them each mode's training frames
    # (phase 7)
    main = {name: counts32[name] if name == "fused_conv_f32" else counts[name] for name in KERNELS}
    train = {mode: report["training"][mode]["launches"] for mode in ("fast", "highest")}
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": main[name] + sidecar[name], "max_abs_err": errs[name], **times[name],
         "launches_by_path": {"main" if name != "fused_conv_f32" else "main_highest": main[name],
                              "flow_sidecar_pair": sidecar[name],
                              "training_fast": train["fast"][name], "training_highest": train["highest"][name]}}
        for name in KERNELS
    ]
    report["kernels"] = kernels
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
