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
     every tap shape and epilogue, on each tile shape; K2 on one update
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
  4. runs the whole path at 96x128 (3 iterations) on the card and through
     the twins on the CPU, in both precisions, and compares; the same for 2
     training steps;
  5. times each kernel at its main-path shapes beside its bound, its twin
     and the library calls that compute the same function (cuDNN for K1
     and conv3x3_bf16; torch.mul / torch.lerp for the GRU kernel), K1 per
     layer with the share of its bound it reaches, and the host's time for
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
     frames.

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
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import torch
import torch.nn.functional as F

from zero_tig_torch import native
from zero_tig_torch.cli import evals as cli_evals
from zero_tig_torch.cli import predict as cli_predict
from zero_tig_torch.cli import train as cli_train
from zero_tig_torch.core import precision
from zero_tig_torch.core.checkpoint import save_pt
from zero_tig_torch.core.config import Config
from zero_tig_torch.data import create_dataset, make_rlv_fixture
from zero_tig_torch.kernels import build
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.models.network import reinit_enhancer
from zero_tig_torch.models.raft.update import update_core
from zero_tig_torch.ops import gru
from zero_tig_torch.ops.conv3x3 import conv3x3_bf16, conv3x3_bf16_reference
from zero_tig_torch.ops.equalize import equalize01, equalize01_reference, equalize_u8, equalize_u8_reference
from zero_tig_torch.ops.fused_conv import ConvWeights, fused_conv, fused_conv_reference, k1_plan, launch_k1
from zero_tig_torch.pipeline.steps import init_carry, init_train_state, predict_chunk, train_chunk

H, W, OF_SCALE, ITERS, CHUNK = 1080, 1920, 3, 12, 8
HR, WR = 45, 80  # RAFT grid: (1080/3, 1920/3) padded to /8, over 8
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
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
# conv3x3_bf16's own path: (Cin, Cout) of its 1080p calls
CONV3X3_CALLS = [(64, 64), (48, 48)]

REPLACES = {
    "fused_conv": "zero_tig_tpu/ops/pack_conv.py:214 (conv3x3_packed), :394 (conv3x3_packed_multi), "
    ":546 (residual1x1_packed), :491 (residual1x1_packed_multi); "
    "zero_tig_tpu/models/raft/update_kernel.py:248 (update_core_kernel convs)",
    "gru": "zero_tig_tpu/models/raft/update_kernel.py:248 (update_core_kernel GRU gates)",
    "equalize_u8": "zero_tig_tpu/ops/pallas_equalize.py:112 (equalize_uint8_pallas)",
    "conv3x3_bf16": "zero_tig_tpu/ops/pallas_conv.py:125 (conv3x3_bf16)",
}
# the kernels of csrc/*.cu by exact name, and the wrapper that launches each
OWN_KERNELS = {
    "zt::fused_conv_mma_kernel": "fused_conv",  # bf16 operands: tensor cores
    "zt::fused_conv_kernel": "fused_conv",  # f32 operands: FMAs
    "zt::gru_reset_kernel": "gru",
    "zt::gru_update_kernel": "gru",
    "zt::equalize_kernel": "equalize_u8",  # both K3 entries: equalize_u8 and equalize01
}
SOURCES = {
    "fused_conv": "zero_tig_torch/csrc/fused_conv_mma.cu (bf16 operands), "
    "zero_tig_torch/csrc/fused_conv.cu (f32 operands)",
    "gru": "zero_tig_torch/csrc/gru.cu",
    "equalize_u8": "zero_tig_torch/csrc/equalize.cu",
    "conv3x3_bf16": "zero_tig_torch/csrc/fused_conv_mma.cu",
}
MMA, FMA = "zt::fused_conv_mma_kernel", "zt::fused_conv_kernel"


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
    FLOP at the bf16 tensor-core peak and its bytes (each input, weight and
    output once) at the HBM rate. A residual is the layer's own input xs[0]
    (the Enhancer block adds its input), so it adds no bytes."""
    _, _, parts, (h, w), _, _, anchor, out_f32, _ = layer
    kh, kw, cin, cout = cw.w.shape
    esz = cw.w.element_size()
    flops = 2.0 * h * w * cin * cout * kh * kw
    nbytes = h * w * (cin + sum(anchor)) * esz
    nbytes += cw.w.numel() * esz + h * w * cout * (4 if out_f32 else esz)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
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
    c3_bf16 = max(v for k, v in c3.items() if k.endswith("bfloat16"))
    return {"fused_conv": k1_bf16, "gru": gru_err, "equalize_u8": float(eq_err), "conv3x3_bf16": c3_bf16}


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


def conv3x3_inputs(cin, cout, gen):
    """A 1080p bf16 activation in [0, 1) (a relu output), bf16 weights and
    an f32 bias at the scale of a trained layer."""
    x = torch.rand(1, H, W, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.1 * torch.randn(3, 3, cin, cout, generator=gen, device="cuda")).to(torch.bfloat16)
    b = 0.01 * torch.randn(cout, generator=gen, device="cuda")
    return x, w, b


def phase3_main_path(fast, gen, report, smi):
    frames = torch.rand(CHUNK, 1, H, W, 3, generator=gen, device="cuda")
    frames = (frames * 255).to(torch.uint8)
    flags = torch.zeros(CHUNK, dtype=torch.bool)
    flags[0] = flags[4] = True
    carry = init_carry(fast, (1, H, W, 3))
    kw = dict(of_scale=OF_SCALE, raft_iters=ITERS, emit="u8")

    (h2, h3), carry = predict_chunk(fast, frames, carry, flags, **kw)  # warm-up
    torch.cuda.synchronize()
    build.reset_counts()
    (h2, h3), carry = predict_chunk(fast, frames, carry, flags, **kw)
    torch.cuda.synchronize()
    counts = dict(build.COUNTS)
    expect = {"fused_conv": K1_PER_FRAME * CHUNK, "gru": GRU_PER_FRAME * CHUNK,
              "equalize_u8": EQ_PER_FRAME * CHUNK, "conv3x3_bf16": 0}
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
    return counts


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


def phase5_timings(fast, gen, report):
    rows = []
    for layer in K1_LAYERS:
        name = layer[0]
        cw = layer_weights(fast, layer[1])
        xs, kwargs = k1_inputs(layer, cw.w.dtype, gen)
        # at 45x80 the twin's and the library's calls are shorter than their
        # host launches: time them inside a CUDA graph
        timer = graph_ms if layer[3] == RAFT else cuda_ms
        ms = timer(lambda: fused_conv(xs, cw, **kwargs))
        plain = timer(lambda: fused_conv_reference(xs, cw, **kwargs))
        # library: one cuDNN conv on the same channels_last bf16 tensors
        x_cl = torch.cat(xs, -1).permute(0, 3, 1, 2)
        w_cl = cw.w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bias = cw.shift.to(cw.w.dtype)
        pad = ((cw.w.shape[0] - 1) // 2, (cw.w.shape[1] - 1) // 2)
        lib = timer(lambda: F.conv2d(x_cl, w_cl, bias, padding=pad))
        bound, flops, by = k1_bound_ms(layer, cw)
        rows.append({"layer": name, "shape": [1, *layer[3], *cw.w.shape[2:]],
                     "taps": cw.w.shape[0] * cw.w.shape[1], "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9,
                     "per_frame": layer[-1]})
        print(f"time K1 {name:18s} ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bound:.4f} ({by}, {bound / ms:.1%} of it reached) x{layer[-1]}/frame", flush=True)
    report["k1_layers"] = rows
    for where, grid in (("1080p", FULL), ("45x80", RAFT)):
        sub = [r for r, layer in zip(rows, K1_LAYERS) if layer[3] == grid]
        tot = {k: sum(r[k] * r["per_frame"] for r in sub) for k in ("ms", "library_ms", "bound_ms")}
        print(f"time K1 per frame at {where}: ms={tot['ms']:.4f} library_ms={tot['library_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f} over {sum(r['per_frame'] for r in sub)} launches", flush=True)

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

    per_frame = lambda key: sum(r[key] * r["per_frame"] for r in rows)  # noqa: E731
    return {
        "fused_conv": dict(ms=per_frame("ms"), plain_ms=per_frame("plain_ms"),
                           bound_ms=per_frame("bound_ms"), library_ms=per_frame("library_ms"),
                           bound_by=k1_bound_by(rows)),
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
    build.reset_counts()
    outs = [conv3x3_bf16(x, w, b) for x, w, b in inputs]
    torch.cuda.synchronize()
    counts = dict(build.COUNTS)
    expect = {"fused_conv": 0, "gru": 0, "equalize_u8": 0, "conv3x3_bf16": len(CONV3X3_CALLS)}
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
    expect = {"fused_conv": K1_PER_TRAIN_FRAME * 2 * TRAIN_FRAMES, "gru": GRU_PER_FRAME * 2 * TRAIN_FRAMES,
              "equalize_u8": EQ_PER_FRAME * 2 * TRAIN_FRAMES, "conv3x3_bf16": 0}
    out = {}
    for mode in ("fast", "highest"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(Config(precision=mode, **kw), sd, (1, H, W, 3), device="cuda")
        reinit_enhancer(state.model, torch.Generator(device="cuda").manual_seed(SEED))
        state, _ = train_chunk(state, frames[:1], flags[:1], **kw)  # warm-up frame
        before = [p.detach().clone() for p in state.optimizer.params]
        bn = state.model.enhance.conv[1]
        stats0 = bn.running_mean.clone()
        torch.cuda.synchronize()
        build.reset_counts()
        ms, losses = {}, []
        for bn_train in (True, False):
            t0 = time.perf_counter()
            state, loss = train_chunk(state, frames, flags, bn_train=bn_train, **kw)
            torch.cuda.synchronize()
            ms[bn_train] = (time.perf_counter() - t0) * 1e3 / TRAIN_FRAMES
            losses.append(loss)
            if bn_train:
                stats1 = bn.running_mean.clone()
        counts = dict(build.COUNTS)
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


def expect_counts(label: str, counts: dict, frames: int, train_frames: int = 0) -> None:
    """The launches ``frames`` inference frames and ``train_frames`` training
    (or training-model eval) frames make."""
    want = {"fused_conv": K1_PER_FRAME * frames + K1_PER_TRAIN_FRAME * train_frames,
            "gru": GRU_PER_FRAME * (frames + train_frames), "equalize_u8": EQ_PER_FRAME * (frames + train_frames),
            "conv3x3_bf16": 0}
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
            build.reset_counts()
            secs, _ = run_cli(f"predict fast run {run}", cli_predict.main,
                              common + ["--save", str(save), "--precision", "fast", "--chunk", "4"])
            counts = dict(build.COUNTS)
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
        build.reset_counts()
        secs, _ = run_cli("predict fast long", cli_predict.main,
                          CLI_FLAGS + ["--lowlight_images_path", str(fx_long), "--model_pretrain", str(pt),
                                       "--save", str(save), "--precision", "fast", "--chunk", "4"])
        expect_counts("predict CLI fast long", dict(build.COUNTS), len(long_recs))
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
        build.reset_counts()
        secs, _ = run_cli("predict enh_scale 2", cli_predict.main,
                          CLI_FLAGS + ["--lowlight_images_path", str(fx4), "--model_pretrain", str(pt),
                                       "--save", str(save), "--precision", "fast", "--chunk", "4",
                                       "--enh_scale", "2"])
        expect_counts("predict CLI fast --enh_scale 2", dict(build.COUNTS), 4)
        check_predict_pngs("predict CLI fast --enh_scale 2", save, recs[:4], ref_h2, ref_h3)
        out["predict_enh_scale2"] = {"ms_per_frame": secs * 1e3 / 4, "frames": 4}
        del fast

        # (c) predict, the default precision (highest: the f32 K1), 4 frames
        highest = build_model(sd, device="cuda", precision="highest")
        ref_h2, ref_h3 = reference_u8(highest, frames[:4], flags[:4], 4)
        del highest
        save = tmp / "pred_highest"
        build.reset_counts()
        secs, _ = run_cli("predict highest", cli_predict.main,
                          CLI_FLAGS + ["--lowlight_images_path", str(fx4), "--model_pretrain", str(pt),
                                       "--save", str(save), "--chunk", "4"])
        expect_counts("predict CLI highest", dict(build.COUNTS), 4)
        check_predict_pngs("predict CLI highest", save, recs[:4], ref_h2, ref_h3)
        out["predict_highest"] = {"ms_per_frame": secs * 1e3 / 4, "frames": 4}
        print(f"predict CLI 1080p highest chunk=4: {secs * 1e3 / 4:.3f} ms/frame wall over 4 frames", flush=True)

        # (d) train, fast, 2 epochs of 8 frames in chunks of 2, then a resume
        exp = tmp / "exp"
        train_flags = CLI_FLAGS + ["--lowlight_images_path", fx, "--precision", "fast", "--chunk", "2",
                                   "--epochs", "2"]
        build.reset_counts()
        secs, _ = run_cli("train", cli_train.main, train_flags + ["--save", str(exp)])
        # 2 epochs of 8 training frames and 8 eval frames, all on the training model
        expect_counts("train CLI", dict(build.COUNTS), 0, 4 * CLI_FRAMES)
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
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sd = init_random_state_dict(SEED)
    fast = build_model(sd, device="cuda", precision="fast")
    highest = build_model(sd, device="cuda", precision="highest")
    report: dict = {"device": smi, "build_s": build.BUILD_SECONDS}

    with precision.numerics("highest"):  # f32 twins hold f32 sums, not TF32
        errs = phase2_kernels(fast, highest, gen, report)
    # the main path and the timings run with PyTorch's default switches, as
    # a user's fast-mode model does
    counts = phase3_main_path(fast, gen, report, smi)
    phase4_card_vs_cpu(sd, gen, report)
    times = phase5_timings(fast, gen, report)
    counts["conv3x3_bf16"] = phase6_conv3x3_path(gen, report)
    del fast, highest
    phase7_training(sd, report, smi)
    phase8_cli(sd, report, smi, report["main_path"]["ms_per_frame"])

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": counts[name], "max_abs_err": errs[name], **times[name]}
        for name in ("fused_conv", "gru", "equalize_u8", "conv3x3_bf16")
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
