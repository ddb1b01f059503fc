"""Banded training: one full-resolution training frame in one band's memory.

Port of ``zero_tig_tpu/pipeline/spatial.py`` (:1-927). The training step
splits in two:

  * what is global in the frame -- RAFT flow, the histogram equalise, the
    backward warp, and the loss's enhancement factor and scrambled yCbCr --
    carries no gradient, so it runs ONCE on the full frame under
    ``no_grad`` (``_flow_phase``, on K1, K2 and K3 on the card);
  * what has gradients (Denoise_1 and 2, the Enhancer, the 17 loss terms)
    sees ~24 rows around a pixel at most, so the forward and backward run
    per horizontal band on the band plus ``halo`` rows each side, with the
    loss in ``Region`` mode (owned rows, full-frame counts). The bands'
    gradients accumulate in the parameters' ``.grad``; one clip, weight
    decay and Adam update follows, as in ``train_step``. Peak memory is one
    band's backward.

The summed band losses and gradients equal the monolithic step's up to the
order of f32 sums. With ``bn_train`` (the reference's epoch 0) the
Enhancer's BatchNorm normalises by the FULL frame's batch statistics, a
reduction with gradients. They are computed exactly, in three passes:

  * pass A (``_bn_pass_a``): each use k of the shared block gets its
    (mean_k, var_k) from owned-row sums over the bands, stage after stage,
    each band's (fea, pre-BN) activations kept from one stage to the next;
    the variance is the centered sum of squares; each sum is
    ``layers.channel_sum``'s (rows in f32, the rows' sums in f64), so the
    statistics barely depend on how the rows split into bands or processes;
  * pass B (``_band_grad``): each band's loss and gradients with the stats
    as differentiable inputs; their gradients sum over the bands;
  * pass C (``_bn_pass_c``): the stats' adjoints back through the
    statistics into the Enhancer's in_conv, block conv and BatchNorm
    parameters, one descending sweep over the stages, summing the cheap
    BatchNorm-path cotangents over the bands before each stage's conv
    backward (the stats are sums over every band). Inside var_k's adjoint
    mean_k is held constant: the dropped term is a sum of centered values,
    zero. The JAX package keeps each band's pre-BN activations through the
    pass; the port computes them again from fea_k, so the pass holds half
    as much (at 1080p and 4 bands its cache was the step's peak).

The JAX package also fuses the band loop into one program (``_band_scan``
and the ``_fused_*`` steps, :621-855), to cut dispatches on the TPU. Its
arithmetic is this band loop's, so the port has the loop alone.
"""

from __future__ import annotations

import torch

from ..core.precision import numerics
from ..losses.zero_tig_loss import Region, loss_factor, rgb2ycbcr_scrambled, zero_tig_loss
from ..models.enhancer import Enhancer
from ..models.denoise import EPS
from ..models.layers import batch_norm_with, channel_sum, clip, conv2d, move_running_stats
from ..models.network import ZeroTIG, forward_train_core, train_denoise_1, warped_state
from .steps import TrainState, _carry_on, _norm_frames


def band_geometry(h: int, bands: int, halo: int) -> tuple[int, list[tuple[int, int, int]]]:
    """(slice_h, [(slice_start, own_start, own_end)] per band): band i owns
    rows [i*h/bands, (i+1)*h/bands) and runs on ``slice_h`` rows around
    them, moved inside the frame at its edges."""
    if h % bands:
        raise ValueError(f"H={h} not divisible by bands={bands}")
    band_h = h // bands
    if band_h % 2 or halo % 2:
        raise ValueError("band height and halo must be even (pair maps)")
    slice_h = min(band_h + 2 * halo, h)
    geoms = []
    for i in range(bands):
        own = i * band_h
        geoms.append((min(max(own - halo, 0), h - slice_h), own, own + band_h))
    return slice_h, geoms


@torch.no_grad()
def _flow_phase(model: ZeroTIG, frame, carry, is_new_seq, *, of_scale: int, raft_iters: int, is_wb: bool):
    """The full frame's gradient-free quantities: the warped carry w6 and
    the Enhancer's input [w6 | L2] (model dtype), the loss's enhancement
    factor and the scrambled yCbCr of the detached L2 (f32)."""
    inp = (frame + EPS).to(model.dtype)
    L2 = clip(inp - model.denoise_1.train_forward(inp, model.dtype), EPS, 1.0)
    w6 = warped_state(model, carry, L2, is_new_seq, of_scale=of_scale, raft_iters=raft_iters)
    L2d = L2.float()
    return w6, torch.cat([w6, L2], -1), loss_factor(L2d, is_wb=is_wb), rgb2ycbcr_scrambled(L2d)


def _band_grad(model: ZeroTIG, frame, w6, factor, ycc, geom, *, slice_h: int, is_wb: bool, stats=None):
    """One band's forward and backward: its loss (detached), and the owned
    rows of H3 and s3 for the carry. The gradients add to the parameters'
    ``.grad`` (and to the stats', when they are given)."""
    s0, own0, own1 = geom
    rows = slice(s0, s0 + slice_h)
    frame_sl = frame[:, rows]
    outputs, _ = forward_train_core(model, train_denoise_1(model, frame_sl), w6[:, rows], bn_train=False, bn_stats=stats)
    region = Region(s0, own0, own1, frame.shape[1])
    loss = zero_tig_loss(frame_sl, outputs, is_wb=is_wb, region=region, factor=factor, ycc=ycc[:, rows])
    loss.backward()
    own = slice(own0 - s0, own1 - s0)
    return loss.detach(), outputs.H3[:, own].detach(), outputs.s3[:, own].detach()


def _owned(x: torch.Tensor, geom) -> torch.Tensor:
    """The owned rows of an NCHW band tensor."""
    s0, own0, own1 = geom
    return x[:, :, own0 - s0:own1 - s0]


def _stage(enh: Enhancer, fea, pre, mean, var, dtype):
    """Finish use k-1 of the shared block on (fea, pre) with its stats --
    BatchNorm, relu, the residual -- and run use k's conv: (fea, pre)."""
    fea = fea + torch.relu(batch_norm_with(enh.conv[1], pre, mean, var))
    return fea, conv2d(enh.conv[0], fea, dtype)


def _stage0(enh: Enhancer, enh_in, geom, slice_h: int, dtype):
    sl = enh_in[:, geom[0]:geom[0] + slice_h].permute(0, 3, 1, 2)
    fea = torch.relu(conv2d(enh.in_conv[0], sl, dtype))
    return fea, conv2d(enh.conv[0], fea, dtype)


def _local(t: torch.Tensor) -> torch.Tensor:
    """The sums over this process's bands are the sums over every band."""
    return t


@torch.no_grad()
def _bn_pass_a(enh: Enhancer, enh_in, geoms, *, slice_h: int, n_el: int, dtype, reduce=_local):
    """The full frame's batch statistics of the block's three uses, exactly:
    owned-row ``channel_sum``s over the bands, the variance centered. Returns the
    three (mean, biased var) pairs. ``reduce`` sums a (C,) sum over the
    processes that hold the other bands (``parallel/spmd_train.py``)."""
    acts = [_stage0(enh, enh_in, g, slice_h, dtype) for g in geoms]
    stats = []
    for k in range(3):
        if k:
            acts = [_stage(enh, fea, pre, *stats[k - 1], dtype) for fea, pre in acts]
        mean = (reduce(sum(channel_sum(_owned(pre, g)) for (_, pre), g in zip(acts, geoms))) / n_el).float()
        c = mean.view(1, -1, 1, 1)
        var = reduce(sum(channel_sum(torch.square(_owned(pre, g).float() - c)) for (_, pre), g in zip(acts, geoms)))
        stats.append((mean, (var / n_el).float()))
    return stats


def _accumulate(params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g.clone() if p.grad is None else p.grad + g


def _bn_pass_c(enh: Enhancer, enh_in, stats, e_stats, geoms, *, slice_h: int, n_el: int, dtype,
               reduce=_local) -> None:
    """The stats -> parameters chain: adds to the ``.grad`` of the
    Enhancer's in_conv, block conv and BatchNorm scale and shift the terms
    that reach them through the batch statistics, whose total cotangents
    pass B left in ``e_stats`` (summed over every band). Each band keeps its
    three fea_k; pre_k = conv(fea_k) is computed again where it is needed,
    which halves what the pass holds at once. ``reduce``: as in pass A, for
    the statistics' cotangents from the BatchNorm path."""
    conv, bn = enh.conv[0], enh.conv[1]
    stats = [tuple(s.detach() for s in pair) for pair in stats]
    feas = []
    with torch.no_grad():  # the chain, recomputed: fea_k per band and use
        for g in geoms:
            acts = [_stage0(enh, enh_in, g, slice_h, dtype)]
            for k in (1, 2):
                acts.append(_stage(enh, *acts[-1], *stats[k - 1], dtype))
            feas.append([fea for fea, _ in acts])
            del acts
    cot_fea = [torch.zeros_like(f[0]) for f in feas]
    for k in (2, 1, 0):
        c_mean, c_var = e_stats[k]
        cot_pre_bn = [None] * len(geoms)  # use 2's output feeds no statistic: no BatchNorm-path cotangent
        if k < 2:
            mean, var = (s.clone().requires_grad_(True) for s in stats[k])
            d_mean = d_var = 0.0
            for b in range(len(geoms)):
                # the BatchNorm path fea_{k+1} = fea_k + relu(BN(pre_k)): elementwise
                with torch.no_grad():
                    pre = conv2d(conv, feas[b][k], dtype)
                pre.requires_grad_(True)
                y = torch.relu(batch_norm_with(bn, pre, mean, var))
                dm, dv, ds, db, cot_pre_bn[b] = torch.autograd.grad(y, (mean, var, bn.weight, bn.bias, pre), cot_fea[b])
                d_mean, d_var = d_mean + dm, d_var + dv
                _accumulate((bn.weight, bn.bias), (ds, db))
            c_mean, c_var = c_mean + reduce(d_mean), c_var + reduce(d_var)
        cot_s1 = (c_mean / n_el).view(1, -1, 1, 1)
        cot_s2 = (c_var / n_el).view(1, -1, 1, 1)
        for b, g in enumerate(geoms):
            # one conv backward under pre_k's total cotangent: the BatchNorm
            # path's plus the owned-row sums' (mean_k constant in var_k's)
            fea = feas[b][k].detach().requires_grad_(True)
            pre = conv2d(conv, fea, dtype)
            cot = torch.zeros_like(pre, dtype=torch.float32) if cot_pre_bn[b] is None else cot_pre_bn[b].float()
            own = _owned(cot, g)
            own += cot_s1 + 2.0 * (_owned(pre.detach(), g).float() - stats[k][0].view(1, -1, 1, 1)) * cot_s2
            dw, dbias, dfea = torch.autograd.grad(pre, (conv.weight, conv.bias, fea), cot.to(pre.dtype))
            _accumulate((conv.weight, conv.bias), (dw, dbias))
            cot_fea[b] = dfea + cot_fea[b]
            cot_pre_bn[b] = None
    in_conv = enh.in_conv[0]
    for b, g in enumerate(geoms):
        sl = enh_in[:, g[0]:g[0] + slice_h].permute(0, 3, 1, 2)
        fea0 = torch.relu(conv2d(in_conv, sl, dtype))
        _accumulate((in_conv.weight, in_conv.bias), torch.autograd.grad(fea0, (in_conv.weight, in_conv.bias), cot_fea[b]))


def spatial_loss_and_grads(
    state: TrainState,
    frame,
    is_new_seq,
    *,
    bands: int = 2,
    halo: int = 32,
    of_scale: int = 3,
    raft_iters: int = 12,
    is_wb: bool = False,
    bn_train: bool = True,
) -> tuple[torch.Tensor, dict]:
    """One frame's banded loss and gradients, before the optimizer: (loss,
    new_carry), the gradients left in the trainable parameters' ``.grad``
    and, with ``bn_train``, the running statistics moved (three blends with
    the full frame's batch statistics). The equivalence tests read the
    gradients here: Adam's normalised step turns rounding-level gradient
    differences into whole-lr parameter differences."""
    frame = _norm_frames(frame, state.model.device)
    slice_h, geoms = band_geometry(frame.shape[1], bands, halo)
    loss, h3, s3 = bands_loss_and_grads(
        state, frame, is_new_seq, geoms, slice_h=slice_h, n_el=frame[..., 0].numel(), of_scale=of_scale,
        raft_iters=raft_iters, is_wb=is_wb, bn_train=bn_train,
    )
    return loss, {"last_H3": torch.cat(h3, 1).contiguous(), "last_s3": torch.cat(s3, 1).contiguous()}


def bands_loss_and_grads(
    state: TrainState,
    frame: torch.Tensor,
    is_new_seq,
    geoms: list[tuple[int, int, int]],
    *,
    slice_h: int,
    n_el: int,
    of_scale: int,
    raft_iters: int,
    is_wb: bool,
    bn_train: bool,
    reduce=_local,
) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
    """``spatial_loss_and_grads`` on the bands ``geoms`` of a frame on the
    model's device: (the bands' summed loss, and per band the owned rows of
    H3 and of s3). ``n_el``: the values a channel's batch statistics count;
    ``reduce``: the sum of a statistic's (C,) sums, or of their cotangents,
    over the processes that hold the other bands. A multi-device step
    (``parallel/spmd_train.py``) runs its rank's band with a world
    all-reduce here; one process runs every band with none."""
    model = state.model
    dev = model.device
    dtype = model.dtype
    with numerics(model.precision):
        w6, enh_in, factor, ycc = _flow_phase(
            model, frame, _carry_on(state.carry, dev), torch.as_tensor(is_new_seq, device=dev),
            of_scale=of_scale, raft_iters=raft_iters, is_wb=is_wb,
        )
        stats = None
        if bn_train:
            stats = _bn_pass_a(model.enhance, enh_in, geoms, slice_h=slice_h, n_el=n_el, dtype=dtype, reduce=reduce)
            for mean, var in stats:
                move_running_stats(model.enhance.conv[1], mean, var, n_el)
            stats = [tuple(s.clone().requires_grad_(True) for s in pair) for pair in stats]
        loss = torch.zeros((), device=dev)
        h3, s3 = [], []
        for g in geoms:
            band_loss, H3_b, s3_b = _band_grad(model, frame, w6, factor, ycc, g, slice_h=slice_h, is_wb=is_wb, stats=stats)
            loss = loss + band_loss
            h3.append(H3_b)
            s3.append(s3_b)
        if bn_train:
            e_stats = [tuple(reduce(s.grad) for s in pair) for pair in stats]
            _bn_pass_c(model.enhance, enh_in, stats, e_stats, geoms, slice_h=slice_h, n_el=n_el, dtype=dtype,
                       reduce=reduce)
    return loss, h3, s3


def train_step_spatial(
    state: TrainState,
    frame,
    is_new_seq,
    *,
    bands: int = 2,
    halo: int = 32,
    of_scale: int = 3,
    raft_iters: int = 12,
    is_wb: bool = False,
    bn_train: bool = True,
) -> tuple[TrainState, torch.Tensor]:
    """``train_step`` by bands: one training frame (B, H, W, 3), H divisible
    by ``bands`` into even band heights, each band run with ``halo`` (even)
    rows around it; the halo must cover the gradient path's ~24 rows of
    receptive field. (new_state, loss), the same as ``train_step`` up to the
    order of f32 sums. bn_train: pass (epoch == 0), as to ``train_step``."""
    loss, carry = spatial_loss_and_grads(
        state, frame, is_new_seq, bands=bands, halo=halo, of_scale=of_scale,
        raft_iters=raft_iters, is_wb=is_wb, bn_train=bn_train,
    )
    with numerics(state.model.precision):
        state.optimizer.step()
    return TrainState(state.model, state.optimizer, carry), loss
