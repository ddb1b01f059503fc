"""The composed Zero-TIG network: Denoise_1 -> flow + warp -> Enhancer ->
Denoise_2, for inference (``forward_inference``, on the kernels) and for
zero-shot training (``forward_train``, under autograd).

Port of ``zero_tig_tpu/models/network.py::update_cache`` (:139-181) and
``forward_inference`` (:619-745; reference Finetunemodel.forward,
model/model.py:312-340). In fast mode the dtypes follow
``_forward_inference_packed`` (:944-1021): bf16 working tensors, the three
outputs and the carry cast to f32. Quirks kept: the previous output is
scaled by 255 and NOT equalised while the current frame is; one 6-channel
warp moves both carried tensors; on a new sequence the warped state is
zeroed for the Enhancer and replaced by H2 for Denoise_2.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import torch
from torch import nn

from ..core import spans
from ..core.precision import check_mode, compute_dtype, numerics
from ..ops.equalize import equalize01
from ..ops.filters import blur, pair_downsampler, texture_difference
from ..ops.resize import resize_bilinear
from ..ops.warp import warp_tensor
from .denoise import EPS, Denoise1, Denoise2
from .enhancer import Enhancer
from .layers import clip
from .raft.raft import RAFT


class ZeroTIG(nn.Module):
    """Parameters under the reference's names (``enhance.*``,
    ``denoise_1.*``, ``denoise_2.*``, ``raft.*``), so a reference state
    dict loads as it is."""

    def __init__(self, precision: str = "fast"):
        super().__init__()
        self.precision = check_mode(precision)
        self.enhance = Enhancer(layers=3, channels=64)
        self.denoise_1 = Denoise1(48)
        self.denoise_2 = Denoise2(48)
        self.raft = RAFT()

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.precision)

    @property
    def device(self) -> torch.device:
        return self.denoise_1.conv1.weight.device

    def prepare(self) -> "ZeroTIG":
        """Bring the kernels' weight operands of the four modules up to date
        with their weights and the precision: each module builds its own
        again where its stamp changed (``layers.kernel_operands``), so a
        writer of weights (a training step, ``load_state_dict``,
        ``reinit_enhancer``) has nothing to clear. Every inference frame
        calls it; where nothing changed it builds nothing."""
        for m in (self.enhance, self.denoise_1, self.denoise_2, self.raft):
            m.prepare(self.dtype)
        return self

    def trainable_parameters(self) -> list[nn.Parameter]:
        """The parameters training updates, each shared one once: the
        Enhancer and both denoisers. RAFT stays frozen (train.py:98)."""
        return [p for m in (self.enhance, self.denoise_1, self.denoise_2) for p in m.parameters()]


def update_cache(
    raft: RAFT,
    last_H3: torch.Tensor,
    last_s3: torch.Tensor,
    L2: torch.Tensor,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
) -> torch.Tensor:
    """Flow from the previous output to the current frame at 1/of_scale,
    then one backward warp of [last_H3 | last_s3]: (B, H, W, 6). RAFT runs
    its graphed inference path (``RAFT.flow_graphed``); resize, K3 and the
    warp stay eager."""
    with spans.span("zt.flow"):
        h, w = last_H3.shape[1], last_H3.shape[2]
        size = (h // of_scale, w // of_scale)
        last_tmp = resize_bilinear(last_H3, size) * 255.0  # NOT equalised
        l2_tmp = equalize01(resize_bilinear(L2, size))  # equalised
        _, flow_up = raft.flow_graphed(last_tmp, l2_tmp, iters=raft_iters)  # static on a card: used at once
        return warp_tensor(flow_up, torch.cat([last_H3, last_s3], dim=-1))


def forward_inference(
    model: ZeroTIG,
    frame: torch.Tensor,
    carry: dict,
    is_new_seq: torch.Tensor,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
    enh_scale: int = 1,
    rows: slice = slice(None),
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], dict]:
    """One frame (B, H, W, 3) f32 in [0, 1] -> ((H2, H3, s3), new_carry),
    all f32 (B, H, W, 3). is_new_seq: bool tensor, scalar or (B,).

    enh_scale > 1 runs the Enhancer at 1/enh_scale of the frame (a bilinear
    resize of its inputs) and resizes s2 back up, where the frame divides
    by it; elsewhere it warns and runs at full resolution (JAX :713-729).
    The denoisers always run at full resolution.

    ``rows``: the Enhancer and Denoise_2 run on these rows of the frame
    alone, and the outputs are theirs (a band of a row-sharded step,
    ``parallel/spmd_predict.py``); Denoise_1, the flow and the warp still
    take the whole frame. At 1/enh_scale the Enhancer takes the whole frame."""
    with spans.span("zt.infer.frame"):
        model.prepare()
        with numerics(model.precision):
            cdt = model.dtype
            with spans.span("zt.infer.denoise_1"):
                inp = (frame + EPS).to(cdt).contiguous()
                L2 = model.denoise_1([inp], anchor=[inp])
            w6 = update_cache(
                model.raft, carry["last_H3"].to(cdt), carry["last_s3"].to(cdt), L2,
                of_scale=of_scale, raft_iters=raft_iters,
            )
            new = is_new_seq.to(device=w6.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
            w6 = torch.where(new, torch.zeros_like(w6), w6)

            s2 = _enhance(model, w6, L2, enh_scale, rows)
            with spans.span("zt.infer.denoise_2"):
                H2 = torch.clamp(inp[:, rows] / s2, EPS, 1.0)
                # new-sequence quirk (model/model.py:330-332): warped previous := H2
                w6 = torch.where(new, torch.cat([H2, H2], dim=-1), w6[:, rows]).contiguous()
                H5 = model.denoise_2([w6, H2, s2], anchor=[H2, s2])
                H3 = H5[..., :3].float().contiguous()
                s3 = H5[..., 3:].float().contiguous()
                return (H2.float(), H3, s3), {"last_H3": H3, "last_s3": s3}


def _enhance(model: ZeroTIG, w6: torch.Tensor, L2: torch.Tensor, enh_scale: int, rows: slice) -> torch.Tensor:
    with spans.span("zt.infer.enhancer"):
        h, w = L2.shape[1], L2.shape[2]
        if enh_scale > 1 and (h % enh_scale or w % enh_scale):
            warnings.warn(
                f"enh_scale={enh_scale} requested but frame {h}x{w} is not "
                f"divisible by it; running the exact full-resolution enhancer "
                f"instead (the benchmark point you measure is NOT the half-res "
                f"one)",
                stacklevel=3,
            )
        if enh_scale <= 1 or h % enh_scale or w % enh_scale:
            return model.enhance([w6[:, rows].contiguous(), L2[:, rows].contiguous()])
        # the resize is per channel, so the two parts resize apart and stay
        # two inputs of the first launch. A band of the small frame would need
        # halo rows of its own, and the resize back a row across the band's
        # edge: the whole frame it is, on every rank of a row-sharded scene
        small = (h // enh_scale, w // enh_scale)
        s2 = model.enhance([resize_bilinear(w6, small), resize_bilinear(L2, small)])
        return resize_bilinear(s2, (h, w))[:, rows].contiguous()


class TrainOutputs(NamedTuple):
    """The reference's 23 training outputs (model/model.py:203), NHWC f32,
    in the order of ``zero_tig_tpu/models/network.py::TrainOutputs``."""

    L_pred1: torch.Tensor
    L_pred2: torch.Tensor
    L2: torch.Tensor
    s2: torch.Tensor
    s21: torch.Tensor
    s22: torch.Tensor
    H2: torch.Tensor
    H11: torch.Tensor
    H12: torch.Tensor
    H13: torch.Tensor
    s13: torch.Tensor
    H14: torch.Tensor
    s14: torch.Tensor
    H3: torch.Tensor
    s3: torch.Tensor
    H3_pred: torch.Tensor
    H4_pred: torch.Tensor
    L_pred1_L_pred2_diff: torch.Tensor
    H3_denoised1_H3_denoised2_diff: torch.Tensor
    H2_blur: torch.Tensor
    H3_blur: torch.Tensor
    H3_denoised1: torch.Tensor
    H3_denoised2: torch.Tensor


def forward_train(
    model: ZeroTIG,
    frame: torch.Tensor,
    carry: dict,
    is_new_seq: torch.Tensor,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
    bn_train: bool = True,
) -> tuple[TrainOutputs, dict]:
    """The training forward (reference Network.forward, model/model.py:84-259)
    on one frame (B, H, W, 3) f32 in [0, 1]: (outputs, new_carry). With
    ``bn_train`` the Enhancer's running statistics move, in place.

    Port of ``forward_train`` + ``forward_train_core`` (:184-444). Detached,
    as in the reference: the Enhancer input, the ``H*_pred`` anchors and
    the whole flow branch. The flow branch (``warped_state``: RAFT and the
    warp, on K1, K2 and K3) runs under ``no_grad`` on the ``L2`` of this
    forward, detached: the same value the JAX package computes a second
    time in its flow phase (:238-241), and never a snapshot of older weights.
    In fast mode the conv operands and activations are bf16 and the outputs
    go to f32 at the boundary to the loss, as ``_forward_train_xpack``
    (:447-616) without its packed layout.
    """
    with spans.span("zt.train.forward"):
        first = train_denoise_1(model, frame)
        w6 = warped_state(model, carry, first.L2.detach(), is_new_seq, of_scale=of_scale, raft_iters=raft_iters)
        return forward_train_core(model, first, w6, bn_train=bn_train)


class Denoised1(NamedTuple):
    """Denoise_1's training outputs on one frame or row slice, in the model's
    dtype: the input plus 1e-4, its two pair-downsampled halves, their
    residual predictions, and the clipped full-resolution L2."""

    inp: torch.Tensor
    L11: torch.Tensor
    L12: torch.Tensor
    L_pred1: torch.Tensor
    L_pred2: torch.Tensor
    L2: torch.Tensor


def train_denoise_1(model: ZeroTIG, frame: torch.Tensor) -> Denoised1:
    cdt = model.dtype
    inp = (frame + EPS).to(cdt)
    L11, L12 = pair_downsampler(inp)
    d1 = functools.partial(model.denoise_1.train_forward, dtype=cdt)
    return Denoised1(inp, L11, L12, L11 - d1(L11), L12 - d1(L12), clip(inp - d1(inp), EPS, 1.0))


@torch.no_grad()
def warped_state(
    model: ZeroTIG, carry: dict, L2: torch.Tensor, is_new_seq: torch.Tensor, *, of_scale: int, raft_iters: int
) -> torch.Tensor:
    """The training forward's flow branch: the carry [last_H3 | last_s3]
    warped onto the frame whose detached Denoise_1 output is ``L2``, zeroed
    on a new sequence; (B, H, W, 6) in the model's dtype."""
    cdt = model.dtype
    w6 = update_cache(
        model.raft, carry["last_H3"].to(cdt), carry["last_s3"].to(cdt), L2,
        of_scale=of_scale, raft_iters=raft_iters,
    ).to(cdt)
    new = is_new_seq.to(device=w6.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
    return torch.where(new, torch.zeros_like(w6), w6)


def forward_train_core(
    model: ZeroTIG,
    first: Denoised1,
    w6: torch.Tensor,
    *,
    bn_train: bool,
    bn_stats: list | None = None,
) -> tuple[TrainOutputs, dict]:
    """The gradient-carrying rest of the training forward after the flow
    branch: the Enhancer on [w6 | L2], Denoise_2 three times, the loss's
    maps. Every op is local in space, so banded training runs it on row
    slices (``pipeline/spatial.py``). ``bn_stats``: three (mean, var) pairs
    that the Enhancer's BatchNorm normalises with instead of its batch or
    running statistics (port of ``forward_train_core``'s ``bn_overrides``)."""
    cdt = model.dtype
    inp, L11, L12, L_pred1, L_pred2, L2 = first
    d2 = functools.partial(model.denoise_2.train_forward, dtype=cdt)
    last_H31_wp, last_H32_wp = pair_downsampler(w6[..., :3])
    last_s31_wp, last_s32_wp = pair_downsampler(w6[..., 3:])

    s2 = model.enhance.train_forward(torch.cat([w6, L2.detach()], -1), cdt, bn_train=bn_train, stats=bn_stats)
    s21, s22 = pair_downsampler(s2)
    H2 = clip(inp / s2, EPS, 1.0)
    H11 = clip(L11 / s21, EPS, 1.0)
    H12 = clip(L12 / s22, EPS, 1.0)

    def refine(w_H3, w_s3, H, s):
        anchor = torch.cat([H, s], -1).detach()
        return clip(anchor - d2(torch.cat([w_H3, w_s3, H, s], -1)), EPS, 1.0)

    H3_pred = refine(last_H31_wp, last_s31_wp, H11, s21)
    H4_pred = refine(last_H32_wp, last_s32_wp, H12, s22)
    H5_pred = refine(w6[..., :3], w6[..., 3:], H2, s2)

    # the boundary to the loss: f32 (a no-op in highest mode)
    L_pred1, L_pred2, L2 = L_pred1.float(), L_pred2.float(), L2.float()
    s2, s21, s22 = s2.float(), s21.float(), s22.float()
    H2, H11, H12 = H2.float(), H11.float(), H12.float()
    H3_pred, H4_pred, H5_pred = H3_pred.float(), H4_pred.float(), H5_pred.float()
    H3, s3 = H5_pred[..., :3], H5_pred[..., 3:]
    H3_denoised1, H3_denoised2 = pair_downsampler(H3)
    H1 = clip(L2 / s2, 0.0, 1.0)
    outputs = TrainOutputs(
        L_pred1, L_pred2, L2, s2, s21, s22, H2, H11, H12,
        H3_pred[..., :3], H3_pred[..., 3:], H4_pred[..., :3], H4_pred[..., 3:],
        H3, s3, H3_pred, H4_pred,
        texture_difference(L_pred1, L_pred2), texture_difference(H3_denoised1, H3_denoised2),
        blur(H1), blur(H3), H3_denoised1, H3_denoised2,
    )
    new_carry = {"last_H3": H3.detach().contiguous(), "last_s3": s3.detach().contiguous()}
    return outputs, new_carry


@torch.no_grad()
def reinit_enhancer(model: ZeroTIG, generator: torch.Generator) -> None:
    """The reference's Enhancer init (model/model.py:123-130, train.py:82-84),
    in place: conv kernels ~ N(0, 0.02), biases 0, BatchNorm scale
    ~ N(1, 0.02); running statistics untouched. Draws on the generator's
    device, in the order of ``named_parameters`` (the shared block once)."""
    for name, p in model.enhance.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        noise = torch.randn(p.shape, generator=generator, device=generator.device)
        p.copy_((1.0 if p.dim() == 1 else 0.0) + 0.02 * noise)
