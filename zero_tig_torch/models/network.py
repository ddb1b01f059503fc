"""The composed Zero-TIG inference network: Denoise_1 -> flow + warp ->
Enhancer -> Denoise_2.

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

import torch
from torch import nn

from ..core.precision import check_mode, compute_dtype, numerics
from ..ops.equalize import equalize01
from ..ops.resize import resize_bilinear
from ..ops.warp import warp_tensor
from .denoise import EPS, Denoise1, Denoise2
from .enhancer import Enhancer
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
        """Build the kernels' weight operands (after loading and moving)."""
        for m in (self.enhance, self.denoise_1, self.denoise_2, self.raft):
            m.prepare(self.dtype)
        return self


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
    then one backward warp of [last_H3 | last_s3]: (B, H, W, 6)."""
    h, w = last_H3.shape[1], last_H3.shape[2]
    size = (h // of_scale, w // of_scale)
    last_tmp = resize_bilinear(last_H3, size) * 255.0  # NOT equalised
    l2_tmp = equalize01(resize_bilinear(L2, size))  # equalised
    _, flow_up = raft(last_tmp, l2_tmp, iters=raft_iters)
    return warp_tensor(flow_up, torch.cat([last_H3, last_s3], dim=-1))


def forward_inference(
    model: ZeroTIG,
    frame: torch.Tensor,
    carry: dict,
    is_new_seq: torch.Tensor,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], dict]:
    """One frame (B, H, W, 3) f32 in [0, 1] -> ((H2, H3, s3), new_carry),
    all f32 (B, H, W, 3). is_new_seq: bool tensor, scalar or (B,)."""
    with numerics(model.precision):
        cdt = model.dtype
        inp = (frame + EPS).to(cdt).contiguous()
        L2 = model.denoise_1([inp], anchor=[inp])
        w6 = update_cache(
            model.raft, carry["last_H3"].to(cdt), carry["last_s3"].to(cdt), L2,
            of_scale=of_scale, raft_iters=raft_iters,
        )
        new = is_new_seq.to(device=w6.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
        w6 = torch.where(new, torch.zeros_like(w6), w6)

        s2 = model.enhance([w6, L2])
        H2 = torch.clamp(inp / s2, EPS, 1.0)
        # new-sequence quirk (model/model.py:330-332): warped previous := H2
        w6 = torch.where(new, torch.cat([H2, H2], dim=-1), w6).contiguous()
        H5 = model.denoise_2([w6, H2, s2], anchor=[H2, s2])

    H3 = H5[..., :3].float().contiguous()
    s3 = H5[..., 3:].float().contiguous()
    return (H2.float(), H3, s3), {"last_H3": H3, "last_s3": s3}
