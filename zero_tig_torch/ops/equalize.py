"""K3: uint8 histogram equalisation (``csrc/equalize.cu``) and ``equalize01``.

Replaces the Pallas kernel ``zero_tig_tpu/ops/pallas_equalize.py::
equalize_uint8_pallas``, which computes exactly
``zero_tig_tpu/ops/equalize.py::equalize_uint8``: torchvision's
``equalize`` on each (image, channel) of a (B, H, W, C) uint8 tensor.

    hist   = 256-bin histogram;  last = highest non-empty bin
    step   = (N - hist[last]) // 255
    lut[0] = 0;  lut[i] = clip((cumsum(hist)[i-1] + step // 2) // step, 0, 255)
    out    = lut[x], or x where step == 0

``equalize_u8`` launches the kernel for a CUDA tensor and runs
``equalize_u8_reference``, its plain twin, for a CPU tensor. Both are exact.
"""

from __future__ import annotations

import torch

from ..kernels import build


def equalize_u8_reference(img: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    n = h * w
    x = img.permute(0, 3, 1, 2).reshape(b * c, n).long()
    hist = torch.zeros(b * c, 256, dtype=torch.long, device=img.device)
    hist.scatter_add_(1, x, torch.ones_like(x))
    bins = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, bins, -1).amax(dim=1, keepdim=True)
    step = (n - hist.gather(1, last)) // 255
    cum = hist.cumsum(dim=1)
    lut = (cum + step // 2) // step.clamp(min=1)
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=1).clamp(0, 255)
    lut = torch.where(step == 0, bins, lut)
    out = lut.gather(1, x).to(torch.uint8)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()


def equalize_u8(img: torch.Tensor) -> torch.Tensor:
    """Equalise each (image, channel) of a (B, H, W, C) uint8 tensor."""
    if img.device.type == "cpu":
        return equalize_u8_reference(img)
    if img.dtype != torch.uint8 or img.dim() != 4 or not img.is_contiguous():
        raise ValueError("equalize_u8 takes a contiguous (B, H, W, C) uint8 tensor")
    b, h, w, c = img.shape
    if not 1 <= c <= 32:
        raise ValueError(f"equalize_u8 takes 1-32 channels, got {c}")
    out = torch.empty_like(img)
    hist = torch.empty(b * c * 256, dtype=torch.int32, device=img.device)
    lib = build.library()
    code = lib.zt_equalize_u8(
        img.data_ptr(), out.data_ptr(), hist.data_ptr(), b, h * w, c,
        build.stream_handle(img.device),
    )
    build.check(code, "equalize_u8")
    build.COUNTS["equalize_u8"] += 1
    return out


def equalize01(x: torch.Tensor) -> torch.Tensor:
    """Equalise a [0, 1] float image; returns f32 in [0, 255].

    As the reference's ``equalize((x * 255).to(torch.uint8)).float()``: the
    scaling runs in x's dtype (bf16 in fast mode) and the uint8 cast
    truncates toward zero (zero_tig_tpu/ops/equalize.py:76)."""
    u8 = torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8).contiguous()
    return equalize_u8(u8).float()
