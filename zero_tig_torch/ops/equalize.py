"""K3: histogram equalisation (``csrc/equalize.cu``): ``equalize_u8`` and
``equalize01``.

Replaces the Pallas kernel ``zero_tig_tpu/ops/pallas_equalize.py::
equalize_uint8_pallas``, which computes exactly
``zero_tig_tpu/ops/equalize.py::equalize_uint8``: torchvision's
``equalize`` on each (image, channel) of a (B, H, W, C) uint8 tensor.

    hist   = 256-bin histogram;  last = highest non-empty bin
    step   = (N - hist[last]) // 255
    lut[0] = 0;  lut[i] = clip((cumsum(hist)[i-1] + step // 2) // step, 0, 255)
    out    = lut[x], or x where step == 0

``equalize01`` is the same kernel with the casts of
``zero_tig_tpu/ops/equalize.py::equalize01`` inside it: float in, the
truncating uint8 cast, the equalise, f32 out, in one launch.

Each entry launches the kernel for a CUDA tensor and runs its plain twin
(``equalize_u8_reference``, ``equalize01_reference``) for a CPU tensor.
Both are exact.
"""

from __future__ import annotations

import torch

from ..core import spans
from ..kernels import build

# the C entry's kind for each (input, output) dtype
_KINDS = {
    (torch.uint8, torch.uint8): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


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


def equalize01_reference(x: torch.Tensor) -> torch.Tensor:
    """As the reference's ``equalize((x * 255).to(torch.uint8)).float()``:
    the product is rounded in x's dtype (bf16 in fast mode) and the uint8
    cast truncates toward zero (zero_tig_tpu/ops/equalize.py:76)."""
    u8 = torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8).contiguous()
    return equalize_u8_reference(u8).float()


def _launch(x: torch.Tensor, out_dtype: torch.dtype, name: str) -> torch.Tensor:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    if not 1 <= c <= 32:
        raise ValueError(f"{name} takes 1-32 channels, got {c}")
    if x.numel() == 0 or h * w * c >= 2**31:
        raise ValueError(f"{name} takes 1 to 2**31 - 1 elements per image, got {h * w * c}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    # the kernel zeroes its counts itself: no fill on the device here
    counts = torch.empty(b * c * 256, dtype=torch.int32, device=x.device)
    lib = build.library()
    code = lib.zt_equalize(
        x.data_ptr(), out.data_ptr(), counts.data_ptr(), b, h * w, c,
        _KINDS[x.dtype, out_dtype], build.stream_handle(x.device),
    )
    # 82, cudaErrorCooperativeLaunchTooLarge: more images than resident blocks
    build.check(code, name)
    spans.COUNTS["equalize_u8"] += 1
    return out


def equalize_u8(img: torch.Tensor) -> torch.Tensor:
    """Equalise each (image, channel) of a (B, H, W, C) uint8 tensor."""
    if img.device.type == "cpu":
        return equalize_u8_reference(img)
    if img.dtype != torch.uint8:
        raise ValueError(f"equalize_u8 takes uint8, not {img.dtype}")
    return _launch(img, torch.uint8, "equalize_u8")


def equalize01(x: torch.Tensor) -> torch.Tensor:
    """Equalise a (B, H, W, C) [0, 1] float image (f32 or bf16); returns f32
    in [0, 255], as ``equalize01_reference``."""
    if x.device.type == "cpu":
        return equalize01_reference(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"equalize01 takes f32 or bf16, not {x.dtype}")
    return _launch(x, torch.float32, "equalize01")
