"""Plain PyTorch operations of the Zero-TIG reference, on NCHW float32.

Each follows the published definition it names; nothing here is shared with
the program under test. ``Rounding`` emulates a lower operand precision for
the check's control: a convolution or matrix product then reads operands
rounded to TF32 (10 mantissa bits) or float8 e4m3 and sums in float32, as
tensor cores do, and its gradient is rounded likewise.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-4


def _round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Round f32 to ``bits`` explicit mantissa bits, to nearest even."""
    shift = 23 - bits
    i = t.contiguous().view(torch.int32)
    bias = ((i >> shift) & 1) + (1 << (shift - 1)) - 1
    return ((i + bias) & ~((1 << shift) - 1)).view(torch.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


ROUNDERS = {
    "f32": None,
    "tf32": lambda t: _round_mantissa(t, 10),
    "fp8": _fp8,
}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Rounding:
    """The operand precision of convolutions and matrix products."""

    def __init__(self, operands: str = "f32"):
        if operands not in ROUNDERS:
            raise ValueError(f"operands must be one of {sorted(ROUNDERS)}, not {operands!r}")
        self.fn = ROUNDERS[operands]

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.fn is None else _Round.apply(t, self.fn)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and cuBLAS inside the block; restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi); at a tie the gradient splits between the branches."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def resize(x: torch.Tensor, size: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def pad8(x: torch.Tensor) -> torch.Tensor:
    """RAFT's InputPadder: replicate padding to multiples of 8, centred."""
    h, w = x.shape[-2:]
    ph, pw = (((h // 8) + 1) * 8 - h) % 8, (((w // 8) + 1) * 8 - w) % 8
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), mode="replicate")


def equalize(u8: torch.Tensor) -> torch.Tensor:
    """torchvision's ``equalize`` of each (image, channel) of a (B, C, H, W)
    uint8 tensor: the LUT (cumsum + step // 2) // step, shifted by one bin,
    with step = (N - count of the highest non-empty bin) // 255; unchanged
    where step is 0."""
    b, c, h, w = u8.shape
    flat = u8.reshape(b * c, h * w).long()
    out = torch.empty_like(flat)
    for i in range(b * c):
        hist = torch.bincount(flat[i], minlength=256)
        last = int(torch.nonzero(hist).max())
        step = (h * w - int(hist[last])) // 255
        if step == 0:
            out[i] = flat[i]
            continue
        lut = torch.div(torch.cumsum(hist, 0) + step // 2, step, rounding_mode="floor")
        lut = torch.cat([lut.new_zeros(1), lut[:-1]]).clamp(0, 255)
        out[i] = lut[flat[i]]
    return out.reshape(b, c, h, w).to(torch.uint8)


def equalize01(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``equalize((x * 255).to(torch.uint8)).float()``."""
    return equalize(torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)).float()


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """(B, 2, H, W) pixel coordinates, channel 0 x and channel 1 y."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys]).expand(b, 2, h, w)


def warp(flow: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Backward warp of ``img`` (B, C, H, W) by ``flow`` (B, 2, Hf, Wf), the
    Zero-TIG warp with its quirk: the x map is scaled by H / Hf and the y
    map by W / Wf, resized bilinearly to (H, W), then sampled bilinearly
    with zero padding (``grid_sample``, align_corners False)."""
    b, _, hf, wf = flow.shape
    h, w = img.shape[-2:]
    base = coords_grid(b, hf, wf, flow.device)
    maps = torch.stack([(base[:, 0] - flow[:, 0]) * (h / hf), (base[:, 1] - flow[:, 1]) * (w / wf)], 1)
    maps = resize(maps, (h, w))
    grid = torch.stack([maps[:, 0] / ((w - 1) / 2.0) - 1.0, maps[:, 1] / ((h - 1) / 2.0) - 1.0], -1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def bilinear_zero(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Sample ``field`` (Q, h*w) at pixel coordinates x, y (Q, ...), each of
    the four neighbours outside the field weighing zero (RAFT's
    ``bilinear_sampler``: ``grid_sample`` with align_corners True)."""
    x0, y0 = torch.floor(x), torch.floor(y)
    out = torch.zeros_like(x)
    q = field.shape[0]
    for xi, wx in ((x0, 1.0 - (x - x0)), (x0 + 1.0, x - x0)):
        for yi, wy in ((y0, 1.0 - (y - y0)), (y0 + 1.0, y - y0)):
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(q, -1)
            vals = torch.gather(field, 1, idx).reshape(x.shape)
            out = out + torch.where(inside, vals * wx * wy, torch.zeros_like(vals))
    return out


def pair_downsampler(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbor2Neighbor's two diagonal half-resolution images (utils.py:15-24)."""
    c = x.shape[1]
    f1 = x.new_tensor([[[[0, 0.5], [0.5, 0]]]]).repeat(c, 1, 1, 1)
    f2 = x.new_tensor([[[[0.5, 0], [0, 0.5]]]]).repeat(c, 1, 1, 1)
    return F.conv2d(x, f1, stride=2, groups=c), F.conv2d(x, f2, stride=2, groups=c)


def gauss_kernel(kernlen: int = 21, nsig: float = 1.0) -> np.ndarray:
    """utils.py:29-39: sqrt(outer(k1d, k1d)) normalised, k1d the differences
    of the normal CDF over kernlen + 1 points."""
    interval = (2 * nsig + 1.0) / kernlen
    x = np.linspace(-nsig - interval / 2.0, nsig + interval / 2.0, kernlen + 1)
    cdf = np.array([0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in x])
    k = np.sqrt(np.outer(np.diff(cdf), np.diff(cdf)))
    return (k / k.sum()).astype(np.float32)


def blur(x: torch.Tensor) -> torch.Tensor:
    """21x21 Gaussian (nsig 1), reflect padding 10, per channel (utils.py:52-58)."""
    c = x.shape[1]
    k = torch.as_tensor(gauss_kernel(), device=x.device)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(F.pad(x, (10, 10, 10, 10), mode="reflect"), k, groups=c)


def local_mean(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    p = k // 2
    return F.avg_pool2d(F.pad(x, (p, p, p, p), mode="reflect"), k, stride=1)


def local_stddev(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    p = k // 2
    xp = F.pad(x, (p, p, p, p), mode="reflect")
    m = F.avg_pool2d(xp, k, stride=1)
    return torch.sqrt(torch.clamp(F.avg_pool2d(xp * xp, k, stride=1) - m * m, min=0.0) + 1e-9)


def local_variance(x: torch.Tensor) -> torch.Tensor:
    """utils.py:66-79: the zero-padded 5x5 mean of (x - its zero-padded 5x5 mean)^2."""
    mean = F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)
    return F.avg_pool2d((x - mean) ** 2, 5, stride=1, padding=2, count_include_pad=True)


def texture_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """loss.py:99-136: 1 where the local texture of the two grey images agrees."""
    def gray(im):
        return 0.144 * im[:, 0:1] + 0.587 * im[:, 1:2] + 0.299 * im[:, 2:3]

    with torch.no_grad():
        s1, s2 = local_stddev(gray(a)), local_stddev(gray(b))
        return ((2.0 * s1 * s2) / (s1 * s1 + s2 * s2 + 1e-5) > 0.975).float()
