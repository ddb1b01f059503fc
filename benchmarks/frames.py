"""A seeded low-light video: a smooth texture moved by a known flow, dimmed
and noisy, as uint8 frames in host memory.

Frame k shows the texture at p - k * f(p), with the smooth flow
f = (1.5 + 0.5 sin(2 pi y / H), -0.75 + 0.5 cos(2 pi x / W)) pixels (about
1.7 px a frame), so consecutive frames are related by a motion RAFT can
follow. Three sinusoid gratings per channel, with phases from the seed, make
the texture; it is scaled into [0, 0.25) of the full range and Gaussian noise
of ``noise`` levels is added, as a dark scene from a small sensor looks.
Computed on ``device`` in float32, then copied to the host.
"""

from __future__ import annotations

import math

import torch


def make_video(seed: int, n: int, h: int, w: int, device, *, dim: float = 0.25, noise: float = 2.0) -> torch.Tensor:
    """(n, 1, h, w, 3) uint8 on the host."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    phases = torch.rand(3, 3, generator=gen, device=device) * (2 * math.pi)
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    fx = 1.5 + 0.5 * torch.sin(2 * math.pi * y / h)
    fy = -0.75 + 0.5 * torch.cos(2 * math.pi * x / w)
    out = torch.empty(n, 1, h, w, 3, dtype=torch.uint8)
    for k in range(n):
        xx, yy = x - k * fx, y - k * fy
        chans = [127 + 50 * torch.sin(xx / 5.3 + p[0]) * torch.cos(yy / 7.1 + p[1])
                 + 40 * torch.sin((xx + 2 * yy) / 11.7 + p[2]) + 20 * torch.sin((3 * xx - yy) / 23.0)
                 for p in phases]
        img = torch.stack(chans, -1).clamp(0, 255) * dim
        img = img + noise * torch.randn(img.shape, generator=gen, device=device)
        out[k, 0] = img.round().clamp(0, 255).to(torch.uint8).cpu()
    return out
