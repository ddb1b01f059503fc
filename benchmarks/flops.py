"""Zero-TIG's model FLOP a frame (inference) and a step (training), counted
from each layer's shapes: 2 x output pixels x taps x Cin x Cout for every
convolution, and 2 x pixels^2 x 256 for RAFT's correlation volume. The
bilinear lookups, the convex upsample, the warp, the norms, activations and
the loss's window filters are left out (under 1% of a frame).

Training: the gradient-carrying convolutions count three times (forward,
weight gradient, input gradient), except the input gradient of a first
layer whose input carries none (Denoise_1's conv1, the Enhancer's in_conv);
Denoise_1 and Denoise_2 run at the frame's resolution and twice at half of
it; RAFT runs forward only, with no gradient.
"""

from __future__ import annotations

from roofline import raft_grid


def conv(h: int, w: int, k: tuple[int, int], cin: int, cout: int) -> float:
    return 2.0 * h * w * k[0] * k[1] * cin * cout


def denoise(h: int, w: int, cin: int, cout: int) -> list[tuple[float, bool]]:
    """(FLOP, has an input gradient) of each conv of a denoiser."""
    return [(conv(h, w, (3, 3), cin, 48), cin == 12), (conv(h, w, (3, 3), 48, 48), True),
            (conv(h, w, (1, 1), 48, cout), True)]


def enhancer(h: int, w: int) -> list[tuple[float, bool]]:
    return [(conv(h, w, (3, 3), 9, 64), False)] + [(conv(h, w, (3, 3), 64, 64), True)] * 3 + [
        (conv(h, w, (3, 3), 64, 3), True)]


def encoder(h: int, w: int, out_dim: int) -> float:
    """One image of RAFT's feature or context encoder, h x w the padded input."""
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    f = conv(h2, w2, (7, 7), 3, 64) + 4 * conv(h2, w2, (3, 3), 64, 64)
    f += conv(h4, w4, (3, 3), 64, 96) + 3 * conv(h4, w4, (3, 3), 96, 96) + conv(h4, w4, (1, 1), 64, 96)
    f += conv(h8, w8, (3, 3), 96, 128) + 3 * conv(h8, w8, (3, 3), 128, 128) + conv(h8, w8, (1, 1), 96, 128)
    return f + conv(h8, w8, (1, 1), 128, out_dim)


def raft(cfg: dict) -> float:
    gh, gw = raft_grid(cfg)
    f = 3 * encoder(8 * gh, 8 * gw, 256)  # the feature net on both images, the context net on one
    f += 2.0 * (gh * gw) ** 2 * 256
    it = (conv(gh, gw, (1, 1), 324, 256) + conv(gh, gw, (3, 3), 256, 192) + conv(gh, gw, (7, 7), 2, 128)
          + conv(gh, gw, (3, 3), 128, 64) + conv(gh, gw, (3, 3), 256, 126)
          + 2 * (conv(gh, gw, (1, 5), 384, 256) + conv(gh, gw, (1, 5), 384, 128))
          + conv(gh, gw, (3, 3), 128, 256) + conv(gh, gw, (3, 3), 256, 2))
    return f + cfg["raft_iters"] * it + conv(gh, gw, (3, 3), 128, 256) + conv(gh, gw, (1, 1), 256, 576)


def infer_frame(cfg: dict) -> float:
    h, w = cfg["frame_height"], cfg["frame_width"]
    e = cfg.get("enh_scale", 1)
    eh, ew = (h // e, w // e) if e > 1 and h % e == 0 and w % e == 0 else (h, w)
    convs = denoise(h, w, 3, 3) + enhancer(eh, ew) + denoise(h, w, 12, 6)
    return sum(f for f, _ in convs) + raft(cfg)


def train_step(cfg: dict) -> float:
    h, w = cfg["frame_height"], cfg["frame_width"]
    hh, hw = h // 2, w // 2
    convs = (denoise(h, w, 3, 3) + 2 * denoise(hh, hw, 3, 3) + enhancer(h, w)
             + denoise(h, w, 12, 6) + 2 * denoise(hh, hw, 12, 6))
    return sum(f * (3 if grad_in else 2) for f, grad_in in convs) + raft(cfg)
