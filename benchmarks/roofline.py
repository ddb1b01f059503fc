"""The H100's peaks and K1's roofline bound for one Zero-TIG frame.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989e12 FLOP/s bf16 on the tensor
cores, 67e12 FLOP/s f32 on the CUDA cores (TF32 and the tensor cores are not
used in the "highest" precision), 3.35e12 bytes/s of HBM3.

A K1 launch's bound is the larger of its FLOP at the peak of its operand
type and its bytes at the HBM rate, each input, anchor, weight and output
counted once (a residual is the launch's own input and adds nothing). The
frame's K1 launches: 11 at the frame's resolution (Denoise_1 3, the Enhancer
5 with its shared block 3 times, Denoise_2 3) and, on RAFT's 1/8 grid, 9
each refinement iteration and 2 for the mask head (121 at 12 iterations).
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def peak_flops(precision: str) -> float:
    return PEAK_BF16 if precision == "fast" else PEAK_F32


def operand_bytes(precision: str) -> int:
    return 2 if precision == "fast" else 4


def raft_grid(cfg: dict) -> tuple[int, int]:
    """RAFT's update grid: the frame at 1/of_scale, padded to multiples of 8, over 8."""
    h, w = cfg["frame_height"] // cfg["of_scale"], cfg["frame_width"] // cfg["of_scale"]
    return -(-h // 8), -(-w // 8)


def k1_layers(cfg: dict) -> list[tuple]:
    """(name, kh, kw, input parts, Cout, (h, w), anchor parts, f32 output, launches a frame)."""
    full = (cfg["frame_height"], cfg["frame_width"])
    e = cfg.get("enh_scale", 1)
    enh = (full[0] // e, full[1] // e) if e > 1 and full[0] % e == 0 and full[1] % e == 0 else full
    g, it = raft_grid(cfg), cfg["raft_iters"]
    return [
        ("d1.conv1", 3, 3, [3], 48, full, [], False, 1),
        ("d1.conv2", 3, 3, [48], 48, full, [], False, 1),
        ("d1.conv3+anchor", 1, 1, [48], 3, full, [3], False, 1),
        ("enh.in_conv", 3, 3, [6, 3], 64, enh, [], False, 1),
        ("enh.block+res", 3, 3, [64], 64, enh, [], False, 3),
        ("enh.out_conv", 3, 3, [64], 3, enh, [], False, 1),
        ("d2.conv1", 3, 3, [6, 3, 3], 48, full, [], False, 1),
        ("d2.conv2", 3, 3, [48], 48, full, [], False, 1),
        ("d2.conv3+anchor", 1, 1, [48], 6, full, [3, 3], False, 1),
        ("raft.convc1", 1, 1, [324], 256, g, [], False, it),
        ("raft.convc2", 3, 3, [256], 192, g, [], False, it),
        ("raft.conv", 3, 3, [192, 64], 126, g, [], False, it),
        ("raft.gru.zr1", 1, 5, [128, 128, 126, 2], 256, g, [], True, it),
        ("raft.gru.q1", 1, 5, [128, 128, 126, 2], 128, g, [], True, it),
        ("raft.gru.zr2", 5, 1, [128, 128, 126, 2], 256, g, [], True, it),
        ("raft.gru.q2", 5, 1, [128, 128, 126, 2], 128, g, [], True, it),
        ("raft.fh1", 3, 3, [128], 256, g, [], False, it),
        ("raft.fh2", 3, 3, [256], 2, g, [], True, it),
        ("raft.mask0", 3, 3, [128], 256, g, [], False, 1),
        ("raft.mask2", 1, 1, [256], 576, g, [], False, 1),
    ]


def k1_bound_ms(layer: tuple, precision: str) -> float:
    """The least time of one launch of ``layer`` at the peaks, in ms."""
    _, kh, kw, parts, cout, (h, w), anchor, out_f32, _ = layer
    esz, cin = operand_bytes(precision), sum(parts)
    flops = 2.0 * h * w * cin * cout * kh * kw
    nbytes = h * w * (cin + sum(anchor)) * esz + kh * kw * cin * cout * esz + h * w * cout * (4 if out_f32 else esz)
    return max(flops / peak_flops(precision), nbytes / PEAK_BYTES) * 1e3


def k1_frame_bound_ms(cfg: dict) -> float:
    """The sum of a frame's K1 launch bounds, in ms."""
    return sum(k1_bound_ms(layer, cfg["precision"]) * layer[-1] for layer in k1_layers(cfg))


def k1_launches_per_frame(cfg: dict) -> int:
    return sum(layer[-1] for layer in k1_layers(cfg))
