"""K1: fused stride-1 same convolution with an epilogue, on NHWC tensors.

Replaces the four Pallas call sites of ``zero_tig_tpu/ops/pack_conv.py``
(``conv3x3_packed``, ``conv3x3_packed_multi``, ``residual1x1_packed``,
``residual1x1_packed_multi``) and runs every convolution of the RAFT update
core (``zero_tig_tpu/models/raft/update_kernel.py::update_core_kernel``).
The kernel is ``csrc/fused_conv.cu``; its source note says what bounds it on
the H100 and what its design does about that.

    out = act(conv(cat(inputs)) * scale + shift) [+ residual]
    out = clip(cat(anchor) - (conv(cat(inputs)) * scale + shift), lo, hi)

Operands are bf16 (fast mode) or f32 (highest mode); the sum and the
epilogue are f32; the output has the operand type unless ``out_dtype``
asks for f32. ``fused_conv`` launches the kernel for CUDA tensors and runs
``fused_conv_reference``, its plain PyTorch twin, for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..kernels import build

ACTS = {"none": 0, "relu": 1, "leaky": 2, "sigmoid": 3, "tanh": 4, "sigmoid_clip": 5}
BN_EPS = 1e-5


class ConvWeights(NamedTuple):
    """A convolution prepared for K1.

    w: (kh, kw, Cin, Cout) in the operand dtype, contiguous;
    scale, shift: (Cout,) f32 -- the bias, or a folded eval BatchNorm.
    """

    w: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor

    @property
    def padding(self) -> tuple[int, int]:
        return (self.w.shape[0] - 1) // 2, (self.w.shape[1] - 1) // 2


def prepare_conv(
    conv: torch.nn.Conv2d,
    dtype: torch.dtype,
    *,
    bn: torch.nn.BatchNorm2d | None = None,
    out_scale: float = 1.0,
) -> ConvWeights:
    """Turn an OIHW ``nn.Conv2d`` (and an eval BatchNorm after it) into K1's
    operands. ``out_scale`` multiplies the whole affine output (the RAFT
    mask head's 0.25)."""
    w = conv.weight.detach().float()
    cout = w.shape[0]
    bias = conv.bias.detach().float() if conv.bias is not None else w.new_zeros(cout)
    scale = torch.ones_like(bias)
    shift = bias
    if bn is not None:
        # eval BN folded as in zero_tig_tpu/models/fastpath.py:150-162
        inv = torch.rsqrt(bn.running_var.float() + BN_EPS)
        scale = bn.weight.detach().float() * inv
        shift = bn.bias.detach().float() + (bias - bn.running_mean.float()) * scale
    return ConvWeights(
        w.permute(2, 3, 1, 0).contiguous().to(dtype),
        (scale * out_scale).contiguous(),
        (shift * out_scale).contiguous(),
    )


def fused_conv_reference(
    inputs: Sequence[torch.Tensor],
    cw: ConvWeights,
    *,
    act: str = "none",
    residual: torch.Tensor | None = None,
    anchor: Sequence[torch.Tensor] = (),
    lo: float = 1e-4,
    hi: float = 1.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same roundings (operands as
    given, f32 sum and epilogue, one cast of the result)."""
    x = torch.cat([t.float() for t in inputs], dim=-1).permute(0, 3, 1, 2)
    w = cw.w.float().permute(3, 2, 0, 1)
    acc = F.conv2d(x, w, padding=cw.padding).permute(0, 2, 3, 1)
    v = acc * cw.scale + cw.shift
    if act == "relu":
        v = torch.relu(v)
    elif act == "leaky":
        v = torch.where(v >= 0, v, 0.2 * v)
    elif act == "sigmoid":
        v = torch.sigmoid(v)
    elif act == "tanh":
        v = torch.tanh(v)
    elif act == "sigmoid_clip":
        v = torch.clamp(torch.sigmoid(v), 1e-4, 1.0)
    if residual is not None:
        v = v + residual.float()
    if anchor:
        v = torch.clamp(torch.cat([a.float() for a in anchor], -1) - v, lo, hi)
    return v.to(out_dtype or inputs[0].dtype).contiguous()


def fused_conv(
    inputs: Sequence[torch.Tensor],
    cw: ConvWeights,
    *,
    act: str = "none",
    residual: torch.Tensor | None = None,
    anchor: Sequence[torch.Tensor] = (),
    lo: float = 1e-4,
    hi: float = 1.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K1 on (B, H, W, C_j) inputs whose channels concatenate to the conv's
    Cin. ``residual`` (B, H, W, Cout) is added after the activation;
    ``anchor`` (up to 2 parts, channels summing to Cout) switches to the
    ``clip(anchor - conv, lo, hi)`` epilogue."""
    if inputs[0].device.type == "cpu":
        return fused_conv_reference(
            inputs, cw, act=act, residual=residual, anchor=anchor,
            lo=lo, hi=hi, out_dtype=out_dtype,
        )
    out = launch_k1(inputs, cw, act=act, residual=residual, anchor=anchor, lo=lo, hi=hi, out_dtype=out_dtype)
    build.COUNTS["fused_conv"] += 1
    return out


def launch_k1(
    inputs: Sequence[torch.Tensor],
    cw: ConvWeights,
    *,
    act: str = "none",
    residual: torch.Tensor | None = None,
    anchor: Sequence[torch.Tensor] = (),
    lo: float = 1e-4,
    hi: float = 1.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Check the operands and launch K1 once on CUDA tensors (raises on what
    it cannot take). The wrappers ``fused_conv`` and ``conv3x3_bf16`` call
    it and count the launch under their own names."""
    inputs = list(inputs)
    anchor = list(anchor)
    x0 = inputs[0]
    dtype = x0.dtype
    kh, kw, cin, cout = cw.w.shape
    b, h, w = x0.shape[:3]
    if not 1 <= len(inputs) <= 4 or len(anchor) > 2:
        raise ValueError(f"K1 takes 1-4 inputs and 0-2 anchor parts, got {len(inputs)}, {len(anchor)}")
    if dtype not in (torch.float32, torch.bfloat16) or cw.w.dtype != dtype:
        raise ValueError(f"K1 operands must be f32 or bf16 and match the weights: {dtype}, {cw.w.dtype}")
    if act not in ACTS or (anchor and (act != "none" or residual is not None)):
        raise ValueError(f"unsupported epilogue act={act!r} anchor={bool(anchor)}")
    out_dtype = out_dtype or dtype
    if out_dtype not in (dtype, torch.float32):
        raise ValueError(f"K1 writes the operand dtype or f32, not {out_dtype}")
    for t in inputs + anchor + ([residual] if residual is not None else []):
        if t.device != x0.device or t.dtype != dtype or not t.is_contiguous() or t.shape[:3] != (b, h, w):
            raise ValueError("K1 tensors must be contiguous NHWC of one device, dtype and shape")
    if sum(t.shape[3] for t in inputs) != cin:
        raise ValueError(f"inputs carry {[t.shape[3] for t in inputs]} channels, weights take {cin}")
    if residual is not None and residual.shape[3] != cout:
        raise ValueError("residual must have Cout channels")
    if anchor and sum(a.shape[3] for a in anchor) != cout:
        raise ValueError("anchor parts must carry Cout channels")
    for t in (cw.w, cw.scale, cw.shift):
        if t.device != x0.device or not t.is_contiguous():
            raise ValueError("K1 weights must be contiguous on the inputs' device")

    lib = build.library()
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x0.device)
    ptrs = [t.data_ptr() for t in inputs] + [None] * (4 - len(inputs))
    chans = [t.shape[3] for t in inputs] + [0] * (4 - len(inputs))
    anc = [a.data_ptr() for a in anchor] + [None] * (2 - len(anchor))
    anc_c = [a.shape[3] for a in anchor] + [0] * (2 - len(anchor))
    code = lib.zt_fused_conv(
        *ptrs, *chans, len(inputs),
        cw.w.data_ptr(), cw.scale.data_ptr(), cw.shift.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        *anc, *anc_c, len(anchor),
        out.data_ptr(), b, h, w, cout, kh, kw, (kh - 1) // 2, (kw - 1) // 2,
        ACTS[act], lo, hi, int(dtype == torch.bfloat16), int(out_dtype == torch.float32),
        build.stream_handle(x0.device),
    )
    build.check(code, "fused_conv")
    return out
