"""A plain 3x3 convolution with bf16 operands: K1 without an epilogue.

Replaces the Pallas kernel ``zero_tig_tpu/ops/pallas_conv.py::conv3x3_bf16``
(:73-144, ``pallas_call`` at :125), which no path of either package runs:

    y = conv3x3(x, w) + b     stride 1, same zero padding, NHWC / HWIO,
                              bf16 operands, f32 sums, one cast to out_dtype

On the card it is one launch of K1's tensor-core kernel
(``csrc/fused_conv_mma.cu``) with act "none", scale 1 and shift b; K1's
weight layout (kh, kw, Cin, Cout) is already HWIO, and where Cin is a
multiple of 16 and Cout of 8 its packed form is the same memory. The TPU
kernel's three pre-shifted strips, tap groups of at most 128 lanes and its
W % 8 rule answer TPU limits and are not carried over. What bounds it on the H100, and what K1's design does about that, is
in the kernel's source note.
"""

from __future__ import annotations

import torch

from ..core import spans
from .fused_conv import ConvWeights, conv_weights, fused_conv_reference, launch_k1

BF16 = torch.bfloat16


def _weights(w: torch.Tensor, b: torch.Tensor | None) -> ConvWeights:
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3_bf16 takes (3, 3, Cin, Cout) weights, got {tuple(w.shape)}")
    cout = w.shape[-1]
    shift = torch.zeros(cout, device=w.device) if b is None else b.float().contiguous()
    return conv_weights(w.to(BF16), torch.ones(cout, device=w.device), shift)


def conv3x3_bf16_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *, out_dtype: torch.dtype = BF16
) -> torch.Tensor:
    """Plain PyTorch twin: K1's twin with the same operands."""
    return fused_conv_reference([x.to(BF16)], _weights(w, b), out_dtype=out_dtype)


def conv3x3_bf16(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *, out_dtype: torch.dtype = BF16
) -> torch.Tensor:
    """y = conv3x3(x, w) + b on (B, H, W, Cin) ``x`` and (3, 3, Cin, Cout)
    ``w``; (B, H, W, Cout) in ``out_dtype`` (bf16 or f32). ``x`` and ``w``
    are cast to bf16 and ``b`` to f32, as the JAX function does. CPU tensors
    run the twin; CUDA tensors launch K1 once, or raise."""
    if x.device.type == "cpu":
        return conv3x3_bf16_reference(x, w, b, out_dtype=out_dtype)
    out = launch_k1([x.to(BF16)], _weights(w, b), out_dtype=out_dtype)
    spans.COUNTS["conv3x3_bf16"] += 1
    return out
