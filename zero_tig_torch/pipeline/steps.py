"""Streaming inference entry points: ``predict_step`` and ``predict_chunk``.

Port of ``zero_tig_tpu/pipeline/steps.py::predict_step`` (:245) and
``predict_chunk`` (:276). PyTorch runs eagerly, so a chunk is a Python loop
over its frames; ``emit="u8"`` quantises H2 and H3 on the device with the
reference's PNG formula and drops s3 from the output (it lives on in the
carry). Frames may be uint8 (divided by 255 here) or float in [0, 1]; they
run on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.network import ZeroTIG, forward_inference


def _norm_frames(frames, device: torch.device) -> torch.Tensor:
    t = (frames if torch.is_tensor(frames) else torch.as_tensor(np.asarray(frames))).to(device)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()


def _carry_on(carry: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32) for k, v in carry.items()}


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """clip(x*255, 0, 255) truncated to uint8 (train.py:58-62)."""
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def init_carry(model: ZeroTIG, frame_shape: tuple[int, int, int, int]) -> dict:
    zeros = torch.zeros(frame_shape, dtype=torch.float32, device=model.device)
    return {"last_H3": zeros, "last_s3": zeros.clone()}


@torch.inference_mode()
def predict_step(
    model: ZeroTIG,
    frame,
    carry: dict,
    is_new_seq,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], dict]:
    """One frame (B, H, W, 3): ((H2, H3, s3), new_carry)."""
    dev = model.device
    return forward_inference(
        model, _norm_frames(frame, dev), _carry_on(carry, dev), torch.as_tensor(is_new_seq, device=dev),
        of_scale=of_scale, raft_iters=raft_iters,
    )


@torch.inference_mode()
def predict_chunk(
    model: ZeroTIG,
    frames,
    carry: dict,
    is_new_seq,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
    emit: str = "f32",
):
    """K frames (K, B, H, W, 3); is_new_seq (K,) or (K, B).

    emit="f32": ((H2s, H3s, s3s) each (K, B, H, W, 3) f32, final_carry).
    emit="u8":  ((H2s_u8, H3s_u8), final_carry)."""
    if emit not in ("f32", "u8"):
        raise ValueError(f"emit must be 'f32' or 'u8', not {emit!r}")
    dev = model.device
    frames = _norm_frames(frames, dev)
    flags = torch.as_tensor(is_new_seq, device=dev)
    carry = _carry_on(carry, dev)
    outs = []
    for k in range(frames.shape[0]):
        (H2, H3, s3), carry = forward_inference(
            model, frames[k], carry, flags[k], of_scale=of_scale, raft_iters=raft_iters,
        )
        outs.append((_quantize_u8(H2), _quantize_u8(H3)) if emit == "u8" else (H2, H3, s3))
    return tuple(torch.stack(s) for s in zip(*outs)), carry
