"""The entry points: streaming inference and zero-shot training.

Port of ``zero_tig_tpu/pipeline/steps.py``: ``predict_step`` (:245),
``predict_chunk`` (:276), and the training steps ``TrainState``,
``make_optimizer``, ``init_train_state`` (:30-60), ``train_step``
(:82-152), ``train_chunk`` (:410-448) and ``eval_forward_step`` (:451-470).
PyTorch runs eagerly, so a chunk is a Python loop over its frames;
``emit="u8"`` quantises H2 and H3 on the device with the reference's PNG
formula and drops s3 from the output (it lives on in the carry). Frames may
be uint8 (divided by 255 here) or float in [0, 1]; they run on the model's
device.

The optimizer is the JAX package's, in its order (train.py:98, :130): the
gradients are clipped to a global norm of 5.0, weight decay 3e-4 is added
to the gradient (L2 in the gradient, not AdamW), then Adam(1e-4, 0.9,
0.999, eps 1e-8) with bias correction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..core.precision import numerics
from ..losses.zero_tig_loss import zero_tig_loss
from ..models import build_model
from ..models.network import ZeroTIG, forward_inference, forward_train


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
    enh_scale: int = 1,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], dict]:
    """One frame (B, H, W, 3): ((H2, H3, s3), new_carry)."""
    dev = model.device
    return forward_inference(
        model, _norm_frames(frame, dev), _carry_on(carry, dev), torch.as_tensor(is_new_seq, device=dev),
        of_scale=of_scale, raft_iters=raft_iters, enh_scale=enh_scale,
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
    enh_scale: int = 1,
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
            enh_scale=enh_scale,
        )
        outs.append((_quantize_u8(H2), _quantize_u8(H3)) if emit == "u8" else (H2, H3, s3))
    return tuple(torch.stack(s) for s in zip(*outs)), carry


class Adam:
    """``optax.chain(clip_by_global_norm(grad_clip),
    add_decayed_weights(weight_decay), scale_by_adam(b1, b2, 1e-8),
    scale(-lr))`` on a list of parameters, written out with optax's
    formulas. The clip scales by grad_clip / norm only when norm >=
    grad_clip (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6)."""

    def __init__(self, params: list[torch.Tensor], config: Config):
        self.params = list(params)
        self.config = config
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        """Apply one update from the parameters' ``.grad`` and clear them."""
        c = self.config
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clipped = norm >= c.grad_clip
        self.count += 1
        bc1 = 1.0 - c.adam_beta1 ** self.count
        bc2 = 1.0 - c.adam_beta2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(clipped, g / norm * c.grad_clip, g) + c.weight_decay * p
            mu.copy_((1.0 - c.adam_beta1) * g + c.adam_beta1 * mu)
            nu.copy_((1.0 - c.adam_beta2) * (g * g) + c.adam_beta2 * nu)
            p.add_(-c.lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)))
            p.grad = None


def make_optimizer(config: Config, params: list[torch.Tensor]) -> Adam:
    return Adam(params, config)


class TrainState(NamedTuple):
    """The training state: ``model`` holds the parameters and the Enhancer's
    BatchNorm running statistics, ``optimizer`` the Adam moments, ``carry``
    the recurrent video state {'last_H3', 'last_s3'}. A step updates the
    model and the optimizer in place and returns a state with the new carry."""

    model: ZeroTIG
    optimizer: Adam
    carry: dict


def init_train_state(
    config: Config,
    state_dict: dict[str, torch.Tensor],
    frame_shape: tuple[int, int, int, int],
    device: str | torch.device | None = None,
) -> TrainState:
    """A model in ``config.precision`` with ``state_dict`` (reference key
    names) loaded on ``device`` (default: the CUDA card; raises without
    one), the Enhancer and both denoisers trainable, RAFT frozen, fresh Adam
    moments and a zero carry of ``frame_shape`` (B, H, W, 3)."""
    model = build_model(state_dict, device=resolve_device(device), precision=config.precision)
    params = model.trainable_parameters()
    for p in params:
        p.requires_grad_(True)
    return TrainState(model, make_optimizer(config, params), init_carry(model, frame_shape))


def train_step(
    state: TrainState,
    frame,
    is_new_seq,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
    is_wb: bool = False,
    bn_train: bool = True,
) -> tuple[TrainState, torch.Tensor]:
    """One zero-shot training frame (B, H, W, 3): (new_state, loss).

    bn_train: pass (epoch == 0) for the reference's BatchNorm schedule
    (train.py:115-138: only epoch 0 trains on batch statistics)."""
    model = state.model
    dev = model.device
    frame = _norm_frames(frame, dev)
    with numerics(model.precision):  # highest: TF32 off, backward included
        outputs, carry = forward_train(
            model, frame, _carry_on(state.carry, dev), torch.as_tensor(is_new_seq, device=dev),
            of_scale=of_scale, raft_iters=raft_iters, bn_train=bn_train,
        )
        loss = zero_tig_loss(frame, outputs, is_wb=is_wb)
        loss.backward()
        state.optimizer.step()
    model.prepared = False  # the kernels' weight operands are stale now
    return TrainState(model, state.optimizer, carry), loss.detach()


def train_chunk(
    state: TrainState,
    frames,
    is_new_seq,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
    is_wb: bool = False,
    bn_train: bool = True,
) -> tuple[TrainState, torch.Tensor]:
    """K sequential training frames (K, B, H, W, 3); is_new_seq (K,) or
    (K, B). Returns (final_state, (K,) losses), as K ``train_step`` calls."""
    flags = torch.as_tensor(is_new_seq)
    losses = []
    for k in range(len(frames)):
        state, loss = train_step(
            state, frames[k], flags[k], of_scale=of_scale, raft_iters=raft_iters,
            is_wb=is_wb, bn_train=bn_train,
        )
        losses.append(loss)
    return state, torch.stack(losses)


@torch.no_grad()
def eval_forward_step(
    model: ZeroTIG,
    frame,
    carry: dict,
    is_new_seq,
    *,
    of_scale: int = 3,
    raft_iters: int = 12,
) -> tuple[tuple[torch.Tensor, torch.Tensor], dict]:
    """The training model's eval forward (train.py:137-152 image dumps):
    BatchNorm on running statistics, nothing updated. ((H2, H3), new_carry)."""
    dev = model.device
    with numerics(model.precision):
        outputs, carry = forward_train(
            model, _norm_frames(frame, dev), _carry_on(carry, dev),
            torch.as_tensor(is_new_seq, device=dev),
            of_scale=of_scale, raft_iters=raft_iters, bn_train=False,
        )
    return (outputs.H2, outputs.H3), carry
