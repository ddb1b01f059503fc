"""Supervised flow-model training: the sidecar's RAFT recipe.

Port of ``zero_tig_tpu/flowtools/train.py`` (:28-169; reference
ptlflow_scripts/train.py): the exponentially weighted sequence loss over
every prediction (gamma 0.8), AdamW with a one-cycle learning rate and
global-norm clipping. Optax is not on the card's machine, so its pieces
are written out here with optax's semantics:

  * ``linear_onecycle_schedule`` is evaluated at the update count BEFORE
    the update, with its breakpoints at ``int(pct_start*T)`` and
    ``int(pct_final*T)`` (``torch.optim.lr_scheduler.OneCycleLR`` ends its
    phases a step earlier);
  * the clip scales by ``max/norm`` only when the norm is not below ``max``
    (``clip_grad_norm_`` divides by ``norm + 1e-6``);
  * AdamW: eps 1e-8, bias-corrected moments, the weight decay added to the
    update of every parameter and scaled by the learning rate with it.

The prediction sequence comes from a registry model's ``predictions_fn``
(RAFT by default), on the plain modules under autograd: no hand kernel
has a backward, and none runs here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.precision import numerics
from .registry import get_flow_model


def sequence_loss(
    flow_preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    gamma: float = 0.8,
    max_flow: float = 400.0,
) -> torch.Tensor:
    """RAFT's sequence loss: sum_i gamma^(N-i-1) * mean over valid pixels of
    the L1 flow error. flow_preds (N, B, H, W, 2); flow_gt (B, H, W, 2);
    valid (B, H, W) or None; pixels with |gt| >= max_flow are left out and
    the mean divides by max(count, 1)."""
    n = flow_preds.shape[0]
    gt = flow_gt.float()
    mag = torch.sqrt(torch.sum(gt**2, dim=-1))
    v = torch.ones_like(mag) if valid is None else valid.float()
    v = v * (mag < max_flow).float()
    denom = torch.clamp(torch.sum(v), min=1.0)
    loss = gt.new_zeros(())
    for i in range(n):
        w = float(np.float32(gamma) ** np.float32(n - i - 1))
        l1 = torch.sum(torch.abs(flow_preds[i].float() - gt), dim=-1)
        loss = loss + w * torch.sum(v * l1) / denom
    return loss


def linear_onecycle_schedule(
    transition_steps: int,
    peak_value: float,
    pct_start: float = 0.3,
    pct_final: float = 0.85,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
):
    """optax's ``linear_onecycle_schedule``: count -> learning rate (f32),
    linear between the values at step 0 (peak/div), ``int(pct_start*T)``
    (peak), ``int(pct_final*T)`` (peak/div) and T (peak/div/final_div) and
    flat after T. A breakpoint on the step of a later one gives way to it,
    as in optax's dict of breakpoints: with pct_final 1.0 (the sidecar's)
    the schedule falls from the peak straight to peak/final_div at T. An
    empty interval (pct_start*T < 1) is skipped, where optax gives NaN."""
    marks = {int(pct_start * transition_steps): div_factor, int(pct_final * transition_steps): 1.0 / div_factor}
    marks[transition_steps] = 1.0 / final_div_factor
    bounds, scales = zip(*sorted(marks.items()))
    bounds = (0,) + bounds
    values = np.cumprod((peak_value / div_factor,) + scales)

    def schedule(count: int) -> float:
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = np.float32(count - bounds[i]) / np.float32(bounds[i + 1] - bounds[i])
                return float(np.float32(values[i + 1] - values[i]) * pct + np.float32(values[i]))
        return float(np.float32(values[-1]))

    return schedule


@dataclass
class AdamWState:
    """Moments by parameter, in ``model.parameters()`` order, and the update
    count; an update moves all three in place."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0


class FlowOptimizer:
    """``optax.chain(clip_by_global_norm(clip), adamw(linear_onecycle_schedule(
    total_steps, lr, pct_start, pct_final=1.0, div 25, final div 1e4),
    weight_decay, eps=1e-8))`` on a list of parameters."""

    def __init__(self, *, lr: float = 4e-4, total_steps: int = 100_000, weight_decay: float = 1e-4,
                 clip: float = 1.0, pct_start: float = 0.05, b1: float = 0.9, b2: float = 0.999):
        self.schedule = linear_onecycle_schedule(
            total_steps, lr, pct_start=pct_start, pct_final=1.0, div_factor=25.0, final_div_factor=1e4
        )
        self.weight_decay, self.clip, self.b1, self.b2 = weight_decay, clip, b1, b2

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        return AdamWState([torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: AdamWState) -> None:
        """One step on ``params`` in place; ``state`` moves with it."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clipped = ~(norm < self.clip)
        lr = self.schedule(state.count)
        state.count += 1
        t = state.count
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(t))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(clipped, g / norm * self.clip, g)
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) + self.weight_decay * p
            p.add_(-lr * u)


def make_flow_optimizer(
    *, lr: float = 4e-4, total_steps: int = 100_000, weight_decay: float = 1e-4, clip: float = 1.0,
    pct_start: float = 0.05,
) -> FlowOptimizer:
    """AdamW + one-cycle schedule + clip (the published RAFT recipe)."""
    return FlowOptimizer(lr=lr, total_steps=total_steps, weight_decay=weight_decay, clip=clip, pct_start=pct_start)


class FlowTrainState(NamedTuple):
    """``model`` holds the parameters (a step writes them in place; a
    BatchNorm keeps its running statistics), ``opt_state`` the AdamW
    moments and count, ``step`` the steps taken."""

    model: nn.Module
    opt_state: AdamWState
    step: int


def init_flow_train_state(
    model: nn.Module, *, lr: float = 4e-4, total_steps: int = 100_000
) -> FlowTrainState:
    opt = make_flow_optimizer(lr=lr, total_steps=total_steps)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    return FlowTrainState(model, opt.init(params), 0)


def flow_train_step(
    state: FlowTrainState,
    img1: torch.Tensor,
    img2: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    iters: int = 12,
    gamma: float = 0.8,
    lr: float = 4e-4,
    total_steps: int = 100_000,
    predictions_fn=None,
    precision: str = "highest",
) -> tuple[FlowTrainState, torch.Tensor]:
    """One supervised step. img1/img2 (B, H, W, 3) in [0, 255], flow_gt
    (B, H, W, 2), valid (B, H, W), on the model's device. predictions_fn:
    a registry ``predictions_fn``; None is RAFT's. The forward and the
    backward run in ``precision`` (TF32 off in "highest")."""
    if predictions_fn is None:
        predictions_fn = get_flow_model("raft").predictions_fn
    opt = make_flow_optimizer(lr=lr, total_steps=total_steps)
    params = list(state.model.parameters())
    with numerics(precision):
        preds = predictions_fn(state.model, img1, img2, iters, precision)
        loss = sequence_loss(preds, flow_gt, valid, gamma=gamma)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    opt.update(params, grads, state.opt_state)
    return FlowTrainState(state.model, state.opt_state, state.step + 1), loss.detach()


def train_flow_model(
    flow_model: nn.Module,
    batches: Iterable[tuple],
    *,
    iters: int = 12,
    lr: float = 4e-4,
    total_steps: int = 100_000,
    log_every: int = 100,
    model: str | None = None,
    precision: str = "highest",
) -> FlowTrainState:
    """Train ``flow_model`` on (img1, img2, flow_gt[, valid]) batches on its
    device. model: the registry name ('raft', 'raft_small', 'pwc_lite');
    None keeps RAFT's predictions."""
    predictions_fn = None
    if model is not None:
        fm = get_flow_model(model)
        if fm.predictions_fn is None:
            raise ValueError(f"flow model {model!r} is not trainable (no predictions_fn registered)")
        predictions_fn = fm.predictions_fn
    state = init_flow_train_state(flow_model, lr=lr, total_steps=total_steps)
    for i, batch in enumerate(batches):
        img1, img2, gt = batch[:3]
        valid = batch[3] if len(batch) > 3 else torch.ones(gt.shape[:-1], device=gt.device)
        state, loss = flow_train_step(
            state, img1, img2, gt, valid, iters=iters, lr=lr, total_steps=total_steps,
            predictions_fn=predictions_fn, precision=precision,
        )
        if i % log_every == 0:
            print(f"[flow-train] step {i} loss {float(loss):.4f}")
    return state
