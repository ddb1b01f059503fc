"""Full training-state checkpoints, for resume.

Port of ``zero_tig_tpu/core/train_ckpt.py`` (:20-80). The reference saves
only the weights per epoch (utils/utils.py:94-95); this saves the whole
``TrainState``: the model's parameters and buffers (the Enhancer's running
statistics among them), the Adam moments ``mu`` / ``nu`` keyed by parameter
name and its step ``count``, and the recurrent carry. The file is written
to ``<path>.tmp`` and moved into place, so a reader never sees half of one,
with the progress metadata in a ``<path>.meta.json`` sidecar. The format is
``torch.save`` of tensors, read back with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from ..pipeline.steps import TrainState


def _param_names(state: TrainState) -> list[str]:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


def save_train_state(path: str, state: TrainState, *, epoch: int, step: int, extra: dict | None = None) -> None:
    """Write ``state`` and its metadata ({epoch, step, **extra})."""
    opt = state.optimizer
    names = _param_names(state)
    payload = {
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "mu": {n: t.detach().cpu() for n, t in zip(names, opt.mu)},
        "nu": {n: t.detach().cpu() for n, t in zip(names, opt.nu)},
        "count": opt.count,
        "carry": {k: torch.as_tensor(v).detach().cpu() for k, v in state.carry.items()},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": epoch, "step": step, **(extra or {})}, f)


def restore_train_state(path: str, template: TrainState) -> tuple[TrainState, dict]:
    """Load a state written by ``save_train_state`` into ``template`` (a
    ``pipeline.steps.init_train_state`` of the same config and frame shape),
    in place: (state, metadata)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model, opt = template.model, template.optimizer
    with torch.no_grad():
        model.load_state_dict(payload["model"])
        for n, mu, nu in zip(_param_names(template), opt.mu, opt.nu):
            mu.copy_(payload["mu"][n])
            nu.copy_(payload["nu"][n])
        model.prepare()  # the kernels' weight operands (RAFT's among them) from the loaded weights
    opt.count = int(payload["count"])
    carry = {k: v.to(model.device) for k, v in payload["carry"].items()}
    meta: dict[str, Any] = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return TrainState(model, opt, carry), meta


def latest_checkpoint(ckpt_dir: str, prefix: str = "state_") -> str | None:
    """The ``<prefix><epoch>.pt`` of the highest epoch in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir) if f.startswith(prefix) and f.endswith(".pt")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix):-len(".pt")]))
    return os.path.join(ckpt_dir, cands[-1])
