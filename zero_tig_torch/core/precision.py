"""The port's two precision modes.

  * "highest": f32 tensors and f32 arithmetic everywhere, held against the
    JAX package's ``set_precision("highest")``. PyTorch would otherwise run
    f32 convolutions on the card in TF32 (``torch.backends.cudnn.allow_tf32``
    is True by default), which keeps about three decimal digits; inside
    ``numerics("highest")`` TF32 is off for cuDNN and for matrix products.
  * "fast": bf16 operands and activations with f32 accumulation, as the JAX
    fast mode; outputs and the recurrent carry are f32.

The mode is a value that callers pass (``build_model(precision=...)``), not
process state: ``forward_inference`` sets the two TF32 switches for the
length of one highest-mode frame and restores them after it.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch

MODES = ("highest", "fast")


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown precision mode {mode!r}, expected one of {MODES}")
    return mode


def compute_dtype(mode: str) -> torch.dtype:
    """The dtype of activations and conv operands in ``mode``."""
    return torch.bfloat16 if check_mode(mode) == "fast" else torch.float32


@contextlib.contextmanager
def numerics(mode: str) -> Iterator[None]:
    """Within the block, PyTorch's float32 switches as ``mode`` needs them
    (TF32 off in "highest", untouched in "fast"); restored on exit."""
    if check_mode(mode) != "highest":
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
