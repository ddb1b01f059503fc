"""Device choice for the port's entry points: the card unless asked."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card, and raises where there is none; the CPU
    runs only when a caller names it (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: zero_tig_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions of the kernels"
            )
        return torch.device("cuda")
    return torch.device(device)
