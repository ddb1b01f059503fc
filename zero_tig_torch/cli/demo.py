"""Standalone RAFT flow demo: ``python -m zero_tig_torch.cli.demo --path FRAMES``.

Port of ``zero_tig_tpu/cli/demo.py`` (:25-84; the reference demo.py without
its hard-coded paths): RAFT from ``--model`` (a ``.pt`` with RAFT weights,
read by ``load_checkpoint``) or seeded random weights with a warning, flow
between consecutive frames resized to ``--width`` x ``--height``, the
forward timed up to a device sync, and per pair ``<stem>_flow.png`` (the
colour wheel) and ``<stem>_overlap.png`` (0.5 * the first frame warped by
the flow + 0.5 * the second) named by the second frame. Frames are read and
written with the port's codec and resized with ``F.interpolate``. Runs on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from .. import native
from ..core.checkpoint import load_checkpoint
from ..core.device import resolve_device
from ..flowtools.registry import get_flow_model
from ..models.raft.raft import RAFT
from ..ops.warp import warp_tensor
from ..utils.flow_viz import flow_to_image
from ..utils.misc import resize_u8


def load_raft(path: str | None, device: torch.device) -> RAFT:
    """RAFT with the weights of the ``.pt`` at ``path``, or the registry's
    seeded random weights (seed 0) where there is no such file."""
    if path and os.path.exists(path):
        _, raft_sd = load_checkpoint(path)
        assert raft_sd is not None, "no RAFT weights found in checkpoint"
        model = RAFT()
        missing, unexpected = model.load_state_dict({k.removeprefix("raft."): v for k, v in raft_sd.items()},
                                                    strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise KeyError(f"RAFT state dict mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
        return model.to(device).eval()
    print("WARNING: no checkpoint -- running random-init RAFT")
    return get_flow_model("raft").init_fn(0, device=device)


def main(argv=None, device: str | torch.device | None = None) -> None:
    p = argparse.ArgumentParser("RAFT demo")
    p.add_argument("--model", type=str, default=None, help="raft checkpoint")
    p.add_argument("--path", type=str, required=True, help="frame folder")
    p.add_argument("--save", type=str, default="./demo_out")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--precision", choices=("highest", "fast"), default="highest")
    args = p.parse_args(argv)
    device = resolve_device(device)
    model = load_raft(args.model, device)
    flow_fn = get_flow_model("raft").forward_fn

    frames = sorted(glob.glob(os.path.join(args.path, "*.png")) + glob.glob(os.path.join(args.path, "*.jpg")))
    os.makedirs(args.save, exist_ok=True)

    def load(fp: str) -> torch.Tensor:
        img = resize_u8(native.read_rgb(fp), (args.height, args.width))
        return torch.from_numpy(img[None].astype(np.float32)).to(device)

    for f1, f2 in zip(frames[:-1], frames[1:]):
        i1, i2 = load(f1), load(f2)
        t1 = time.perf_counter()
        _, flow_up = flow_fn(model, i1, i2, args.iters, args.precision)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        print(f"{os.path.basename(f1)} -> {os.path.basename(f2)}: {t2 - t1:.4f}s")

        overlap = 0.5 * warp_tensor(flow_up, i1 / 255.0) + 0.5 * (i2 / 255.0)
        stem = os.path.splitext(os.path.basename(f2))[0]
        native.write_png(os.path.join(args.save, f"{stem}_flow.png"), flow_to_image(flow_up[0].cpu().numpy()))
        over = (np.clip(overlap[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        native.write_png(os.path.join(args.save, f"{stem}_overlap.png"), over)


if __name__ == "__main__":
    main()
