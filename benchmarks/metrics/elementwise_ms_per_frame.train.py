"""Device ms a training step in ATen's elementwise and reduction kernels,
which carry the loss (``losses/zero_tig_loss.py``), the BatchNorm and clip
glue and ``Adam.step``, by exact kernel name."""


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "train":
        return None
    ms = sum(sec for name, (sec, _) in summary["ops"].items()
             if "elementwise" in name or "reduce_kernel" in name) * 1e3
    return ms / summary["frames"] if ms > 0 else None
