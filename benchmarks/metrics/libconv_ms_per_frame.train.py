"""Device ms a training step in the library's convolutions, which carry the
denoisers and the Enhancer under autograd: cuDNN and CUTLASS convolution
kernels (forward, data and weight gradients), cuDNN's FFT convolutions and
the NHWC/NCHW transposes around them, by exact kernel name."""

import re

LIBCONV = re.compile(r"conv|fprop|dgrad|wgrad|fft|gemv2N_kernel|nchwToNhwc|nhwcToNchw|implicit_gemm", re.I)


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "train":
        return None
    ms = sum(sec for name, (sec, _) in summary["ops"].items()
             if LIBCONV.search(name) and not name.startswith("zt::")) * 1e3
    return ms / summary["frames"] if ms > 0 else None
