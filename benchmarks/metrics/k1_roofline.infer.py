"""K1's share of its roofline in a streamed frame, in %: the sum of the
frame's K1 launch bounds (``roofline.py``, at the configuration's operand
type) over the device time a frame of K1's two kernels, by exact name."""

from roofline import k1_frame_bound_ms

K1 = ("zt::fused_conv_kernel", "zt::fused_conv_mma_kernel")


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "stream":
        return None
    seconds = sum(summary["ops"].get(k, (0.0, 0))[0] for k in K1)
    if seconds <= 0:
        return None
    return 100.0 * k1_frame_bound_ms(config) / (seconds * 1e3 / summary["frames"])
