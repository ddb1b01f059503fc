"""K1's share of its roofline in a warm-started GMA pair, in %: the sum of
the bounds of GMA's K1 launches a pair (``roofline_gma.k1_layers_gma``:
RAFT's rows with the GRU's gates at 512 input channels, and ``to_v``, at
the configuration's grid, iterations and operand type) over the device time
a pair of K1's two kernels, by exact name."""

from roofline_gma import k1_pair_bound_ms

K1 = ("zt::fused_conv_kernel", "zt::fused_conv_mma_kernel")


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "gma":
        return None
    seconds = sum(summary["ops"].get(k, (0.0, 0))[0] for k in K1)
    if seconds <= 0:
        return None
    return 100.0 * k1_pair_bound_ms(config) / (seconds * 1e3 / summary["frames"])
