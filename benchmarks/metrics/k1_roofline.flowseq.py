"""K1's share of its roofline in a warm-started pair, in %: the sum of the
bounds of RAFT's K1 launches a pair (the ``raft.*`` rows of
``roofline.k1_layers``, at the configuration's grid, iterations and operand
type) over the device time a pair of K1's two kernels, by exact name."""

from roofline import k1_bound_ms, k1_layers

K1 = ("zt::fused_conv_kernel", "zt::fused_conv_mma_kernel")


def read(summary: dict, config: dict) -> float | None:
    if summary.get("kind") != "flowseq":
        return None
    seconds = sum(summary["ops"].get(k, (0.0, 0))[0] for k in K1)
    if seconds <= 0:
        return None
    bound = sum(k1_bound_ms(layer, config["precision"]) * layer[-1] for layer in k1_layers(config)
                if layer[0].startswith("raft."))
    return 100.0 * bound / (seconds * 1e3 / summary["frames"])
