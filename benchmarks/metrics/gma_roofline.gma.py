"""GMA's mechanism's share of its roofline in a warm-started pair, in %: the
f32 bound of its matrix products (``roofline_gma.attention_bound_ms``: the
logits once a pair and the aggregation each iteration, 6.249 ms at Sintel's
grid and 32 iterations) over their device ms (``gma_ms_per_pair.gma``)."""

from gma_spans import ms_per_pair
from roofline_gma import attention_bound_ms


def read(summary: dict, config: dict) -> float | None:
    ms = ms_per_pair(summary, "zt.gma.attention", "zt.gma.aggregate")
    if not ms:
        return None
    return 100.0 * attention_bound_ms(config) / ms
