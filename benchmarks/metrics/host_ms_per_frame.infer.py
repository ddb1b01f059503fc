"""Host ms a streamed frame inside ``forward_inference`` (the program's
``zt.infer.frame`` spans): what the host spends dispatching a frame's
Denoise_1, flow, Enhancer and Denoise_2, waits for the device included."""

from program_spans import ms_per_frame


def read(summary: dict, config: dict) -> float | None:
    return ms_per_frame(summary, "stream", "zt.infer.frame", "host_ms")
