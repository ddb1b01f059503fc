"""Device ms a training step between the stream markers of the program's
``zt.train.backward`` spans: autograd's backward, library data and weight
gradients and the elementwise gradients."""

from program_spans import ms_per_frame


def read(summary: dict, config: dict) -> float | None:
    return ms_per_frame(summary, "train", "zt.train.backward", "device_ms")
