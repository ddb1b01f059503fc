"""Device ms a training step between the stream markers of the program's
``zt.train.adam`` spans: the clip, weight decay and Adam update of
``pipeline/steps.py::Adam.step``."""

from program_spans import ms_per_frame


def read(summary: dict, config: dict) -> float | None:
    return ms_per_frame(summary, "train", "zt.train.adam", "device_ms")
