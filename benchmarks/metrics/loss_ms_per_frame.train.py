"""Device ms a training step between the stream markers of the program's
``zt.train.loss`` spans: the 17 terms of ``losses/zero_tig_loss.py``."""

from program_spans import ms_per_frame


def read(summary: dict, config: dict) -> float | None:
    return ms_per_frame(summary, "train", "zt.train.loss", "device_ms")
