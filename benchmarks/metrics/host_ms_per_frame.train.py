"""Host ms a training step inside ``train_step`` (the program's
``zt.train.step`` spans): forward, loss, backward and ``Adam.step`` as the
host dispatches them, waits for the device included."""

from program_spans import ms_per_frame


def read(summary: dict, config: dict) -> float | None:
    return ms_per_frame(summary, "train", "zt.train.step", "host_ms")
