"""The readers of the program's spans and counters against hand-built
records: sums over the traced spans divided by the frames, us a K1 launch,
and no number for another kind of cell, an empty session, a count of unit
spans other than the frames, or a program without spans."""

import sys

import harness
import pytest

from zero_tig_torch.core import spans

READERS = {
    "host_ms_per_frame.infer": "stream", "raft_ms_per_frame.infer": "stream", "k1_launch_us.infer": "stream",
    "host_ms_per_frame.train": "train", "loss_ms_per_frame.train": "train",
    "backward_ms_per_frame.train": "train", "adam_ms_per_frame.train": "train",
}


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "reader_" + name.replace(".", "_"))


def rec(name, parent, host_ms, device_ms=None):
    return {"name": name, "parent": parent, "host_ms": host_ms, "device_ms": device_ms}


def stream_records(frames):
    """A chunk of ``frames`` frames, each 20 host ms with RAFT 5 device ms."""
    recs = [rec("zt.predict_chunk", None, 100.0, 90.0), rec("zt.h2d", 0, 1.0, 0.5)]
    for k in range(frames):
        f = len(recs)
        recs += [rec("zt.infer.frame", 0, 20.0 + k, 19.0), rec("zt.flow", f, 8.0, 7.0),
                 rec("zt.raft", f + 1, 6.0, 5.0 + k)]
    return recs


def train_records(steps):
    recs = []
    for k in range(steps):
        s = len(recs)
        recs += [rec("zt.train.step", None, 100.0 + k, 90.0), rec("zt.train.forward", s, 40.0, 30.0),
                 rec("zt.train.loss", s, 5.0, 10.0 + k), rec("zt.train.backward", s, 20.0, 40.0),
                 rec("zt.train.adam", s, 3.0, 6.0)]
    return recs


@pytest.fixture
def program(monkeypatch):
    """``put(records, counters)`` hands the readers a session."""
    held = {"records": [], "counters": {}}
    monkeypatch.setattr(spans, "records", lambda: held["records"])
    monkeypatch.setattr(spans, "counters", lambda: held["counters"])

    def put(records, counters=None):
        held["records"], held["counters"] = records, counters or {"k1.launches": 0, "k1.host_ns": 0}
    return put


def test_stream_readers_sum_and_divide(program):
    program(stream_records(2), {"fused_conv": 7, "k1.launches": 242, "k1.host_ns": 242 * 25_000})
    summary = {"kind": "stream", "frames": 2}
    assert reader("host_ms_per_frame.infer").read(summary, {}) == pytest.approx((20.0 + 21.0) / 2)
    assert reader("raft_ms_per_frame.infer").read(summary, {}) == pytest.approx((5.0 + 6.0) / 2)
    assert reader("k1_launch_us.infer").read(summary, {}) == pytest.approx(25.0)


def test_train_readers_sum_and_divide(program):
    program(train_records(4))
    summary = {"kind": "train", "frames": 4}
    assert reader("host_ms_per_frame.train").read(summary, {}) == pytest.approx(101.5)
    assert reader("loss_ms_per_frame.train").read(summary, {}) == pytest.approx(11.5)
    assert reader("backward_ms_per_frame.train").read(summary, {}) == pytest.approx(40.0)
    assert reader("adam_ms_per_frame.train").read(summary, {}) == pytest.approx(6.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_no_number_where_nothing_fits(program, name):
    kind = READERS[name]
    other = "train" if kind == "stream" else "stream"
    records = stream_records(2) if kind == "stream" else train_records(2)
    program(records, {"k1.launches": 10, "k1.host_ns": 10_000})
    read = reader(name).read
    assert read({"kind": kind, "frames": 2}, {}) is not None
    assert read({"kind": other, "frames": 2}, {}) is None  # another kind of cell
    assert read({"kind": kind, "frames": 3}, {}) is None  # unit spans other than the frames
    program([], {"k1.launches": 10, "k1.host_ns": 10_000})
    assert read({"kind": kind, "frames": 2}, {}) is None  # nothing recorded


@pytest.mark.parametrize("name", ["raft_ms_per_frame.infer", "loss_ms_per_frame.train", "k1_launch_us.infer"])
def test_no_number_without_events_or_launches(program, name):
    kind = READERS[name]
    records = stream_records(1) if kind == "stream" else train_records(1)
    for r in records:
        r["device_ms"] = None  # a CPU session: host clock only
    program(records, {"k1.launches": 0, "k1.host_ns": 0})
    assert reader(name).read({"kind": kind, "frames": 1}, {}) is None


def test_no_number_from_a_program_without_spans(monkeypatch):
    import zero_tig_torch.core

    monkeypatch.delattr(zero_tig_torch.core, "spans")
    monkeypatch.setitem(sys.modules, "zero_tig_torch.core.spans", None)  # the import fails, as in a checkout without it
    for name, kind in READERS.items():
        assert reader(name).read({"kind": kind, "frames": 2}, {}) is None
