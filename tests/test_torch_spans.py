"""The port's spans and counters (``zero_tig_torch/core/spans.py``) on the
CPU, at the tiny size of the other port tests (64x48, of_scale 2, 2 RAFT
iterations): off without a profiler, the ``zt.*`` tree of ``predict_chunk``
and ``train_step`` under one, in the profiler's own events too, and each
session starting empty."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zero_tig_torch.core import spans
from zero_tig_torch.core.config import Config
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.pipeline import steps

torch.set_num_threads(1)

KW = dict(of_scale=2, raft_iters=2)
FRAME = (1, 48, 64, 3)
FRAME_SPANS = ["zt.infer.denoise_1", "zt.flow", "zt.infer.enhancer", "zt.infer.denoise_2"]


@pytest.fixture(scope="module")
def state_dict():
    return init_random_state_dict(0)


@pytest.fixture(scope="module")
def model(state_dict):
    return build_model(state_dict, device="cpu", precision="highest")


def _chunk(model, n=2):
    frames = torch.randint(0, 256, (n, *FRAME), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    flags = torch.tensor([k == 0 for k in range(n)])
    return steps.predict_chunk(model, frames, steps.init_carry(model, FRAME), flags, emit="u8", **KW)


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent]


def test_off_without_a_profiler(model):
    with profile(activities=[ProfilerActivity.CPU]):
        pass  # a session that records nothing leaves nothing
    assert spans.records() == []
    assert not spans.on()
    assert spans.span("zt.a") is spans.span("zt.b")  # the one shared null context
    counts = dict(spans.COUNTS)
    _chunk(model, 1)
    assert spans.records() == []
    assert spans.counters() == {**counts, "k1.launches": 0, "k1.host_ns": 0}


def test_predict_chunk_records_the_tree(model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chunk(model, 2)
    recs = spans.records()
    assert recs[0]["name"] == "zt.predict_chunk" and recs[0]["parent"] is None
    assert _children(recs, 0) == ["zt.h2d", "zt.infer.frame", "zt.infer.frame"]
    frames = [i for i, r in enumerate(recs) if r["name"] == "zt.infer.frame"]
    for f in frames:
        assert _children(recs, f) == FRAME_SPANS
        flow = next(i for i, r in enumerate(recs) if r["parent"] == f and r["name"] == "zt.flow")
        assert _children(recs, flow) == ["zt.raft"]
    for r in recs:  # host clock only: the CPU records no events
        assert r["host_ms"] > 0 and r["device_ms"] is None
        if r["parent"] is not None:
            assert r["host_ms"] <= recs[r["parent"]]["host_ms"]
    names = [e.name for e in prof.events()]
    for name in {r["name"] for r in recs}:
        assert names.count(name) == sum(r["name"] == name for r in recs), name


def test_train_step_records_its_stages_in_order(state_dict):
    config = Config(precision="highest", frame_height=FRAME[1], frame_width=FRAME[2], **KW)
    state = steps.init_train_state(config, state_dict, FRAME, device="cpu")
    frame = torch.rand(FRAME, generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]):
        state, loss = steps.train_step(state, frame, True, **KW)
    recs = spans.records()
    assert torch.isfinite(loss)
    assert recs[0]["name"] == "zt.train.step" and recs[0]["parent"] is None
    assert _children(recs, 0) == ["zt.h2d", "zt.train.forward", "zt.train.loss", "zt.train.backward",
                                  "zt.train.adam"]
    forward = next(i for i, r in enumerate(recs) if r["name"] == "zt.train.forward")
    assert _children(recs, forward) == ["zt.flow"]


def test_a_second_session_starts_empty(model):
    with profile(activities=[ProfilerActivity.CPU]):
        _chunk(model, 1)
    assert sum(r["name"] == "zt.infer.frame" for r in spans.records()) == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("zt.test"):
            pass
    assert [r["name"] for r in spans.records()] == ["zt.test"]
    assert spans.counters()["k1.launches"] == 0


def test_counts_are_kept_apart_from_sessions():
    spans.COUNTS["gru"] += 3
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count_k1(2500)
        spans.count_k1(1500)
        assert spans.counters()["gru"] >= 3  # a session leaves the launch counts alone
    got = spans.counters()
    assert got["k1.launches"] == 2 and got["k1.host_ns"] == 4000
    spans.reset_counts()
    assert all(spans.counters()[k] == 0 for k in spans.COUNTS)
