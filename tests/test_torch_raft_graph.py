"""RAFT's graphed inference path (``RAFT.flow_graphed``, reached through
``models/network.py::update_cache``).

On the CPU, at the tiny size of the other port tests (64x48, of_scale 2, 2
RAFT iterations): ``update_cache`` runs the eager pass and counts no
capture or replay, the capture key follows the prepared operands, and
``RAFT.forward``, the sidecar's entry, never replays. On a card (marker
``card``; ``python -m pytest --noconftest -m card tests/test_torch_raft_graph.py``,
since this directory's conftest loads JAX): at the cells' RAFT size the
graph equals the eager pass bit for bit in both precisions, captures again
only when the key changes, and goes with its model. This file imports no
JAX."""

import gc
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zero_tig_torch.core import spans
from zero_tig_torch.core.config import Config
from zero_tig_torch.core.precision import numerics
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.models.network import update_cache
from zero_tig_torch.ops.equalize import equalize01
from zero_tig_torch.ops.resize import resize_bilinear
from zero_tig_torch.ops.warp import warp_tensor
from zero_tig_torch.pipeline import steps

torch.set_num_threads(1)

KW = dict(of_scale=2, raft_iters=2)
FRAME = (1, 48, 64, 3)


@pytest.fixture(scope="module")
def state_dict():
    return init_random_state_dict(0)


def _frames(seed, shape=FRAME, device="cpu", dtype=torch.float32):
    """(last_H3, last_s3, L2): three draws in [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand(shape, generator=g).to(device=device, dtype=dtype) for _ in range(3))


def eager_update_cache(raft, last_H3, last_s3, L2, *, of_scale, raft_iters):
    """``update_cache`` with RAFT's eager ``forward``, as it ran before the graph."""
    h, w = last_H3.shape[1], last_H3.shape[2]
    size = (h // of_scale, w // of_scale)
    last_tmp = resize_bilinear(last_H3, size) * 255.0
    l2_tmp = equalize01(resize_bilinear(L2, size))
    _, flow_up = raft(last_tmp, l2_tmp, iters=raft_iters)
    return warp_tensor(flow_up, torch.cat([last_H3, last_s3], dim=-1))


def _graph_counts():
    return spans.GRAPHS["raft_graph_capture"], spans.GRAPHS["raft_graph_replay"]


def test_update_cache_on_the_cpu_is_the_eager_pass(state_dict):
    model = build_model(state_dict, device="cpu", precision="highest")
    before = _graph_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        got = update_cache(model.raft, *_frames(1), **KW)
        session = spans.counters()
    assert torch.equal(got, eager_update_cache(model.raft, *_frames(1), **KW))
    assert update_cache(model.raft, *_frames(2), **KW).shape == (*FRAME[:3], 6)
    assert _graph_counts() == before and model.raft._graph is None
    assert session["raft.calls"] == 1 and session["raft.graph_replays"] == 0


def test_graph_key_follows_the_prepared_operands(state_dict):
    config = Config(precision="highest", frame_height=FRAME[1], frame_width=FRAME[2], **KW)
    state = steps.init_train_state(config, state_dict, FRAME, device="cpu")
    raft = state.model.raft
    a, b = (t[..., :3] * 255.0 for t in _frames(3, (1, 24, 32, 3))[:2])
    key = raft.graph_key(a, b, 2)
    assert raft.graph_key(a.clone(), b + 1.0, 2) == key  # values are no part of it
    state, _ = steps.train_step(state, torch.rand(FRAME), True, **KW)
    assert raft.graph_key(a, b, 2) == key  # a training step prepares nothing
    assert raft.graph_key(a, b, 3) != key
    assert raft.graph_key(a[:, :16], b[:, :16], 2) != key
    assert raft.graph_key(a.to(torch.bfloat16), b, 2) != key
    with numerics("highest"):  # TF32 off
        assert raft.graph_key(a, b, 2) != key
    state.model.prepare()
    assert raft.graph_key(a, b, 2) != key


class _FakeGraph:
    """A capture under ``key`` that fails if replayed."""

    def __init__(self, key):
        self.key = key

    def replay(self, *_):
        raise AssertionError("replayed")


def test_forward_never_replays(state_dict):
    """The sidecar and flow training call ``forward``: it runs the eager
    pass whatever graph the model holds."""
    raft = build_model(state_dict, device="cpu", precision="highest").raft
    a, b = (t[..., :3] * 255.0 for t in _frames(4, (1, 24, 32, 3))[:2])
    want_low, want_up = raft(a, b, 2)
    raft._graph = _FakeGraph(raft.graph_key(a, b, 2))
    before = _graph_counts()
    low, up = raft(a, b, 2)
    assert torch.equal(low, want_low) and torch.equal(up, want_up)
    assert raft(a, b, 2, return_predictions=True)[1].shape == (2, *up.shape)
    assert all(map(torch.equal, raft.flow_graphed(a, b, 2), (want_low, want_up)))  # the CPU takes no graph either
    assert _graph_counts() == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "fast"])
def test_graph_equals_eager_on_the_card(state_dict, precision):
    """The cells' RAFT size: 1080p frames at of_scale 3 (360x640, grid
    45x80), three frames of different content, so a stale input shows."""
    dev = _card()
    model = build_model(state_dict, device=dev, precision=precision)
    kw = dict(of_scale=3, raft_iters=12)
    before = _graph_counts()
    with torch.inference_mode(), numerics(precision):
        for seed in (5, 6, 7):
            frames = _frames(seed, (1, 1080, 1920, 3), dev, model.dtype)
            got = update_cache(model.raft, *frames, **kw)
            want = eager_update_cache(model.raft, *frames, **kw)
            assert torch.equal(got, want), seed
    assert _graph_counts() == (before[0] + 1, before[1] + 2)


@pytest.mark.card
def test_graph_captures_again_only_for_a_new_key(state_dict):
    dev = _card()
    config = Config(precision="fast", frame_height=96, frame_width=128, **KW)
    frame = (1, 96, 128, 3)
    state = steps.init_train_state(config, state_dict, frame, device=dev)
    model = state.model
    cdt = model.dtype

    def call(seed, shape=frame):
        with torch.inference_mode():
            return update_cache(model.raft, *_frames(seed, shape, dev, cdt), **KW)

    def wrapper_launches(since):
        return {k: spans.COUNTS[k] - since[k] for k in ("fused_conv", "gru")}

    with torch.inference_mode():  # one eager pass at the graph's shape, through the wrappers
        a, b = (t[..., :3] * 255.0 for t in _frames(9, (1, 48, 64, 3), dev, cdt)[:2])
        before = dict(spans.COUNTS)
        model.raft(a, b, 2)
        one_pass = wrapper_launches(before)
    spans.reset_counts()
    for seed in range(3):
        call(seed)
    assert _graph_counts() == (1, 2)  # one capture, a replay for every call after the first
    # the capture's eager pass and the pass it records go through the wrappers; a replay does not
    assert wrapper_launches(dict.fromkeys(spans.COUNTS, 0)) == {k: 2 * n for k, n in one_pass.items()}
    before = dict(spans.COUNTS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(3)
        torch.cuda.synchronize()
    assert wrapper_launches(before) == {"fused_conv": 0, "gru": 0}
    ran = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # the replay ran the pass's kernels on the device
    assert {"fused_conv": sum("zt::fused_conv_mma_kernel" in n for n in ran),
            "gru": sum("zt::gru_" in n for n in ran)} == one_pass

    for seed in range(3):
        state, _ = steps.train_step(state, torch.rand(frame, device=dev), seed == 0, **KW)
    assert _graph_counts() == (1, 6)  # training steps replay the same graph
    model.prepare()
    call(4)
    assert _graph_counts() == (2, 6)
    call(5, (1, 64, 128, 3))
    call(6, (1, 64, 128, 3))
    assert _graph_counts() == (3, 7)

    ref = weakref.ref(model.raft)
    del model, state
    gc.collect()
    assert ref() is None  # the graph and its memory pool went with the model
