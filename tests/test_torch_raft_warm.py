"""RAFT's warm start (``flow_init``), the device forward interpolation
(``ops/splat.py``) and the sequence entry (``flowtools/sequence.py``), against
the plain reference ``plain_reference/raft_sintel.py`` and scipy.

On the CPU at a tiny size: 122x132 frames, padded to 128x136 (a 16x17 grid,
so that every correlation level is at least 2 wide, as the reference's
``grid_sample`` lookup needs), 3 iterations, seeded weights. On a card (marker
``card``; ``python -m pytest --noconftest -m card tests/test_torch_raft_warm.py``):
the graphed warm-started sequence at Sintel's size equals the eager pass bit
for bit. This file imports no JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plain_reference.raft_sintel import RAFTReference, pad8, sintel_sequence
from plain_reference.raft_sintel import forward_interpolate as ref_splat
from zero_tig_torch import native
from zero_tig_torch.core import spans
from zero_tig_torch.core.precision import numerics
from zero_tig_torch.flowtools import get_flow_model, write_sintel_submission
from zero_tig_torch.flowtools.registry import prepare_raft
from zero_tig_torch.flowtools.sequence import flow_chunk
from zero_tig_torch.models.raft.corr import lookup_corr
from zero_tig_torch.models.raft.raft import CORR_RADIUS, convex_upsample_flow
from zero_tig_torch.models.raft.update import update_core
from zero_tig_torch.ops.splat import forward_interpolate
from zero_tig_torch.utils.flow_io import read_flo
from zero_tig_torch.utils.misc import forward_interpolate as scipy_splat

torch.set_num_threads(1)

H, W, GRID, IT = 122, 132, (16, 17), 3
# f32 on both sides with sums in other orders (K1's plain twin against
# F.conv2d, the hat-matrix lookup against grid_sample) over 3 iterations:
# measured under 1e-5 px on flows of ~10 px; 1e-4 px leaves room, and a
# warm start dropped or a pair left cold moves the flow by whole pixels
ATOL = 1e-4


@pytest.fixture(scope="module")
def raft():
    model = get_flow_model("raft").init_fn(3, device="cpu")
    prepare_raft(model, "highest")
    return model


def _frames(seed, n):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 1, H, W, 3, generator=g) * 256).to(torch.uint8)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def test_flow_init_agrees_with_the_plain_reference(raft):
    a, b = (f.float() for f in _frames(1, 2))
    init = torch.randn(1, *GRID, 2, generator=torch.Generator().manual_seed(2)) * 2
    with torch.no_grad(), numerics("highest"):
        low, up = raft(a, b, IT, flow_init=init)
    ref_low, ref_up = RAFTReference(raft.state_dict()).forward(pad8(_nchw(a)), pad8(_nchw(b)), IT, _nchw(init))
    torch.testing.assert_close(_nchw(low), ref_low, rtol=0, atol=ATOL)
    torch.testing.assert_close(_nchw(up), ref_up, rtol=0, atol=ATOL)


def test_zero_tig_call_is_unchanged(raft):
    """Without ``flow_init`` the pass is the loop as it was before the warm
    start, bit for bit; a zero ``flow_init`` gives the same flows."""
    a, b = (f.float() for f in _frames(3, 2))
    with torch.no_grad(), numerics("highest"):
        levels, net, inp, coords0 = raft._encode(a, b, torch.float32)
        coords1 = coords0
        ub = raft.update_block
        for _ in range(IT):
            flow = coords1 - coords0
            net, delta = update_core(ub.kw, net, inp, lookup_corr(levels, coords1, CORR_RADIUS),
                                     ub.flow_features(flow), flow)
            coords1 = coords1 + delta
        before = (coords1 - coords0, convex_upsample_flow(coords1 - coords0, ub.mask_head(net)))
        for got in (raft.flow_graphed(a, b, IT), raft(a, b, IT, flow_init=torch.zeros(1, *GRID, 2))):
            assert all(map(torch.equal, got, before))
    assert raft.graph_key(a, b, IT) != raft.graph_key(a, b, IT, torch.zeros(1, *GRID, 2))


def test_device_splat_equals_scipy():
    """Exactly scipy's ``griddata(nearest)``: a zero flow, flows that move
    points off the grid, and flows that move every point off (zeros)."""
    rng = np.random.default_rng(7)
    for flow in [rng.normal(0, scale, (2, *GRID)).astype(np.float32) for scale in (0.0, 3.0, 30.0)] + [
            np.full((2, *GRID), v, np.float32) for v in (1e3, -20.0)]:
        got = forward_interpolate(torch.from_numpy(flow).permute(1, 2, 0)[None])[0].permute(2, 0, 1)
        np.testing.assert_array_equal(got.numpy(), scipy_splat(flow))
        np.testing.assert_array_equal(ref_splat(torch.from_numpy(flow)[None])[0].numpy(), scipy_splat(flow))


def test_flow_chunk_agrees_with_the_reference_sequence(raft):
    """A 7-frame video in chunks of 3 with a new sequence at frames 0 and 5:
    the warm start carried over chunks and reset at the flag, flows at the
    frame's size; the session counters count 5 pairs, 3 of them warm."""
    frames = _frames(4, 7)
    flags = [k in (0, 5) for k in range(7)]
    carry, flows, lows = {}, [], []
    with profile(activities=[ProfilerActivity.CPU]):
        for s in range(0, 7, 3):
            (f, low), carry = flow_chunk(raft, frames[s:s + 3], carry, flags[s:s + 3], IT)
            flows.append(f)
            lows.append(low)
        counts = spans.counters()
    assert (counts["flowseq.pairs"], counts["flowseq.warm_starts"]) == (5, 3)
    flows, lows = torch.cat(flows), torch.cat(lows)
    assert flows.shape == (5, 1, H, W, 2) and lows.shape == (5, 1, *GRID, 2)
    assert torch.equal(carry["flow_init"], forward_interpolate(lows[-1]))
    ref = RAFTReference(raft.state_dict())
    want = sintel_sequence(ref, _nchw(frames.reshape(7, H, W, 3).float())[:, None], flags, IT)
    for (up, low), (ref_up, ref_low) in zip(zip(flows, lows), want, strict=True):
        torch.testing.assert_close(_nchw(up), ref_up, rtol=0, atol=ATOL)
        torch.testing.assert_close(_nchw(low), ref_low, rtol=0, atol=ATOL)
    cold = sintel_sequence(ref, _nchw(frames[1:4].reshape(3, H, W, 3).float())[:, None], [True, False, False], IT,
                           warm_start=False)
    assert (flows[2] - cold[1][0].permute(0, 2, 3, 1)).abs().max() > 100 * ATOL  # the warm start shows


def test_warm_sintel_submission_equals_flow_chunk(raft, tmp_path):
    frames = _frames(5, 3)
    scene = tmp_path / "frames" / "alley_1"
    scene.mkdir(parents=True)
    for k in range(3):
        native.write_png(str(scene / f"frame_{k + 1:04d}.png"), frames[k, 0].numpy())
    assert write_sintel_submission("raft", raft, str(tmp_path / "frames"), str(tmp_path / "out"), iters=IT,
                                   device="cpu", warm_start=True) == 2
    (want, _), _ = flow_chunk(raft, frames, {}, [True, False, False], IT)
    for k in range(2):
        np.testing.assert_array_equal(read_flo(str(tmp_path / "out" / "alley_1" / f"frame_{k + 1:04d}.flo")),
                                      want[k, 0].numpy())
    with pytest.raises(ValueError, match="flow_init"):
        write_sintel_submission("pwc_lite", raft, str(tmp_path / "frames"), str(tmp_path / "out"), warm_start=True)


@pytest.mark.card
def test_graphed_warm_sequence_equals_eager_on_the_card():
    """At Sintel's size (436x1024, 32 iterations) a chunk replayed from the
    graph equals the eager passes with the same warm starts, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    model = get_flow_model("raft").init_fn(3, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    frames = (torch.rand(6, 1, 436, 1024, 3, generator=g, device="cuda") * 256).to(torch.uint8)
    flags = [True] + [False] * 5
    (flows, lows), carry = flow_chunk(model, frames[:3], {}, flags[:3], 32)  # captures, then replays
    (flows2, lows2), _ = flow_chunk(model, frames[3:], carry, flags[3:], 32)
    assert model._graph is not None
    init = torch.zeros(1, 55, 128, 2, device="cuda")
    with torch.no_grad(), numerics("highest"):
        for k, (up, low) in enumerate(zip(torch.cat([flows, flows2]), torch.cat([lows, lows2]))):
            want_low, want_up = model(frames[k].float(), frames[k + 1].float(), 32, flow_init=init)  # pads itself
            assert torch.equal(low, want_low) and torch.equal(up, want_up[:, 2:438]), k
            init = forward_interpolate(low)
