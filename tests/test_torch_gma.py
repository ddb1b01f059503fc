"""GMA (``zero_tig_torch/models/raft/gma.py``) against the plain reference
``plain_reference/gma_sintel.py``, on the CPU at a tiny size: 122x132 frames
padded to 128x136 (a 16x17 grid of 272 positions, so that every correlation
level is at least 2 wide, as the reference's ``grid_sample`` lookup needs),
3 iterations, f32, seeded weights with gamma away from its published 0 and
``to_qk`` scaled up, so that the aggregation moves the flow and the
attention is peaked. This file imports no JAX."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plain_reference.gma_sintel import GMAReference
from plain_reference.raft_sintel import pad8, sintel_sequence
from zero_tig_torch.core import spans
from zero_tig_torch.core.precision import numerics
from zero_tig_torch.flowtools import flow_chunk, get_flow_model
from zero_tig_torch.flowtools.registry import prepare_raft
from zero_tig_torch.models.raft import gma
from zero_tig_torch.ops.fused_conv import fused_conv
from zero_tig_torch.ops.splat import forward_interpolate

torch.set_num_threads(1)

H, W, GRID, IT = 122, 132, (16, 17), 3
# f32 on both sides with sums in other orders (K1's plain twin and the
# kernel path's matrix products against F.conv2d and einsum, the hat-matrix
# lookup against grid_sample) over 3 iterations: measured under 1e-5 px on
# flows of ~10 px; 1e-4 px leaves room, and the aggregation left out
# (gamma 0) moves these flows by ~1.5e-2 px, over a hundred times as much
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    m = get_flow_model("gma").init_fn(3, device="cpu")
    with torch.no_grad():
        m.update_block.aggregator.gamma.fill_(0.75)
        m.att.to_qk.weight.mul_(40.0)
    prepare_raft(m, "highest")
    return m


def _frames(seed, n):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 1, H, W, 3, generator=g) * 256).to(torch.uint8)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def test_forward_agrees_with_the_plain_reference(model):
    """Cold, warm (``flow_init``) and the differentiable path's last
    prediction; the aggregation shows (gamma 0 moves the flow)."""
    a, b = (f.float() for f in _frames(1, 2))
    init = torch.randn(1, *GRID, 2, generator=torch.Generator().manual_seed(2)) * 2
    ref = GMAReference(model.state_dict())
    for fi in (None, init):
        with torch.no_grad(), numerics("highest"):
            low, up = model(a, b, IT, flow_init=fi)
        want_low, want_up = ref.forward(pad8(_nchw(a)), pad8(_nchw(b)), IT, None if fi is None else _nchw(fi))
        torch.testing.assert_close(_nchw(low), want_low, rtol=0, atol=ATOL)
        torch.testing.assert_close(_nchw(up), want_up, rtol=0, atol=ATOL)
    with numerics("highest"):
        low, ups = model(a, b, IT, flow_init=init, return_predictions=True, dtype=torch.float32)
    assert ups.shape == (IT, 1, 8 * GRID[0], 8 * GRID[1], 2) and ups.requires_grad
    torch.testing.assert_close(_nchw(low.detach()), want_low, rtol=0, atol=ATOL)
    torch.testing.assert_close(_nchw(ups[-1].detach()), want_up, rtol=0, atol=ATOL)
    ref.p["update_block.aggregator.gamma"] = torch.zeros(1)
    assert (ref.forward(pad8(_nchw(a)), pad8(_nchw(b)), IT, _nchw(init))[1] - want_up).abs().max() > 50 * ATOL


def test_flow_chunk_agrees_with_the_reference_sequence(model):
    """A 5-frame video in chunks of 3 with a new sequence at frames 0 and 3,
    warm-started: GMA's spans and counts under a profiler, the attention once
    a pair and an aggregation each iteration."""
    frames = _frames(4, 5)
    flags = [k in (0, 3) for k in range(5)]
    carry, flows, lows = {}, [], []
    before = spans.COUNTS["gma_aggregate"]
    with profile(activities=[ProfilerActivity.CPU]):
        for s in range(0, 5, 3):
            (f, low), carry = flow_chunk(model, frames[s:s + 3], carry, flags[s:s + 3], IT)
            flows.append(f)
            lows.append(low)
        recs = spans.records()
    assert spans.COUNTS["gma_aggregate"] - before == 3 * IT
    passes = [i for i, r in enumerate(recs) if r["name"] == "zt.raft"]
    assert len(passes) == 3
    for p in passes:
        assert [r["name"] for r in recs if r["parent"] == p] == ["zt.gma.attention"] + ["zt.gma.aggregate"] * IT
    want = sintel_sequence(GMAReference(model.state_dict()), _nchw(frames.reshape(5, H, W, 3).float())[:, None],
                           flags, IT)
    for (up, low), (ref_up, ref_low) in zip(zip(torch.cat(flows), torch.cat(lows)), want, strict=True):
        torch.testing.assert_close(_nchw(up), ref_up, rtol=0, atol=ATOL)
        torch.testing.assert_close(_nchw(low), ref_low, rtol=0, atol=ATOL)


def test_gamma_zero_gives_glob_equal_to_mf(model):
    """At the published init (gamma 0) the aggregation adds nothing, exactly:
    on the kernel path (gamma folded into ``to_v``'s scale) and on the modules."""
    g = torch.Generator().manual_seed(5)
    mf = torch.randn(1, *GRID, 128, generator=g)
    attn = torch.randn(1, GRID[0] * GRID[1], 128, generator=g) @ torch.randn(1, 128, GRID[0] * GRID[1], generator=g)
    attn = attn.softmax(-1)
    m = get_flow_model("gma").init_fn(4, device="cpu")
    assert float(m.update_block.aggregator.gamma.detach()) == 0.0
    kw = m.prepare(torch.float32)
    v = fused_conv([mf], kw["to_v"], out_dtype=torch.float32)
    assert torch.equal(gma.aggregate(mf, attn, v), mf)
    assert torch.equal(m.update_block.aggregator(attn, mf, torch.float32), mf)
    with torch.no_grad():  # gamma back: a new stamp, new operands, and glob moves
        m.update_block.aggregator.gamma.fill_(0.5)
    v = fused_conv([mf], m.prepare(torch.float32)["to_v"], out_dtype=torch.float32)
    assert not torch.equal(gma.aggregate(mf, attn, v), mf)


def test_attention_rows_sum_to_one(model):
    """Both paths' attention: rows over the keys that sum to 1, peaked (the
    scaled ``to_qk``), and the kernel path's equal to the modules'."""
    inp = torch.relu(torch.randn(1, *GRID, 128, generator=torch.Generator().manual_seed(6)))
    kernel = gma.attention(inp, model.update_block.kw["qk"])
    modules = model.att(inp, torch.float32)
    n = GRID[0] * GRID[1]
    assert kernel.shape == (1, n, n) and kernel.dtype == torch.float32
    torch.testing.assert_close(kernel.sum(-1), torch.ones(1, n), rtol=0, atol=1e-5)
    # f32 products in other orders, on logits of ~100: a few 1e-5 of a row's weight
    torch.testing.assert_close(kernel, modules, rtol=0, atol=1e-4)
    entropy = -(kernel * kernel.clamp_min(1e-38).log()).sum(-1).mean()
    assert entropy < 0.5 * torch.log(torch.tensor(float(n)))


def test_state_dict_loads_under_the_published_names():
    """zacjiang/GMA's names and shapes: the attention's ``to_qk`` and relative
    position embeddings (2 * 160 - 1 rows) at the top, the aggregator in the
    update block, every GRU gate 512 channels in."""
    m = get_flow_model("gma").init_fn(0, device="cpu")
    sd = m.state_dict()
    assert sd["att.to_qk.weight"].shape == (256, 128, 1, 1)
    assert sd["att.pos_emb.rel_height.weight"].shape == sd["att.pos_emb.rel_width.weight"].shape == (319, 128)
    assert sd["att.pos_emb.rel_ind"].shape == (160, 160)
    assert sd["update_block.aggregator.to_v.weight"].shape == (128, 128, 1, 1)
    assert sd["update_block.aggregator.gamma"].shape == (1,)
    for n in "12":
        for gate in "zrq":
            assert sd[f"update_block.gru.conv{gate}{n}.weight"].shape[1] == 512
    assert not any(k.startswith("module.") for k in sd)
    fresh = get_flow_model("gma").init_fn(1, device="cpu")
    fresh.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True)
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in sd.items())


@pytest.mark.card
def test_graphed_gma_on_the_card():
    """At Sintel's size (436x1024, 32 iterations; ``python -m pytest
    --noconftest -m card tests/test_torch_gma.py``): chunks replayed from the
    graph equal the eager passes with the same warm starts, bit for bit, and
    a traced replay records the attention once and 32 aggregations, each
    with a device time read from the graph's own events."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    model = get_flow_model("gma").init_fn(3, device="cuda")
    with torch.no_grad():
        model.update_block.aggregator.gamma.fill_(0.75)
        model.att.to_qk.weight.mul_(40.0)
    g = torch.Generator(device="cuda").manual_seed(6)
    frames = (torch.rand(6, 1, 436, 1024, 3, generator=g, device="cuda") * 256).to(torch.uint8)
    flags = [True] + [False] * 5
    (flows, lows), carry = flow_chunk(model, frames[:3], {}, flags[:3], 32)  # captures, then replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (flows2, lows2), _ = flow_chunk(model, frames[3:], carry, flags[3:], 32)
    recs = spans.records()
    graph = [r for r in recs if r["name"].startswith("zt.gma.")]
    assert [r["name"] for r in graph] == (["zt.gma.attention"] + ["zt.gma.aggregate"] * 32) * 3
    assert all(r["device_ms"] > 0 and r["host_ms"] is None for r in graph)
    assert spans.counters()["raft.graph_replays"] == spans.counters()["raft.calls"] == 3
    init = torch.zeros(1, 55, 128, 2, device="cuda")
    with torch.no_grad(), numerics("highest"):
        for k, (up, low) in enumerate(zip(torch.cat([flows, flows2]), torch.cat([lows, lows2]))):
            want_low, want_up = model(frames[k].float(), frames[k + 1].float(), 32, flow_init=init)
            assert torch.equal(low, want_low) and torch.equal(up, want_up[:, 2:438]), k
            init = forward_interpolate(low)
