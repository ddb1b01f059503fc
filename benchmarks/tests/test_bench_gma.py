"""The GMA flow-sequence cell: it resolves to its files, its per-layer
readers read hand-built sessions and nothing of another kind, its FLOP and
roofline bounds are the hand counts, and on the CPU at a tiny size, with the
cell's own limits, ``correct`` is true for the program as it is and false
for the control (the reference on TF32 operands in the program's place) and
with each fault that ``limits/flowseq-sintel-gma-highest.json`` claims:
flowseq's four (the warm start dropped, the carry's frame left stale, half
of the iterations left out, one flow altered), the aggregation reading the
attention transposed, gamma dropped (glob = mf) and the previous pair's
attention reused. On a card (marker ``card``) each fault at the cell's own
size."""

import json

import check
import harness
import pytest
import torch
from reference.gma_sintel import GMA_PARAMS, GMASintelReference

import frames
import weights_gma
from zero_tig_torch.core import spans
from zero_tig_torch.core.precision import numerics
from zero_tig_torch.flowtools import sequence
from zero_tig_torch.flowtools.registry import prepare_raft
from zero_tig_torch.models.raft import gma

CELL = "flowseq-sintel-gma-highest"
TINY = {"frame_height": 122, "frame_width": 132, "raft_iters": 8}
FOUND = harness.find_cell(CELL)
DRIVER = harness.load_module(FOUND["driver"], "bench_driver_flowseq_gma")
READERS = ["gma_ms_per_pair.gma", "gma_roofline.gma", "raft_ms_per_pair.gma", "k1_roofline.gma", "mfu.gma",
           "idle_share.gma"]
FAULT_NAMES = harness.read_json(harness.BENCH / "limits" / f"{CELL}.json")["faults"]


def run_cell(config=None, **options):
    tr = dict(FOUND["traffic"], chunk=3, scene_frames=9, sample_chunks=2)  # 3 chunks: a stale frame shows
    return DRIVER.run(harness.Run(cell=CELL, config=config or dict(FOUND["config"], **TINY), traffic=tr,
                                  limits=FOUND["limits"], seed=2**31 + 11, seconds=0.0, device="cpu",
                                  options=options))


def test_cell_resolves():
    """The cell's files, its traffic as flowseq-c5's but for its driver file, and its six per-layer metrics."""
    assert FOUND["driver"].name == "flowseq_gma.py" and FOUND["config"]["raft_iters"] == 32
    flowseq = harness.read_json(harness.BENCH / "traffic" / "flowseq-c5.json")
    assert {k: v for k, v in FOUND["traffic"].items() if k not in ("driver", "why")} == {
        k: v for k, v in flowseq.items() if k not in ("driver", "why")}
    assert [m["name"] for m in harness.cell_metrics(CELL, "per_layer")] == READERS
    assert [m["name"] for m in harness.cell_metrics(CELL, "end_to_end")] == [
        "infer_ms_per_frame", "infer_p90_chunk_ms", "setup_s"]
    state = weights_gma.make_state(3, "cpu")
    assert {k for k, _, _ in GMA_PARAMS} < set(state)
    gamma = state["update_block.aggregator.gamma"]
    assert 0.5 <= float(gamma) <= 1.0


def test_flops_and_bounds_are_the_hand_counts():
    """At Sintel (a 55x128 grid of 7040 positions, 32 iterations): GMA's
    2.0690 TFLOP a pair, RAFT's 1.42099 and GMA's own parts; the
    mechanism's bound 6.249 ms; K1's 322 launches."""
    import flops
    import flops_gma
    import roofline_gma
    cfg = FOUND["config"]
    n, it = 55 * 128, 32
    wider = 2 * (2 * n * 5 * 128 * 256 + 2 * n * 5 * 128 * 128)
    by_hand = (1.42098694144e12 + it * wider + it * 2 * n * 128 * 128 + 2 * n * 128 * 256
               + (1 + it) * 2 * n * n * 128)
    assert flops.raft(cfg) == pytest.approx(1.42098694144e12)
    assert flops_gma.gma(cfg) == pytest.approx(by_hand) and round(by_hand / 1e12, 4) == 2.0690
    assert roofline_gma.attention_bound_ms(cfg) == pytest.approx((1 + it) * 2 * n * n * 128 / 67e12 * 1e3)
    assert round(roofline_gma.attention_bound_ms(cfg), 3) == 6.249
    rows = {r[0]: r for r in roofline_gma.k1_layers_gma(cfg)}
    assert sum(r[-1] for r in rows.values()) == 10 * it + 2
    assert rows["gma.gru.zr1"][3] == [128] * 4 and rows["gma.to_v"][-2:] == (True, it)
    # a 1x5 gate at 512 in, 256 out: FLOP-bound at the f32 peak
    assert roofline_gma.k1_bound_ms(rows["gma.gru.zr1"], "highest") == pytest.approx(
        2 * n * 5 * 512 * 256 / 67e12 * 1e3)


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "reader_" + name.replace(".", "_"))


def test_readers(monkeypatch):
    """Numbers from a hand-built session of 2 pairs (each 100 device ms in
    GMA's graph, 2 in its attention and 0.25 in each of 32 aggregations);
    none for a summary of another kind, a count of pair spans other than the
    flows, or a session without the graph spans."""
    recs = [{"name": "zt.flowseq.chunk", "parent": None, "host_ms": 210.0, "device_ms": 205.0}]
    for _ in range(2):
        pair = len(recs)
        recs += [{"name": "zt.flowseq.pair", "parent": 0, "host_ms": 102.0, "device_ms": 101.0},
                 {"name": "zt.raft", "parent": pair, "host_ms": 1.0, "device_ms": 100.0},
                 {"name": "zt.gma.attention", "parent": pair + 1, "host_ms": None, "device_ms": 2.0}]
        recs += [{"name": "zt.gma.aggregate", "parent": pair + 1, "host_ms": None, "device_ms": 0.25}] * 32
    monkeypatch.setattr(spans, "records", lambda: recs)
    cfg = FOUND["config"]
    summary = {"kind": "gma", "frames": 2, "busy_s": 0.19, "window_s": 0.2, "untraced_ms_per_frame": 103.45,
               "ops": {"zt::fused_conv_kernel": (0.1, 644)}}
    got = {name: _reader(name).read(summary, cfg) for name in READERS}
    assert got["gma_ms_per_pair.gma"] == pytest.approx(10.0)
    assert got["gma_roofline.gma"] == pytest.approx(100 * 6.249199952238806 / 10.0)
    assert got["raft_ms_per_pair.gma"] == pytest.approx(100.0)
    assert got["k1_roofline.gma"] == pytest.approx(100 * 20.962217800597013 / 50.0)
    assert got["mfu.gma"] == pytest.approx(100 * 2.06898593792e12 / (0.10345 * 67e12))
    assert got["idle_share.gma"] == pytest.approx(5.0)
    for kind in ("flowseq", "stream"):
        assert all(_reader(n).read(dict(summary, kind=kind), cfg) is None for n in READERS)
    assert all(_reader(n).read(dict(summary, frames=3), cfg) is None for n in READERS[:3])
    monkeypatch.setattr(spans, "records", lambda: [r for r in recs if r["name"] != "zt.gma.attention"])
    assert _reader("gma_ms_per_pair.gma").read(summary, cfg) is None
    assert _reader("gma_roofline.gma").read(summary, cfg) is None


def test_reference_agrees_with_the_port():
    """The benchmark's reference against the port's CPU path on the cell's seeded weights."""
    state = weights_gma.make_state(5, "cpu")
    model = DRIVER.gma_model(state, "cpu")
    pool = frames.make_video(6, 2, TINY["frame_height"], TINY["frame_width"], "cpu", dim=1.0, noise=0.0)
    init = torch.randn(1, 16, 17, 2, generator=torch.Generator().manual_seed(7))
    prepare_raft(model, "highest")
    with torch.no_grad(), numerics("highest"):
        low, up = model(pool[0].float(), pool[1].float(), 3, flow_init=init)
    ref = GMASintelReference(state)
    want_low, want = ref.pair(*(p.permute(0, 3, 1, 2).float() for p in pool), 3, init.permute(0, 3, 1, 2))
    # f32 on both sides, sums in other orders: measured ~1e-6 px on flows of ~10 px
    torch.testing.assert_close(low, want_low.permute(0, 2, 3, 1), rtol=0, atol=1e-4)
    torch.testing.assert_close(up[:, 3:125, 2:134], want.permute(0, 2, 3, 1), rtol=0, atol=1e-4)


def test_sound_run_is_correct_and_control_is_not():
    out = run_cell(controls=["tf32"])
    assert out["correct"], out["checks"]
    assert out["readings"]["init_mismatch"] == 0.0
    ok, checks = check.verdict(out["controls"]["tf32"], FOUND["limits"])
    assert not ok, checks


def _wrap(monkeypatch, fn):
    real = sequence.flow_chunk

    def chunk(model, frames, carry, flags, iters, precision):
        return fn(real, model, frames, carry, flags, iters, precision)
    monkeypatch.setattr(sequence, "flow_chunk", chunk)


def _stale_carry(monkeypatch):
    def fn(real, model, frames, carry, flags, iters, precision):
        out, new = real(model, frames, carry, flags, iters, precision)
        return out, dict(new, frame=carry.get("frame", new["frame"]))
    _wrap(monkeypatch, fn)


def _altered(monkeypatch):
    def fn(real, *args):
        (flows, lows), carry = real(*args)
        flows = flows.clone()
        flows[-1, 0, 0, 0, 0] += 1.0
        return (flows, lows), carry
    _wrap(monkeypatch, fn)


def _aggregate(monkeypatch, fn):
    real = gma.aggregate
    monkeypatch.setattr(gma, "aggregate", lambda mf, attn, v: fn(real, mf, attn, v))


def _attn_stale(monkeypatch):
    """Each pass reads the attention the pass before it computed (its own on
    the first): a buffer outside the graph's pool, so a replay does too."""
    real, held = gma.attention, []

    def attention(inp, qk):
        new = real(inp, qk)
        if not held:
            held.append(new.clone())
        old = held[0].clone()
        held[0].copy_(new)
        return old
    monkeypatch.setattr(gma, "attention", attention)


FAULTS = {
    "warm_dropped": lambda mp: mp.setattr(sequence, "forward_interpolate", torch.zeros_like),
    "stale_carry": _stale_carry,
    "half_iters": lambda mp: _wrap(mp, lambda real, model, frames, carry, flags, iters, precision:
                                   real(model, frames, carry, flags, iters // 2, precision)),
    "altered": _altered,
    "attn_transposed": lambda mp: _aggregate(mp, lambda real, mf, attn, v: real(mf, attn.transpose(1, 2), v)),
    "gamma_dropped": lambda mp: _aggregate(mp, lambda real, mf, attn, v: mf.float()),
    "attn_stale": _attn_stale,
}


@pytest.mark.parametrize("fault", FAULT_NAMES)
def test_fault_is_caught(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not run_cell()["correct"]


def test_faults_claimed_are_planted():
    assert set(FAULT_NAMES) == set(FAULTS)


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULT_NAMES)
def test_fault_is_caught_on_the_card(fault, monkeypatch):
    """At the cell's own size, one whole scene (``seconds`` 0); prints the readings."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    FAULTS[fault](monkeypatch)
    tr = FOUND["traffic"]
    out = DRIVER.run(harness.Run(cell=CELL, config=FOUND["config"], traffic=tr, limits=FOUND["limits"],
                                 seed=2**31 + 29, seconds=0.0, min_units=tr["scene_frames"] // tr["chunk"]))
    print(json.dumps({"fault": fault, "readings": out["readings"]}))
    assert not out["correct"]


def test_references_import_nothing_of_the_port():
    """GMA's benchmark reference and the repository's plain reference load neither JAX nor the port."""
    from test_bench_imports import top_level
    code = (f"import json, sys\nsys.path[:0] = [{str(harness.BENCH)!r}, {str(harness.ROOT)!r}]\n"
            "import reference.gma_sintel, plain_reference.gma_sintel\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    assert not top_level(code) & {"jax", "jaxlib", "flax", "zero_tig_tpu", "zero_tig_torch"}
