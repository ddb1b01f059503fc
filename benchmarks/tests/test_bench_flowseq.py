"""The flow-sequence cell on the CPU at a tiny size, with its own limits:
``correct`` true for the program as it is, false for the control (the
reference on TF32 operands in the program's place) and false with each fault
that ``limits/flowseq-sintel-highest.json`` claims planted under the timed
path: the warm start dropped, the carry's frame left stale, half of the
iterations left out, one flow altered where it is produced. Besides: the
benchmark's reference against the port's CPU path, and the new readers on
hand-built sessions."""

import check
import harness
import pytest
import torch
from reference.raft_sintel import RAFTSintelReference, forward_interpolate

import frames
import weights
from zero_tig_torch.core import spans
from zero_tig_torch.core.precision import numerics
from zero_tig_torch.flowtools import sequence
from zero_tig_torch.flowtools.registry import prepare_raft

CELL = "flowseq-sintel-highest"
TINY = {"frame_height": 122, "frame_width": 132, "raft_iters": 16}  # enough for the TF32 control to show
FOUND = harness.find_cell(CELL)
DRIVER = harness.load_module(FOUND["driver"], "bench_driver_flowseq")
READERS = ["idle_share.flowseq", "mfu.flowseq", "k1_roofline.flowseq", "raft_ms_per_pair.flowseq",
           "warm_ms_per_pair.flowseq", "warm_share.flowseq"]


def run_cell(**options):
    tr = dict(FOUND["traffic"], chunk=3, scene_frames=9, sample_chunks=2)  # 3 chunks: a stale frame shows
    return DRIVER.run(harness.Run(cell=CELL, config=dict(FOUND["config"], **TINY), traffic=tr,
                                  limits=FOUND["limits"], seed=2**31 + 11, seconds=0.0, device="cpu",
                                  options=options))


def test_sound_run_is_correct_and_control_is_not():
    out = run_cell(controls=["tf32"])
    assert out["correct"], out["checks"]
    assert out["readings"]["init_mismatch"] == 0.0
    ok, checks = check.verdict(out["controls"]["tf32"], FOUND["limits"])
    assert not ok, checks


def _warm_dropped(monkeypatch):
    monkeypatch.setattr(sequence, "forward_interpolate", torch.zeros_like)


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


def _half_iters(monkeypatch):
    _wrap(monkeypatch, lambda real, model, frames, carry, flags, iters, precision:
          real(model, frames, carry, flags, iters // 2, precision))


def _altered(monkeypatch):
    def fn(real, *args):
        (flows, lows), carry = real(*args)
        flows = flows.clone()
        flows[-1, 0, 0, 0, 0] += 1.0
        return (flows, lows), carry
    _wrap(monkeypatch, fn)


FAULTS = {"warm_dropped": _warm_dropped, "stale_carry": _stale_carry, "half_iters": _half_iters,
          "altered": _altered}


@pytest.mark.parametrize("fault", harness.read_json(harness.BENCH / "limits" / f"{CELL}.json")["faults"])
def test_fault_is_caught(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not run_cell()["correct"]


def test_reference_agrees_with_the_port():
    state = weights.make_state(5, "cpu")
    model = DRIVER.raft_model(state, "cpu")
    pool = frames.make_video(6, 2, TINY["frame_height"], TINY["frame_width"], "cpu", dim=1.0, noise=0.0)
    init = torch.randn(1, 16, 17, 2, generator=torch.Generator().manual_seed(7))
    prepare_raft(model, "highest")
    with torch.no_grad(), numerics("highest"):
        low, up = model(pool[0].float(), pool[1].float(), 3, flow_init=init)
    ref = RAFTSintelReference(state)
    want_low, want = ref.pair(*(p.permute(0, 3, 1, 2).float() for p in pool), 3, init.permute(0, 3, 1, 2))
    # f32 on both sides, sums in other orders: measured ~1e-6 px on flows of ~10 px
    torch.testing.assert_close(low, want_low.permute(0, 2, 3, 1), rtol=0, atol=1e-4)
    torch.testing.assert_close(up[:, 3:125, 2:134], want.permute(0, 2, 3, 1), rtol=0, atol=1e-4)
    assert torch.equal(forward_interpolate(low.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                       sequence.forward_interpolate(low))


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "reader_" + name.replace(".", "_"))


def test_readers(monkeypatch):
    """Numbers from a hand-built session of 2 pairs (each 60 device ms in
    RAFT and 0.5 in the warm start, both warm); none for another kind, a
    count of pair spans other than the flows, or a program without them."""
    recs = [{"name": "zt.flowseq.chunk", "parent": None, "host_ms": 130.0, "device_ms": 125.0}]
    for _ in range(2):
        recs += [{"name": "zt.flowseq.pair", "parent": 0, "host_ms": 62.0, "device_ms": 61.0},
                 {"name": "zt.raft", "parent": len(recs), "host_ms": 1.0, "device_ms": 60.0},
                 {"name": "zt.flowseq.warm", "parent": len(recs), "host_ms": 0.3, "device_ms": 0.5}]
    monkeypatch.setattr(spans, "records", lambda: recs)
    monkeypatch.setattr(spans, "counters", lambda: {"flowseq.pairs": 2, "flowseq.warm_starts": 2})
    cfg = FOUND["config"]
    summary = {"kind": "flowseq", "frames": 2, "busy_s": 0.09, "window_s": 0.1, "untraced_ms_per_frame": 70.0,
               "ops": {"zt::fused_conv_kernel": (0.09, 580)}}
    got = {name: _reader(name).read(summary, cfg) for name in READERS}
    assert got["raft_ms_per_pair.flowseq"] == pytest.approx(60.0)
    assert got["warm_ms_per_pair.flowseq"] == pytest.approx(0.5)
    assert got["warm_share.flowseq"] == pytest.approx(100.0)
    assert got["idle_share.flowseq"] == pytest.approx(10.0)
    assert got["mfu.flowseq"] == pytest.approx(100 * 1.42098694144e12 / (0.07 * 67e12))
    assert got["k1_roofline.flowseq"] == pytest.approx(100 * 17.54667711044776 / 45.0)
    for other in ({"kind": "stream", "frames": 2}, dict(summary, frames=3)):
        assert all(_reader(n).read(dict(summary, **other), cfg) is None
                   for n in READERS if n.startswith(("raft_", "warm_")))
    assert all(_reader(n).read({"kind": "stream", "frames": 2}, cfg) is None for n in READERS)


def test_references_import_nothing_of_the_port():
    """The benchmark's copy and the repository's plain reference load neither JAX nor the port."""
    from test_bench_imports import top_level
    code = (f"import json, sys\nsys.path[:0] = [{str(harness.BENCH)!r}, {str(harness.ROOT)!r}]\n"
            "import reference.raft_sintel, plain_reference.raft_sintel\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    assert not top_level(code) & {"jax", "jaxlib", "flax", "zero_tig_tpu", "zero_tig_torch"}
