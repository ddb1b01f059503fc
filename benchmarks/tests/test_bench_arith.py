"""The frozen arithmetic against hand counts: FLOP, K1 bounds, trace reduction."""

import flops
import pytest
import roofline
import trace

CFG = {"frame_height": 1080, "frame_width": 1920, "of_scale": 3, "raft_iters": 12, "enh_scale": 1}


def test_3x3_layer_flops_and_bound():
    # Denoise_1 conv2: 3x3, 48 -> 48 at 1080p
    assert flops.conv(1080, 1920, (3, 3), 48, 48) == 2 * 1080 * 1920 * 9 * 48 * 48
    layer = ("d1.conv2", 3, 3, [48], 48, (1080, 1920), [], False, 1)
    f = 2.0 * 1080 * 1920 * 9 * 48 * 48
    assert roofline.k1_bound_ms(layer, "highest") == pytest.approx(f / 67e12 * 1e3)  # f32: bound by FLOP
    nbytes = 1080 * 1920 * 48 * 2 * 2 + 9 * 48 * 48 * 2
    assert roofline.k1_bound_ms(layer, "fast") == pytest.approx(max(f / 989e12, nbytes / 3.35e12) * 1e3)


def test_1x1_anchor_layer_bound():
    # Denoise_2 conv3: 1x1, 48 -> 6, anchor [H2 | s2] read once, output written once
    layer = ("d2.conv3+anchor", 1, 1, [48], 6, (1080, 1920), [3, 3], False, 1)
    px = 1080 * 1920
    nbytes = px * (48 + 6) * 4 + 48 * 6 * 4 + px * 6 * 4
    assert roofline.k1_bound_ms(layer, "highest") == pytest.approx(nbytes / 3.35e12 * 1e3)  # bound by bytes
    assert flops.conv(1080, 1920, (1, 1), 48, 6) == 2 * px * 48 * 6


def test_frame_totals():
    cfg = dict(CFG, precision="highest")
    assert roofline.k1_launches_per_frame(cfg) == 11 + 9 * 12 + 2
    assert roofline.raft_grid(cfg) == (45, 80)
    assert 1.0e12 < flops.infer_frame(cfg) < 1.05e12
    assert 2.6e12 < flops.train_step(cfg) < 2.75e12


def test_trace_window_is_the_host_span():
    # a window of 100 us with one kernel of 10 us at 50 us: 90 us idle, not 0
    events = [(trace.WINDOW, False, 0.0, 100.0), ("aten::copy_", False, 20.0, 45.0),
              ("void zt::fused_conv_kernel<float>(Slot)", True, 50.0, 60.0), ("bench.unit", False, 0.0, 99.0)]
    s = trace.summarize(events, units=1)
    assert s["window_s"] == pytest.approx(100e-6) and s["busy_s"] == pytest.approx(10e-6)
    assert s["ops"]["zt::fused_conv_kernel"] == [pytest.approx(10e-6), 1]
    idle = dict(s["idle_gaps"])
    assert idle["aten::copy_"] == pytest.approx(50e-6)  # the gap 0-50 has its midpoint inside the copy
    assert idle["bench.unit"] == pytest.approx(40e-6)


def test_trace_union_and_clip():
    events = [(trace.WINDOW, False, 10.0, 50.0), ("k", True, 0.0, 20.0), ("k", True, 15.0, 30.0),
              ("Memcpy HtoD", True, 40.0, 60.0)]
    s = trace.summarize(events, units=2)
    assert s["busy_s"] == pytest.approx(30e-6)  # 10-30 and 40-50, clipped to the window
    assert s["kernels"] == 2
