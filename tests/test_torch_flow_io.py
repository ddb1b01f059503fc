"""The port's flow file IO, flow visualisation, flow metrics and utility
helpers against the JAX package's, on the same numpy inputs (CPU).

Files one package writes are read by the other, bit for bit; the KITTI
16-bit PNGs the JAX package writes come from OpenCV and go through the
port's 16-bit PNG decoder."""

import cv2
import numpy as np
import pytest
import torch

from zero_tig_tpu.flowtools.metrics import flow_metrics as j_flow_metrics
from zero_tig_tpu.utils import flow_io as j_io
from zero_tig_tpu.utils import misc as j_misc
from zero_tig_tpu.utils.flow_viz import flow_to_image as j_flow_to_image
from zero_tig_torch import native
from zero_tig_torch.flowtools.metrics import flow_metrics
from zero_tig_torch.utils import flow_io, misc
from zero_tig_torch.utils.flow_viz import flow_to_image

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)


def test_flow_files_read_across_packages_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 20, (13, 17, 2)).astype(np.float32)
    for name, writers, readers in (
        ("flo", (j_io.write_flo, flow_io.write_flo), (j_io.read_flo, flow_io.read_flo)),
        ("pfm", (j_io.write_pfm, flow_io.write_pfm), (j_io.read_pfm, flow_io.read_pfm)),
    ):
        for data in ((flow,) if name == "flo" else (rng.normal(0, 1, (13, 17, 3)).astype(np.float32), flow[..., 0])):
            paths = [tmp_path / f"{pkg}.{name}" for pkg in ("jax", "port")]
            for write, path in zip(writers, paths):
                write(str(path), data)
            assert paths[0].read_bytes() == paths[1].read_bytes(), name
            for read in readers:
                np.testing.assert_array_equal(read(str(paths[0])), data)

    # KITTI: flow = (uint16 - 2^15) / 64, valid in the third channel
    kitti = rng.uniform(-300, 300, (13, 17, 2)).astype(np.float32)
    j_io.write_flow_kitti(str(tmp_path / "jax.png"), kitti)  # OpenCV's 16-bit PNG
    flow_io.write_flow_kitti(str(tmp_path / "port.png"), kitti)  # the port's codec
    for path in (tmp_path / "jax.png", tmp_path / "port.png"):
        ref_flow, ref_valid = j_io.read_flow_kitti(str(path))
        got_flow, got_valid = flow_io.read_flow_kitti(str(path))
        np.testing.assert_array_equal(got_flow, ref_flow)
        np.testing.assert_array_equal(got_valid, ref_valid)
        assert np.all(got_valid == 1)
        assert np.abs(got_flow - kitti).max() <= 1 / 64  # 16-bit quantisation
    # the 16-bit codec round-trips every value; the 8-bit frame decoder refuses it
    raw = rng.integers(0, 65536, (9, 11, 3)).astype(np.uint16)
    np.testing.assert_array_equal(native.decode_png16(native.encode_png16(raw)), raw)
    with pytest.raises(ValueError, match="unsupported PNG"):
        native.decode_png(native.encode_png16(raw))


def test_read_gen_matches_jax_on_png_ppm_flo_pfm(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img[..., ::-1])
    cv2.imwrite(str(tmp_path / "a.ppm"), img[..., ::-1])  # FlyingChairs frames are binary PPM
    assert (tmp_path / "a.ppm").read_bytes()[:2] == b"P6"
    flow = rng.normal(0, 5, (19, 23, 2)).astype(np.float32)
    j_io.write_flo(str(tmp_path / "a.flo"), flow)
    j_io.write_pfm(str(tmp_path / "a.pfm"), rng.normal(0, 5, (19, 23, 3)).astype(np.float32))
    for name in ("a.png", "a.ppm", "a.flo", "a.pfm"):
        ref = j_io.read_gen(str(tmp_path / name))
        got = flow_io.read_gen(str(tmp_path / name))
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_array_equal(flow_io.read_gen(str(tmp_path / "a.ppm")), img)
    with pytest.raises(ValueError, match="unsupported extension"):
        flow_io.read_gen(str(tmp_path / "a.tif"))


def test_flow_to_image_matches_jax():
    rng = np.random.default_rng(2)
    flows = [rng.normal(0, 8, (21, 34, 2)).astype(np.float32), np.zeros((5, 6, 2), np.float32)]
    for flow in flows:
        for kw in ({}, {"clip_flow": 3.0}, {"convert_to_bgr": True}):
            ref = j_flow_to_image(flow, **kw)
            got = flow_to_image(flow, **kw)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, ref)


def test_flow_metrics_and_forward_interpolate_match_jax():
    rng = np.random.default_rng(3)
    gt = rng.normal(0, 10, (24, 30, 2)).astype(np.float32)
    pred = gt + rng.normal(0, 2, gt.shape).astype(np.float32)
    valid = rng.random((24, 30)) > 0.3
    for v in (None, valid, np.zeros_like(valid)):
        ref, got = j_flow_metrics(pred, gt, v), flow_metrics(pred, gt, v)
        assert set(got) == {"epe", "fl_all", "px1", "wauc"}
        np.testing.assert_array_equal([got[k] for k in sorted(got)], [ref[k] for k in sorted(ref)])
    flow = rng.normal(0, 3, (2, 16, 20)).astype(np.float32)
    ref = j_misc.forward_interpolate(flow)
    np.testing.assert_array_equal(misc.forward_interpolate(flow), ref)
    np.testing.assert_array_equal(misc.forward_interpolate(torch.from_numpy(flow)), ref)
    far = np.full((2, 4, 5), 100.0, np.float32)  # every point leaves the frame
    np.testing.assert_array_equal(misc.forward_interpolate(far), j_misc.forward_interpolate(far))


def test_misc_helpers_match_jax(tmp_path):
    # parameter counts: a state dict as a JAX tree, the exclusion by name
    rng = np.random.default_rng(4)
    tree = {"enc": {"kernel": rng.normal(size=(3, 3, 4, 8))}, "auxiliary_head": {"bias": rng.normal(size=(7,))}}
    sd = {"enc.weight": torch.zeros(8, 4, 3, 3), "auxiliary_head.bias": torch.zeros(7)}
    assert misc.count_parameters_in_mb(sd) == j_misc.count_parameters_in_mb(tree) == 288e-6
    assert misc.count_parameters_in_mb(sd, exclude_substr="") == j_misc.count_parameters_in_mb(tree, exclude_substr="")
    shared = torch.nn.Conv2d(4, 8, 3)  # one module under two names counts once
    assert misc.count_parameters_in_mb(torch.nn.ModuleDict({"a": shared, "b": shared})) == 296e-6

    # contact sheet and overlay: the port's codec and F.interpolate for OpenCV
    pics = [rng.uniform(0, 1, (1, 12, 16, 3)).astype(np.float32), rng.uniform(0, 1, (1, 12, 16, 1)).astype(np.float32)]
    j_misc.show_pic(pics, ["a", "b"], str(tmp_path / "jax_sheet.png"), grid=(1, 2))
    misc.show_pic([torch.from_numpy(p) for p in pics], ["a", "b"], str(tmp_path / "sheet.png"), grid=(1, 2))
    np.testing.assert_array_equal(native.read_rgb(tmp_path / "sheet.png"), native.read_rgb(tmp_path / "jax_sheet.png"))
    img = rng.uniform(0, 1, (1, 24, 32, 3)).astype(np.float32)
    flow = rng.normal(0, 4, (1, 12, 16, 2)).astype(np.float32)
    j_misc.viz_flow_overlay(img, flow, str(tmp_path / "jax_overlay.png"))
    misc.viz_flow_overlay(torch.from_numpy(img), torch.from_numpy(flow), str(tmp_path / "overlay.png"))
    got = native.read_rgb(tmp_path / "overlay.png").astype(int)
    ref = native.read_rgb(tmp_path / "jax_overlay.png").astype(int)
    assert got.shape == ref.shape == (48, 32, 3)
    np.testing.assert_array_equal(got[:24], ref[:24])
    assert np.abs(got - ref).max() <= 1  # OpenCV's 11-bit fixed-point bilinear against f32 rounded

    # drop_path: each sample kept whole with 1/keep, the draws from the generator
    x = torch.ones(256, 2, 3)
    a = misc.drop_path(x, 0.25, torch.Generator().manual_seed(5))
    b = misc.drop_path(x, 0.25, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and misc.drop_path(x, 0.0, None) is x
    kept = a[:, 0, 0] > 0
    assert torch.all(a[kept] == 1 / 0.75) and torch.all(a[~kept] == 0) and 150 < int(kept.sum()) < 230
