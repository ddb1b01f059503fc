"""The port's native frame pipeline (``native/frameio.cc`` through
``native/frameio.py``) on the CPU: the same bits as the JAX package's
native loader on PNG and JPEG, at the frame's size and resized (bicubic and
bilinear); ordered pipeline output and a corrupt file; the datasets under
``ZERO_TIG_NATIVE_IO=1``; a failed build raises."""

import numpy as np
import pytest
from PIL import Image

from zero_tig_tpu import native as jax_native
from zero_tig_torch import native
from zero_tig_torch.data import create_dataset, make_rlv_fixture
from zero_tig_torch.native import frameio


@pytest.fixture()
def images(tmp_path):
    rng = np.random.default_rng(3)
    img = (rng.random((30, 44, 3)) * 255).astype(np.uint8)
    png, jpg = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    native.write_png(png, img)
    Image.fromarray(img).save(jpg, quality=95)
    return img, png, jpg


def test_loaders_match_the_jax_native_loader(images):
    img, png, jpg = images
    assert jax_native.available(), jax_native.build_error()
    np.testing.assert_array_equal(frameio.load_frame_u8(png, 44, 30), img)  # identity: the decoded bytes
    # the C++ normalises by multiplying with 1/255 (JAX tests/test_native.py:35-38)
    np.testing.assert_allclose(frameio.load_frame(png, 44, 30), img.astype(np.float32) / 255.0, atol=1e-7)
    for path in (png, jpg):
        for w, h in ((44, 30), (64, 48), (20, 14)):
            for mode in (frameio.MODE_BICUBIC, frameio.MODE_BILINEAR):
                got, ref = frameio.load_frame(path, w, h, mode=mode), jax_native.load_frame(path, w, h, mode=mode)
                assert got.shape == (h, w, 3) and got.dtype == np.float32
                np.testing.assert_array_equal(got, ref, err_msg=f"{path} {w}x{h} mode {mode}")
                np.testing.assert_array_equal(frameio.load_frame_u8(path, w, h, mode=mode),
                                              jax_native.load_frame_u8(path, w, h, mode=mode))


def test_pipeline_keeps_order_and_raises_on_a_corrupt_file(images, tmp_path):
    img, png, jpg = images
    paths = [png, jpg] * 5
    want = [frameio.load_frame_u8(p, 64, 48) for p in paths]
    got = list(frameio.NativePipeline(paths, 64, 48, threads=3, capacity=2, out_u8=True))
    assert len(got) == len(paths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    floats = list(frameio.NativePipeline(paths[:3], 44, 30, threads=2))
    np.testing.assert_array_equal(floats[0], frameio.load_frame(png, 44, 30))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)
    pipe = frameio.NativePipeline([png, str(bad), png], 44, 30, out_u8=True)
    assert next(pipe).shape == (30, 44, 3)
    with pytest.raises(IOError, match="bad.png"):
        next(pipe)
    pipe.close()
    with pytest.raises(IOError):
        frameio.load_frame(str(tmp_path / "missing.png"), 44, 30)


def test_native_io_dataset_yields_the_codec_frames(tmp_path, monkeypatch):
    root = make_rlv_fixture(str(tmp_path / "rlv"), frames_per_scene=3, size=(64, 48))
    plain = list(create_dataset("RLV", root, "train", size=(64, 48)).iter_u8())
    monkeypatch.setenv("ZERO_TIG_NATIVE_IO", "1")
    ds = create_dataset("RLV", root, "train", size=(64, 48))
    assert ds.native_io
    fast = list(ds.iter_u8())
    assert [r.path for r in fast] == [r.path for r in plain] and len(fast) == 6
    assert [r.is_new_seq for r in fast] == [r.is_new_seq for r in plain] == [True, False, False] * 2
    for a, b in zip(fast, plain):
        assert a.image.dtype == np.uint8
        np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_allclose(ds.load_image(plain[0].path), plain[0].image.astype(np.float32) / 255.0, atol=1e-7)


def test_failed_build_raises(tmp_path, monkeypatch):
    # no fallback: the compiler's failure reaches the caller
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(frameio, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no" / "g++"))
    with pytest.raises(RuntimeError, match="building frameio.cc"):
        frameio.library()
    broken = tmp_path / "frameio.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(frameio, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="building frameio.cc failed"):
        frameio.library()
