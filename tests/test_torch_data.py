"""The port's host side against the JAX package's, on the CPU: the PNG codec,
the synthetic fixture, the datasets, the staging of frames, and the
evaluation metrics (PSNR, SSIM, histogram match, the ground truth's bicubic
resize, LPIPS). Frames are 64x48, the fixture 2 scenes x 3 frames."""

import glob
import io
import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import zero_tig_tpu.data as jdata
from zero_tig_tpu.eval import lpips as jlpips
from zero_tig_tpu.eval import metrics as jmetrics
from zero_tig_torch import native
from zero_tig_torch.cli.evals import resize_cubic
from zero_tig_torch.data import (
    ChunkRecord,
    DeviceRecord,
    FrameRecord,
    chunk_prefetch,
    create_dataset,
    device_prefetch,
    gt_path_for,
    make_rlv_fixture,
)
from zero_tig_torch.eval import lpips as tlpips
from zero_tig_torch.eval import metrics as tmetrics

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

SIZE = (64, 48)  # (W, H)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The port's and the JAX package's fixtures, with and without the occluder."""
    root = tmp_path_factory.mktemp("fixtures")
    out = {}
    for occ in (False, True):
        for name, make in (("port", make_rlv_fixture), ("jax", jdata.make_rlv_fixture)):
            out[name, occ] = make(str(root / f"{name}_{occ}"), size=SIZE, occluder=occ)
    return out


def _png_files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*.png"), recursive=True))


@pytest.mark.parametrize("occluder", [False, True])
def test_fixture_matches_jax(fixtures, occluder):
    # the same files, decoded (by OpenCV) to the same pixels: the blur in
    # float32 may round one level apart on at most 0.01% of the bytes
    port, ref = fixtures["port", occluder], fixtures["jax", occluder]
    files = _png_files(port)
    assert files == _png_files(ref) and len(files) == 12
    diff, total = 0, 0
    for f in files:
        a = cv2.imread(os.path.join(port, f)).astype(int)
        b = cv2.imread(os.path.join(ref, f)).astype(int)
        assert np.abs(a - b).max() <= 1, f
        diff, total = diff + int((a != b).sum()), total + a.size
    assert diff <= 1e-4 * total
    for lst in ("train_list.txt", "test_list.txt"):
        with open(os.path.join(port, lst)) as fa, open(os.path.join(ref, lst)) as fb:
            assert fa.read() == fb.read()


def _layout(root, kind, src):
    """A DID, SDSD or generic layout made of the fixture's frames."""
    frames = sorted(glob.glob(os.path.join(src, "input", "*", "low_light_10", "*.png")))
    if kind == "DID":
        for f in frames:
            scene = f.split(os.sep)[-3]
            os.makedirs(os.path.join(root, "input", scene), exist_ok=True)
            shutil.copy(f, os.path.join(root, "input", scene, os.path.basename(f)))
        for lst in ("train_list.txt", "test_list.txt"):
            shutil.copy(os.path.join(src, lst), os.path.join(root, lst))
    elif kind == "SDSD":
        for subset, prefix in (("indoor", "in"), ("outdoor", "out")):
            pairs = []
            for i, f in enumerate(frames[:3] if subset == "indoor" else frames[3:]):
                pair = f"pair{i + 1}"
                d = os.path.join(root, subset, f"{subset}_png", pair)
                os.makedirs(d)
                shutil.copy(f, os.path.join(d, f"{i + 1}.png"))
                shutil.copy(f, os.path.join(d, f"{i + 1}_gt.png"))
                pairs.append(pair)
            for task in ("train", "test"):
                with open(os.path.join(root, f"sdsd_{prefix}_{task}.txt"), "w") as fh:
                    fh.write("\n".join(pairs) + "\n")
    else:
        shutil.copytree(os.path.join(src, "input"), os.path.join(root, "input"))
    return str(root)


@pytest.mark.parametrize("kind", ["RLV", "DID", "SDSD", "underwater"])
def test_create_dataset_matches_jax(fixtures, tmp_path, kind):
    # paths, names, is_new_seq flags and bytes, over two epochs (the first
    # record of epoch 2 compares with the last of epoch 1)
    src = fixtures["jax", True]
    root = src if kind == "RLV" else _layout(tmp_path / kind, kind, src)
    for task in ("train", "test"):
        port = create_dataset(kind, root, task, size=SIZE)
        ref = jdata.create_dataset(kind, root, task, size=SIZE)
        assert port.paths == ref.paths and len(port) >= 6
        for _ in range(2):
            got, want = list(port.iter_u8()), list(ref.iter_u8())
            assert [(r.path, r.name, r.is_new_seq) for r in got] == [(r.path, r.name, r.is_new_seq) for r in want]
            for a, b in zip(got, want):
                assert a.image.dtype == np.uint8 and np.array_equal(a.image, b.image)
        flags = [r.is_new_seq for r in port]
        assert flags == [r.is_new_seq for r in ref]
    assert gt_path_for(port.paths[0]) == jdata.gt_path_for(port.paths[0])


def test_off_size_frames_take_pillows_resize_as_jax(fixtures, tmp_path):
    # frames at another size than the target: Pillow's antialiased bicubic,
    # byte for byte; a JPEG frame goes through Pillow too
    src = fixtures["jax", False]
    for target in ((40, 30), (96, 72)):
        port = create_dataset("RLV", src, "test", size=target)
        ref = jdata.create_dataset("RLV", src, "test", size=target)
        for a, b in zip(port.iter_u8(), ref.iter_u8()):
            assert a.image.shape == (target[1], target[0], 3) and np.array_equal(a.image, b.image)
    d = tmp_path / "input" / "S01"
    d.mkdir(parents=True)
    Image.fromarray(native.read_rgb(port.paths[0])).save(d / "00000.jpg", quality=90)
    for name in ("train_list.txt", "test_list.txt"):
        (tmp_path / name).write_text("S01\n")
    a = next(create_dataset("DID", str(tmp_path), "test", size=SIZE).iter_u8()).image
    b = next(jdata.create_dataset("DID", str(tmp_path), "test", size=SIZE).iter_u8()).image
    assert np.array_equal(a, b)


def test_jpeg_and_resize_without_pillow_raise(fixtures, tmp_path, monkeypatch):
    src = fixtures["port", False]
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now fails
    ds = create_dataset("RLV", src, "test", size=(32, 24))
    with pytest.raises(ImportError, match="Pillow is needed"):
        next(ds.iter_u8())
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="Pillow is needed"):
        native.read_rgb(tmp_path / "x.jpg")
    # PNG frames at the target size need no Pillow
    assert next(create_dataset("RLV", src, "test", size=SIZE).iter_u8()).image.shape == (48, 64, 3)


def _png(rows_filtered: np.ndarray, w: int, h: int, ch: int, color: int, depth=8, interlace=0) -> bytes:
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (native.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"tEXt", b"Comment\x00x")
            + chunk(b"IDAT", zlib.compress(rows_filtered.tobytes())) + chunk(b"IEND", b""))


def _filter_rows(img: np.ndarray, types) -> np.ndarray:
    """The PNG row filters, vectorised: row y filtered with types[y]."""
    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int32)
    up = np.vstack([np.zeros((1, w * ch), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, ch), np.int32), x[:, :-ch]])
    upleft = np.hstack([np.zeros((h, ch), np.int32), up[:, :-ch]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: paeth}
    out = np.empty((h, 1 + w * ch), np.uint8)
    for y, t in enumerate(types):
        out[y, 0] = t
        out[y, 1:] = ((x[y] - (pred[t][y] if t else 0)) % 256).astype(np.uint8)
    return out


@pytest.mark.parametrize("ch,color", [(1, 0), (3, 2), (4, 6)])
def test_png_decoder_undoes_every_filter(ch, color):
    # a hand-built file whose rows use each of the five filters in turn,
    # against Pillow's decode
    rng = np.random.default_rng(ch)
    h, w = 23, 17
    img = np.clip(np.cumsum(rng.integers(-20, 21, (h, w, ch)), axis=1) + 128, 0, 255).astype(np.uint8)
    data = _png(_filter_rows(img, [y % 5 for y in range(h)]), w, h, ch, color)
    got = native.decode_png(data)
    assert np.array_equal(got, img)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(native.to_rgb(got), ref)


def test_png_decoder_reads_opencv_and_pillow_files(fixtures, tmp_path):
    # both writers filter adaptively; the frames are those of the fixture
    rng = np.random.default_rng(0)
    img = np.clip(np.cumsum(rng.normal(0, 9, (48, 64, 3)), axis=1) + 100, 0, 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "cv.png"), img[..., ::-1])
    Image.fromarray(img).save(tmp_path / "pil.png")
    Image.fromarray(img).convert("RGBA").save(tmp_path / "rgba.png")
    Image.fromarray(img[..., 0]).save(tmp_path / "gray.png")
    for name in ("cv.png", "pil.png", "rgba.png", "gray.png"):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        assert np.array_equal(native.read_rgb(tmp_path / name), want), name
    for f in _png_files(fixtures["jax", True]):
        path = os.path.join(fixtures["jax", True], f)
        assert np.array_equal(native.read_rgb(path), np.asarray(Image.open(path).convert("RGB"))), f


def test_png_encoder_round_trips(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    native.write_png(tmp_path / "a.png", img)
    assert np.array_equal(native.read_rgb(tmp_path / "a.png"), img)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    assert np.array_equal(cv2.imread(str(tmp_path / "a.png"))[..., ::-1], img)
    with pytest.raises(ValueError, match="uint8"):
        native.encode_png(img.astype(np.float32))


@pytest.mark.parametrize("depth,color,interlace", [(16, 2, 0), (8, 3, 0), (8, 2, 1), (8, 4, 0)])
def test_png_decoder_rejects_what_it_does_not_read(depth, color, interlace):
    data = _png(np.zeros((2, 1 + 6 * 4), np.uint8), 2, 2, 3, color, depth, interlace)
    with pytest.raises(ValueError, match="unsupported PNG"):
        native.decode_png(data)
    bad = _png(np.full((2, 7), 9, np.uint8), 2, 2, 3, 2)
    with pytest.raises(ValueError, match="filter type"):
        native.decode_png(bad)


def test_png_codec_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "pngio.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building pngio.cpp failed"):
        native.build()


def _records(n, h=6, w=8, fail_at=None):
    rng = np.random.default_rng(n)
    for i in range(n):
        if i == fail_at:
            raise FileNotFoundError(f"frame {i}")
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        yield FrameRecord(img, f"{i:05d}", f"/s/{i:05d}.png", i % 3 == 0)


def test_chunk_prefetch_on_the_cpu():
    got = list(chunk_prefetch(_records(7), 3, device="cpu"))
    assert [type(x) for x in got] == [ChunkRecord, ChunkRecord, DeviceRecord]
    want = list(_records(7))
    for c, recs in zip(got[:2], (want[:3], want[3:6])):
        assert c.images.shape == (3, 1, 6, 8, 3) and c.images.dtype == torch.float32
        assert c.flags.dtype == torch.bool and c.flags.tolist() == [r.is_new_seq for r in recs]
        u8 = np.stack([r.image for r in recs])[:, None]
        assert torch.equal(c.images, torch.from_numpy(u8).float() / 255.0)
        assert [r.name for r in c.records] == [r.name for r in recs]
    tail = got[2]
    assert tail.image.shape == (1, 6, 8, 3) and tail.name == "00006" and tail.is_new_seq is (6 % 3 == 0)
    assert torch.equal(tail.image, torch.from_numpy(want[6].image[None]).float() / 255.0)
    # k = 1 is frame by frame: device_prefetch, the staging of the eval loops
    assert [type(x) for x in chunk_prefetch(_records(4), 1, device="cpu")] == [DeviceRecord] * 4
    frames = list(device_prefetch(_records(7), device="cpu"))
    assert [(f.name, f.is_new_seq) for f in frames] == [(r.name, r.is_new_seq) for r in want]
    assert all(torch.equal(f.image, torch.from_numpy(r.image[None]).float() / 255.0) for f, r in zip(frames, want))


@pytest.mark.parametrize("k", [1, 3])
def test_prefetch_worker_error_reaches_the_consumer(k):
    it = chunk_prefetch(_records(8, fail_at=5), k, device="cpu", depth=1)
    with pytest.raises(FileNotFoundError, match="frame 5"):
        for _ in it:
            pass
    # a consumer that stops early ends the worker thread
    first = next(iter(chunk_prefetch(_records(50), 2, device="cpu", depth=1)))
    assert isinstance(first, ChunkRecord)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    out01 = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    gt01 = np.clip(out01 + rng.normal(0, 0.1, out01.shape), 0, 1).astype(np.float32)
    a, b = tmetrics.to_uint8(out01), tmetrics.to_uint8(gt01)
    assert np.array_equal(a, jmetrics.to_uint8(out01))
    assert tmetrics.psnr_uint8(a, b) == jmetrics.psnr_uint8(a, b)
    assert tmetrics.ssim_uint8(a, b) == jmetrics.ssim_uint8(a, b)
    assert np.array_equal(tmetrics.match_histograms(out01, gt01), jmetrics.match_histograms(out01, gt01))
    assert tmetrics.frame_metrics(out01, gt01) == jmetrics.frame_metrics(out01, gt01)


@pytest.mark.parametrize("src,dst", [((48, 64), (36, 50)), ((30, 40), (48, 64))])
def test_gt_bicubic_resize_matches_opencv(src, dst):
    # evals' resize of a ground truth of another size: cv2.INTER_CUBIC on f32
    img = np.random.default_rng(4).uniform(0, 1, (*src, 3)).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(resize_cubic(img, dst), want, atol=1e-5, rtol=0)


def test_lpips_matches_jax(tmp_path):
    # random VGG and head weights in the JAX package's npz format, 32x32
    rng = np.random.default_rng(5)
    arrays, cin = {}, 3
    for i, cout in enumerate(c for c in jlpips._VGG_CFG if c != "M"):
        arrays[f"conv{i}_w"] = (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2 / (9 * cin))).astype(np.float32)
        arrays[f"conv{i}_b"] = (rng.standard_normal(cout) * 0.01).astype(np.float32)
        cin = cout
    for j, ch in enumerate(jlpips._LIN_CHANNELS):
        arrays[f"lin{j}_w"] = rng.random((1, 1, ch, 1)).astype(np.float32)
    path = tmp_path / "lpips_weights.npz"
    np.savez(path, **arrays)
    out01 = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    gt01 = np.clip(out01 + rng.normal(0, 0.2, out01.shape), 0, 1).astype(np.float32)
    want = jlpips.LPIPSScorer(str(path))(out01, gt01)
    scorer = tlpips.LPIPSScorer.maybe_load(str(path), device="cpu")
    got = scorer(out01, gt01)
    assert want > 0 and abs(got - want) <= 1e-5 * abs(want)
    assert scorer(out01, out01) == 0.0
    assert tlpips.LPIPSScorer.maybe_load(None) is None
