"""The port's inbox daemon (``cli/serve.py``) on the CPU, on the JAX
package's serve fixture (2 scenes x 3 frames of 64x48, of_scale 2, 2 RAFT
iterations, JAX tests/test_serve.py:17-25) and a ``.pt`` of seeded weights:
its PNGs against the JAX daemon's, the idempotent resume, a late frame that
continues its scene, the STOP file, the chunked backlog against the
per-frame path, an off-size frame, and no card."""

import functools
import glob
import json
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

import zero_tig_tpu.cli.common as jcommon
from zero_tig_tpu.cli.serve import run_serve as jax_run_serve
from zero_tig_tpu.core import precision as jprecision
from zero_tig_tpu.core.config import Config as JaxConfig
from zero_tig_tpu.models.network import init_network_variables
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_torch import native
from zero_tig_torch.cli.serve import run_serve
from zero_tig_torch.core.checkpoint import save_pt
from zero_tig_torch.core.config import Config
from zero_tig_torch.data import make_rlv_fixture
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.pipeline.steps import init_carry, predict_step

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

TINY = dict(frame_width=64, frame_height=48, of_scale=2, raft_iters=2)
FAST_EXIT = dict(poll_sec=0.05, settle_sec=0.0, max_idle_sec=0.3)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    pt = tmp_path_factory.mktemp("w") / "seeded.pt"
    save_pt(pt, build_model(init_random_state_dict(0), device="cpu", precision="highest"))
    return str(pt)


@pytest.fixture()
def inbox(tmp_path):
    return os.path.join(make_rlv_fixture(str(tmp_path / "rlv"), frames_per_scene=3, size=(64, 48)), "input")


def _serve(inbox, save, weights, **kw):
    cfg = Config(lowlight_images_path=inbox, save=str(save), model_pretrain=weights, **TINY, **kw)
    return run_serve(cfg, device="cpu", **FAST_EXIT)


def _pngs(root):
    return {os.path.relpath(p, root): native.read_rgb(p) for p in glob.glob(f"{root}/**/*.png", recursive=True)}


def _manifest(save):
    with open(os.path.join(save, "manifest.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_serve_matches_jax_then_resumes(inbox, tmp_path, weights):
    """Every PNG within one level of the JAX daemon's on the same inbox and
    .pt (f32 on both sides: a value on a truncation edge may land one level
    apart, as in tests/test_torch_cli.py), the same manifest; then a second
    run serves nothing, and STOP ends the loop."""
    # the JAX daemon's eager init draws variables the .pt replaces: trees of
    # the same structure from tracing alone, as in tests/test_torch_cli.py
    def shaped(init, key):
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      jax.eval_shape(functools.partial(init, h=16, w=16), key))

    mp = pytest.MonkeyPatch()
    mp.setattr(jcommon, "init_network_variables", functools.partial(shaped, init_network_variables))
    mp.setattr(jcommon, "init_raft_variables", functools.partial(shaped, init_raft_variables))
    jprecision.set_precision("highest")
    try:
        n_jax = jax_run_serve(JaxConfig(lowlight_images_path=inbox, save=str(tmp_path / "jax"), model_pretrain=weights,
                                        **TINY), **FAST_EXIT)
    finally:
        mp.undo()
    save = tmp_path / "port"
    assert _serve(inbox, save, weights) == n_jax == 6
    port, ref = _pngs(save), _pngs(tmp_path / "jax")
    assert set(port) == set(ref) and len(port) == 12
    for name, img in port.items():
        assert img.shape == (48, 64, 3)
        assert np.abs(img.astype(int) - ref[name].astype(int)).max() <= 1, name
    records = _manifest(save)
    assert [(r["scene"], r["index"], r["new_seq"]) for r in records] == [
        (r["scene"], r["index"], r["new_seq"]) for r in _manifest(tmp_path / "jax")]
    assert [r["new_seq"] for r in records] == [True, False, False] * 2

    # a restart serves nothing and writes no manifest line
    assert _serve(inbox, save, weights) == 0
    assert len(_manifest(save)) == 6
    # STOP ends the loop before a new frame is read
    scene = os.path.join(inbox, "S01", "low_light_10")
    shutil.copy(os.path.join(scene, "00002.png"), os.path.join(scene, "00003.png"))
    open(os.path.join(inbox, "STOP"), "w").close()
    assert _serve(inbox, save, weights) == 0
    assert len(_manifest(save)) == 6


def test_late_frame_continues_its_scene(inbox, tmp_path, weights, monkeypatch):
    """A frame that arrives while the daemon runs continues its scene's
    carry: new_seq false, and its PNGs those of predict_step with the carry
    of the frame before it (JAX tests/test_serve.py:27-72)."""
    scene = os.path.join(inbox, "S01", "low_light_10")
    late = os.path.join(scene, "00002.png")
    staged = late + ".staged"
    os.rename(late, staged)
    calls = {"n": 0}
    real_sleep = time.sleep

    def deliver(sec):  # the daemon idles once the backlog is served: the frame lands then
        calls["n"] += 1
        if calls["n"] == 1:
            os.rename(staged, late)
        real_sleep(sec)

    monkeypatch.setattr(time, "sleep", deliver)
    save = tmp_path / "out"
    assert _serve(inbox, save, weights) == 6
    records = _manifest(save)
    assert [(r["scene"].endswith("S01/low_light_10"), r["index"], r["new_seq"]) for r in records][-1] == (True, 2, False)
    by_scene = {}
    for r in records:
        by_scene.setdefault(r["scene"], []).append(r)
    for rs in by_scene.values():
        rs = sorted(rs, key=lambda r: r["index"])
        assert rs[0]["new_seq"] is True and all(r["new_seq"] is False for r in rs[1:])

    # the late frame's outputs: predict_step on it with the carry of frames 0-1
    model = build_model(init_random_state_dict(0), device="cpu", precision="highest")
    carry = init_carry(model, (1, 48, 64, 3))
    kw = dict(of_scale=2, raft_iters=2)
    for i in range(3):
        img = native.read_rgb(os.path.join(scene, f"{i:05d}.png"))[None]
        (H2, H3, _), carry = predict_step(model, torch.from_numpy(img), carry, i == 0, **kw)
    out = os.path.join(save, "S01", "low_light_10")
    np.testing.assert_array_equal(native.read_rgb(os.path.join(out, "00002_denoise.png")),
                                  np.clip(H3[0].numpy() * 255, 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(native.read_rgb(os.path.join(out, "00002_enhance.png")),
                                  np.clip(H2[0].numpy() * 255, 0, 255).astype(np.uint8))


def test_chunked_backlog_matches_per_frame(inbox, tmp_path, weights):
    """chunk=3: each scene's settled backlog of 3 frames is one
    predict_chunk(emit="u8") call, whose PNGs are within one level of the
    per-frame path's (JAX tests/test_serve.py:80-124)."""
    assert _serve(inbox, tmp_path / "chunk", weights, chunk=3) == 6
    assert _serve(inbox, tmp_path / "step", weights) == 6
    a, b = _pngs(tmp_path / "chunk"), _pngs(tmp_path / "step")
    assert set(a) == set(b) and len(a) == 12
    for name in a:
        d = np.abs(a[name].astype(int) - b[name].astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.05, name
    assert [r["new_seq"] for r in _manifest(tmp_path / "chunk")] == [True, False, False] * 2


def test_off_size_frame_is_resized(inbox, tmp_path, weights):
    """A frame off the target size goes through Pillow's bicubic resize, as
    the reference's loader does, and is served at the target size."""
    scene = os.path.join(inbox, "S03", "low_light_10")
    os.makedirs(scene)
    rng = np.random.default_rng(4)
    big = (rng.random((60, 80, 3)) * 60).astype(np.uint8)
    native.write_png(os.path.join(scene, "00000.png"), big)
    assert _serve(inbox, tmp_path / "out", weights) == 7
    model = build_model(init_random_state_dict(0), device="cpu", precision="highest")
    frame = torch.from_numpy(native.resize_bicubic_pil(big, (64, 48))[None])
    (H2, _, _), _ = predict_step(model, frame, init_carry(model, (1, 48, 64, 3)), True, of_scale=2, raft_iters=2)
    got = native.read_rgb(tmp_path / "out" / "S03" / "low_light_10" / "00000_enhance.png")
    np.testing.assert_array_equal(got, np.clip(H2[0].numpy() * 255, 0, 255).astype(np.uint8))


def test_serve_without_device_raises_when_no_card(inbox, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serve(Config(lowlight_images_path=inbox, save=str(tmp_path / "out"), **TINY), **FAST_EXIT)
