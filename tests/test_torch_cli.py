"""The slice as a whole, on the CPU: the port's CLIs on a 2-scene x 3-frame
64x48 fixture (of_scale 2, 2 RAFT iterations, highest mode), against the
JAX package's. The port's train CLI writes the JAX artifact layout; its
``weights_0.pt`` goes through both packages' predict and evals CLIs, whose
PNGs agree within 1 level and whose metrics agree within 1e-3; a resumed
run starts at the next epoch; ``run_pipeline`` ends with its metrics table;
every entry point without a device raises where there is no card."""

import functools
import glob
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import zero_tig_tpu.cli.common as jcommon
from zero_tig_tpu.cli.evals import run_evals as jax_run_evals
from zero_tig_tpu.cli.predict import run_predict as jax_run_predict
from zero_tig_tpu.core import precision as jprecision
from zero_tig_tpu.core.config import Config as JaxConfig
from zero_tig_tpu.data import create_dataset as jax_create_dataset
from zero_tig_tpu.models.network import init_network_variables
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_torch import native
from zero_tig_torch.cli import evals, predict, run_pipeline, train
from zero_tig_torch.core.config import Config
from zero_tig_torch.data import make_rlv_fixture

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(frame_width=64, frame_height=48, of_scale=2, raft_iters=2)
FLOAT = r"-?\d+\.\d+"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fixture, and one epoch of the port's train CLI on it."""
    root = tmp_path_factory.mktemp("cli")
    data = make_rlv_fixture(str(root / "data" / "RLV"))
    run_dir = train.run_training(
        Config(dataset="RLV", lowlight_images_path=data, save=str(root / "EXP"), epochs=1, **TINY), device="cpu"
    )
    return root, data, run_dir


def _pngs(root):
    return {os.path.relpath(p, root): native.read_rgb(p) for p in glob.glob(f"{root}/**/*.png", recursive=True)}


def test_train_writes_the_jax_artifact_layout(trained):
    _, data, run_dir = trained
    test_recs = jax_create_dataset("RLV", data, "test", size=(64, 48)).paths
    want = set()
    for path in test_recs:  # JAX cli/train.py:259-268
        parent = os.path.dirname(path)
        stem = f"{os.path.basename(os.path.dirname(parent))}_{os.path.basename(parent)}_{Path(path).stem}"
        want |= {f"denoise/{stem}_denoise_0.png", f"enhance/{stem}_enhance_0.png"}
    assert set(_pngs(os.path.join(run_dir, "result"))) == want and len(want) == 12
    assert sorted(os.listdir(os.path.join(run_dir, "model_epochs"))) == [
        "state_0.pt", "state_0.pt.meta.json", "weights_0.pt"]
    assert os.path.exists(os.path.join(run_dir, "initial_weights.pt"))
    assert {"train.py", "predict.py", "evals.py", "common.py"} <= set(os.listdir(os.path.join(run_dir, "scripts")))
    # the log lines of JAX cli/train.py, in its order
    stamp = r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} "
    shapes = [r"args = Config\(.*\)", r"RAFT weights not loaded -- .*", r"model size = 5\.350156",
              r"Training data: 6", r"Test data: 6"]
    shapes += [rf"train-epoch 000 00{i} {FLOAT}" for i in range(6)] + [rf"train-epoch 000 {FLOAT}"]
    with open(os.path.join(run_dir, "log.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == len(shapes)
    for line, shape in zip(lines, shapes):
        assert re.fullmatch(stamp + shape, line), line
    losses = [float(line.rsplit(" ", 1)[1]) for line in lines[5:]]
    assert np.isfinite(losses).all()


@pytest.fixture(scope="module")
def both_predicts(trained):
    """weights_0.pt through the JAX predict and evals CLIs and the port's."""
    root, data, run_dir = trained
    weights = os.path.join(run_dir, "model_epochs", "weights_0.pt")
    common = dict(dataset="RLV", lowlight_images_path=data, model_pretrain=weights, **TINY)
    # The JAX CLI draws fresh variables before the checkpoint replaces every
    # one of them; its eager init compiles op by op for ~25 s on this CPU, so
    # it gets trees of the same structure, of zeros, from tracing alone.
    def shaped(init, key):
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      jax.eval_shape(functools.partial(init, h=16, w=16), key))

    mp = pytest.MonkeyPatch()
    mp.setattr(jcommon, "init_network_variables", functools.partial(shaped, init_network_variables))
    mp.setattr(jcommon, "init_raft_variables", functools.partial(shaped, init_raft_variables))
    jprecision.set_precision("highest")
    try:
        jax_run_predict(JaxConfig(save=str(root / "jpred"), **common))
        jm = jax_run_evals(JaxConfig(save=str(root / "jeval"), **common))
    finally:
        mp.undo()
    predict.run_predict(Config(save=str(root / "tpred"), chunk=4, **common), device="cpu")
    tm = evals.run_evals(Config(save=str(root / "teval"), **common), device="cpu")
    return root, jm, tm


def test_predict_matches_jax(both_predicts):
    # 4 frames of one predict_chunk and 2 per-frame steps in the port, 6
    # per-frame steps in JAX; f32 on both sides, so a value on a truncation
    # edge may land one level apart
    root, _, _ = both_predicts
    port, ref = _pngs(root / "tpred"), _pngs(root / "jpred")
    assert set(port) == set(ref) and len(port) == 12
    assert {p.split(os.sep)[0] for p in port} == {"S01", "S02"}
    for name, img in port.items():
        assert img.shape == (48, 64, 3)
        assert np.abs(img.astype(int) - ref[name].astype(int)).max() <= 1, name
    assert max(float(img.mean()) for img in port.values()) > 0


def test_evals_matches_jax(both_predicts):
    root, jm, tm = both_predicts
    assert set(tm) == set(jm) and len(tm) == 6
    with open(root / "teval" / "Metrics.json") as f:
        assert json.load(f) == pytest.approx(tm)
    for k, v in jm.items():
        if v is None:
            assert tm[k] is None, k
        else:
            assert np.isfinite(tm[k]) and abs(tm[k] - v) <= 1e-3, k
    port, ref = _pngs(root / "teval"), _pngs(root / "jeval")
    assert set(port) == set(ref) and any(n.endswith("_hm.png") for n in port)
    for name, img in port.items():
        assert np.abs(img.astype(int) - ref[name].astype(int)).max() <= 1, name


def test_resume_starts_at_the_next_epoch(trained):
    root, data, run_dir = trained
    state = os.path.join(run_dir, "model_epochs", "state_0.pt")
    cfg = Config(dataset="RLV", lowlight_images_path=data, save=str(root / "RESUME"), epochs=2, resume=state, **TINY)
    new_dir = train.run_training(cfg, device="cpu")
    with open(os.path.join(new_dir, "log.txt")) as f:
        log = f.read()
    assert f"Resumed full train state from {state} (epoch 1)" in log
    assert "train-epoch 001 005" in log and "train-epoch 000" not in log
    assert sorted(os.listdir(os.path.join(new_dir, "model_epochs"))) == [
        "state_1.pt", "state_1.pt.meta.json", "weights_1.pt"]
    with open(os.path.join(new_dir, "model_epochs", "state_1.pt.meta.json")) as f:
        assert json.load(f) == {"epoch": 1, "step": 6}


def test_run_pipeline_ends_with_a_metrics_table(trained, monkeypatch, capsys):
    root, data, _ = trained
    monkeypatch.setattr(run_pipeline, "run_dataset", functools.partial(run_pipeline.run_dataset, **TINY))
    results = run_pipeline.main(["--datasets", "RLV", "--base_data_dir", os.path.dirname(data), "--epochs", "1",
                                 "--save_root", str(root / "PIPE")], device="cpu")
    out = capsys.readouterr().out
    table = json.loads(out[out.rindex("\n{") + 1:])
    assert set(table) == {"RLV"} and table == results
    assert set(table["RLV"]) == {"Total_PSNR", "Total_SSIM", "Total_LPIPS", "Total_PSNR_HM", "Total_SSIM_HM",
                                 "Total_LPIPS_HM"}
    assert table["RLV"]["Total_LPIPS"] is None and np.isfinite(table["RLV"]["Total_PSNR"])
    assert run_pipeline.find_latest_run_dir(str(root / "PIPE" / "RLV")) is not None


def test_entry_points_without_device_raise_when_no_card(trained, monkeypatch, tmp_path):
    _, data, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--lowlight_images_path", data, "--save", str(tmp_path / "out")]
    for main in (train.main, predict.main, evals.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline.main(["--datasets", "RLV", "--base_data_dir", os.path.dirname(data)])
    for run in (train.run_training, predict.run_predict, evals.run_evals):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(Config(lowlight_images_path=data, save=str(tmp_path / "out")))
    assert not os.path.exists(tmp_path / "out")
    # and as a user starts it, in a process of its own that sees no card
    proc = subprocess.run(
        [sys.executable, "-m", "zero_tig_torch.cli.predict", *argv], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}, timeout=120,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
