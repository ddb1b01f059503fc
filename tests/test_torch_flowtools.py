"""The flow sidecar's tools against the JAX package on the CPU: the
registry, validation and submissions, the augmentors, the optimizer's
pieces, supervised training steps, the demo CLI and the VMAF hook.

Weights are drawn with numpy into the JAX trees' shapes and carried to the
port by ``core.checkpoint``; frames and flows are numpy draws from a seed.
JAX runs in "highest" (its default)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zero_tig_tpu import flowtools as jft
from zero_tig_tpu.cli import demo as j_demo
from zero_tig_tpu.core import precision as j_precision
from zero_tig_tpu.data import augmentor as j_aug
from zero_tig_tpu.eval import vmaf as j_vmaf
from zero_tig_tpu.models.pwc import init_pwc_variables
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_tpu.models.raft.small import init_raft_small_variables
from zero_tig_torch import flowtools as tft
from zero_tig_torch import native
from zero_tig_torch.cli import demo
from zero_tig_torch.core.checkpoint import from_jax_pwc_variables, from_jax_raft_variables
from zero_tig_torch.data import augmentor
from zero_tig_torch.eval import vmaf
from zero_tig_torch.flowtools.benchmark import count_params
from zero_tig_torch.flowtools.train import FlowOptimizer, linear_onecycle_schedule
from zero_tig_torch.models.pwc import PWCLite
from zero_tig_torch.models.raft.raft import RAFT
from zero_tig_torch.utils import flow_io

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

INITS = {"raft": init_raft_variables, "raft_small": init_raft_small_variables, "pwc_lite": init_pwc_variables}


def drawn_variables(init, seed):
    """The tree ``init`` makes, its shapes from tracing alone, with values
    drawn with numpy: conv kernels and biases uniform in +-1/sqrt(fan_in),
    BatchNorm near identity."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(functools.partial(init, h=16, w=16), jax.random.PRNGKey(0))
    fan_in = {}

    def draw(path, leaf):
        name, parent = jax.tree_util.keystr(path[-1:]), jax.tree_util.keystr(path[:-1])
        if "kernel" in name:
            fan_in[parent] = int(np.prod(leaf.shape[:-1]))
            b = 1 / np.sqrt(fan_in[parent])
        elif "mean" in name or ("bias" in name and "batch_stats" not in jax.tree_util.keystr(path)):
            b = 0.1
        else:  # scale, var
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.uniform(-b, b, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def port_pwc(v):
    model = PWCLite()
    model.load_state_dict(from_jax_pwc_variables(v))
    return model


def port_raft(v):
    model = RAFT()
    sd = {k.removeprefix("raft."): t for k, t in from_jax_raft_variables(v).items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model.eval()


@pytest.fixture(autouse=True)
def jax_highest():
    saved = j_precision.get_mode()
    j_precision.set_precision("highest")
    yield
    j_precision.set_precision(saved)


def test_registry_and_vmaf_match_jax():
    # the port registers GMA besides the JAX package's four (models/raft/gma.py)
    assert jft.available_models() == ["lk_pyramid", "pwc_lite", "raft", "raft_small"]
    assert tft.available_models() == ["gma", *jft.available_models()]
    for name in jft.available_models():
        ours, theirs = tft.get_flow_model(name), jft.get_flow_model(name)
        assert ours.default_iters == theirs.default_iters, name
        assert (ours.predictions_fn is None) == (theirs.predictions_fn is None), name
        model = ours.init_fn(torch.Generator().manual_seed(0), device="cpu")
        n_jax = 0 if name == "lk_pyramid" else sum(
            int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
                jax.eval_shape(functools.partial(INITS[name], h=16, w=16), jax.random.PRNGKey(0))))
        assert count_params(model) == n_jax, name  # benchmark's "params": JAX counts its whole tree
    with pytest.raises(KeyError, match="unknown flow model"):
        tft.get_flow_model("flownet")
    # the same seed draws the same weights
    a = tft.get_flow_model("pwc_lite").init_fn(3, device="cpu").state_dict()
    b = tft.get_flow_model("pwc_lite").init_fn(torch.Generator().manual_seed(3), device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert vmaf.vmaf_available() == j_vmaf.vmaf_available()
    if not vmaf.vmaf_available():
        assert vmaf.score_sequences("a", "b") is None and j_vmaf.score_sequences("a", "b") is None


def _write_frames(root, names, h, w, seed, shift=(1.0, 0.5)):
    """Textured frames, each the last moved by ``shift`` px, as PNGs."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 6, 3)
    os.makedirs(root, exist_ok=True)
    for i, name in enumerate(names):
        xx, yy = x - i * shift[0], y - i * shift[1]
        img = np.stack([127 + 90 * np.sin(xx / (3 + c) + ph[c]) * np.cos(yy / (4 + c)) for c in range(3)], -1)
        native.write_png(os.path.join(root, name), np.clip(img, 0, 255).astype(np.uint8))


def test_validate_and_submissions_match_jax(tmp_path):
    # PWC-lite on 40x60 frames: its flow is at the /16-padded 48x64, so the
    # ground truth's size differs and the flow is resized to it and scaled
    v = drawn_variables(init_pwc_variables, 1)
    model = port_pwc(v)
    img_dir, gt_dir = tmp_path / "img", tmp_path / "gt"
    _write_frames(img_dir, ["f0.png", "f1.png"], 40, 60, 0)
    os.makedirs(gt_dir)
    flow_io.write_flo(str(gt_dir / "f0.flo"), np.tile(np.float32([1.0, 0.5]), (40, 60, 1)))
    ref = jft.validate_folder("pwc_lite", v, str(img_dir), str(gt_dir), csv_path=str(tmp_path / "jax.csv"))
    got = tft.validate_folder("pwc_lite", model, str(img_dir), str(gt_dir), csv_path=str(tmp_path / "port.csv"),
                              device="cpu")
    assert got["num_pairs"] == ref["num_pairs"] == 1
    assert (tmp_path / "port.csv").read_text().splitlines()[0] == (tmp_path / "jax.csv").read_text().splitlines()[0]
    # f32 on both sides (sums in another order): EPE and WAUC to 1e-4 of
    # themselves; the threshold counts (Fl-all, px1) equal
    for k in ("epe", "wauc"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-5), k
    assert got["fl_all"] == ref["fl_all"] and got["px1"] == ref["px1"]
    r = tft.infer_pair("pwc_lite", model, str(img_dir / "f0.png"), str(img_dir / "f1.png"), size=(48, 32),
                       save_dir=str(tmp_path / "pair"), device="cpu")
    assert sorted(os.listdir(tmp_path / "pair")) == ["f1.flo", "f1_viz.png"] and "epe" not in r
    assert flow_io.read_flo(str(tmp_path / "pair" / "f1.flo")).shape == (32, 48, 2)

    # submissions at the padded size, read back as the flow in memory: the
    # Sintel .flo bit for bit, the KITTI 16-bit PNG within its quantisation
    # (JAX's .flo and KITTI files are read in tests/test_torch_flow_io.py)
    _write_frames(tmp_path / "sintel" / "alley", ["frame_0001.png", "frame_0002.png"], 40, 60, 2)
    _write_frames(tmp_path / "kitti", ["000000_10.png", "000000_11.png"], 40, 60, 2)
    assert tft.write_sintel_submission("pwc_lite", model, str(tmp_path / "sintel"), str(tmp_path / "out_s"),
                                       device="cpu") == 1
    assert tft.write_kitti_submission("pwc_lite", model, str(tmp_path / "kitti"), str(tmp_path / "out_k"),
                                      device="cpu") == 1
    frames = [torch.from_numpy(native.read_rgb(tmp_path / "sintel" / "alley" / f"frame_000{i}.png")[None].astype(np.float32))
              for i in (1, 2)]
    flow = tft.get_flow_model("pwc_lite").forward_fn(model, *frames, 1)[1][0].numpy()
    got_f = flow_io.read_flo(str(tmp_path / "out_s" / "alley" / "frame_0001.flo"))
    assert got_f.shape == (48, 64, 2)
    np.testing.assert_array_equal(got_f, flow)
    got_k, valid = flow_io.read_flow_kitti(str(tmp_path / "out_k" / "000000_10.png"))
    assert got_k.shape == (48, 64, 2) and np.all(valid == 1)
    assert np.abs(got_k - flow).max() < 1 / 64  # the 16-bit quantisation (truncated, as JAX writes it)


def test_augmentors_match_jax():
    rng = np.random.default_rng(7)
    img1 = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    img2 = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    flow = rng.normal(0, 3, (60, 80, 2)).astype(np.float32)
    valid = (rng.random((60, 80)) > 0.4).astype(np.float32)
    for seed in range(6):
        for resize in (0.0, 1.0):
            kw = dict(crop_size=(40, 48), spatial_aug_prob=resize, seed=seed)
            pairs = [(j_aug.FlowAugmentor(**kw), augmentor.FlowAugmentor(**kw), (img1, img2, flow)),
                     (j_aug.SparseFlowAugmentor(**kw), augmentor.SparseFlowAugmentor(**kw), (img1, img2, flow, valid))]
            for ref_aug, aug, args in pairs:
                for _ in range(2):
                    ref, got = ref_aug(*args), aug(*args)
                    # the same draws in the same order
                    assert aug.rng.bit_generator.state == ref_aug.rng.bit_generator.state
                    assert [g.shape for g in got] == [r.shape for r in ref]
                    if resize == 0.0:  # colour, eraser, flips, crop: bit-equal
                        for g, r in zip(got, ref):
                            np.testing.assert_array_equal(g, r)
                    else:  # F.interpolate against OpenCV's 11-bit fixed point: one level
                        assert max(np.abs(g.astype(int) - r.astype(int)).max() for g, r in zip(got[:2], ref[:2])) <= 1
                        if len(args) == 3:  # f32 bilinear on both sides
                            np.testing.assert_allclose(got[2], ref[2], atol=1e-5 * np.abs(ref[2]).max())
                        else:  # the sparse resize is numpy on both sides
                            np.testing.assert_array_equal(got[2], ref[2])
                            np.testing.assert_array_equal(got[3], ref[3])
    # the hue shift's colour conversions are OpenCV's, on 2^20 random colours
    import cv2

    rgb = rng.integers(0, 256, (1024, 1024, 3)).astype(np.uint8)
    np.testing.assert_array_equal(augmentor.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = np.stack([rng.integers(0, 180, (1024, 1024)), rng.integers(0, 256, (1024, 1024)),
                    rng.integers(0, 256, (1024, 1024))], -1).astype(np.uint8)
    np.testing.assert_array_equal(augmentor.hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_schedule_and_optimizer_match_optax():
    total, peak = 1000, 4e-4
    for pct_start, pct_final in ((0.05, 1.0), (0.3, 0.85)):
        ref = optax.linear_onecycle_schedule(total, peak, pct_start=pct_start, pct_final=pct_final,
                                             div_factor=25.0, final_div_factor=1e4)
        ours = linear_onecycle_schedule(total, peak, pct_start=pct_start, pct_final=pct_final)
        ps = int(pct_start * total)
        for step in (0, 1, ps - 1, ps, ps + 1, int(pct_final * total) + 1, total - 1, total, total + 7):
            # optax's count is an int32 array inside an update: f32 arithmetic
            assert ours(step) == float(ref(jnp.asarray(step, jnp.int32))), (pct_start, step)

    # clip -> AdamW over 3 steps, the clip triggered on the first two
    rng = np.random.default_rng(8)
    params = {"a": rng.normal(0, 1, (5, 4)).astype(np.float32), "b": rng.normal(0, 1, (7,)).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.linear_onecycle_schedule(100, peak, pct_start=0.05, pct_final=1.0, div_factor=25.0,
                                       final_div_factor=1e4), weight_decay=1e-4, eps=1e-8))
    state = tx.init(params)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = FlowOptimizer(lr=peak, total_steps=100)
    ts = opt.init(tp)

    @jax.jit
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for scale in (10.0, 3.0, 0.01):
        grads = {k: (scale * rng.normal(0, 1, v.shape)).astype(np.float32) for k, v in params.items()}
        params, state = step(grads, state, params)
        opt.update(tp, [torch.from_numpy(grads[k]) for k in ("a", "b")], ts)
        for k, t in zip(("a", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(params[k]), atol=1e-7, rtol=1e-6)  # f32 rounding


def _jax_steps(name, v, batch, n, iters):
    fm = jft.get_flow_model(name)
    state, losses = jft.init_flow_train_state(v, total_steps=100), []
    # XLA's backend optimisation level 0 halves the compile; the arithmetic is XLA's
    step = jax.jit(lambda s, a, b, g: jft.flow_train_step(s, a, b, g, None, iters=iters, total_steps=100,
                                                         predictions_fn=fm.predictions_fn)
                   ).lower(state, *batch).compile({"xla_backend_optimization_level": 0})
    for _ in range(n):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return {"params": state.params, "batch_stats": v.get("batch_stats", {})}, losses


def test_flow_train_steps_match_jax():
    # two steps of pwc_lite and one of raft, each from the same weights as JAX's
    for name, steps in (("pwc_lite", 2), ("raft", 1)):
        _train_steps_match_jax(name, steps)


def _train_steps_match_jax(name, steps):
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 255, (1, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.float32)
    gt = rng.normal(0, 2, (1, 32, 32, 2)).astype(np.float32)
    v = drawn_variables(INITS[name], 10)
    new_v, ref_losses = _jax_steps(name, v, (a, b, gt), steps, iters=2)
    model = port_pwc(v) if name == "pwc_lite" else port_raft(v)
    to_port = port_pwc if name == "pwc_lite" else port_raft
    state = tft.init_flow_train_state(model, total_steps=100)
    losses = []
    for _ in range(steps):
        state, loss = tft.flow_train_step(state, *map(torch.from_numpy, (a, b, gt)), iters=2, total_steps=100,
                                          predictions_fn=tft.get_flow_model(name).predictions_fn)
        losses.append(float(loss))
    # f32 on both sides: the loss to 1e-5 of itself
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    ref = to_port(jax.tree_util.tree_map(np.asarray, new_v)).state_dict()
    before = to_port(v).state_dict()
    # an AdamW step moves a weight by about its learning rate: where the
    # gradient is far above eps (|g| > 1e-6 = 100 eps) the normalised moment
    # m/(sqrt(v)+eps) is ~+-1 and the weights agree to 1e-3 of the steps'
    # sum of learning rates (and two f32 ulps of the weight); where it is within a few eps of zero that
    # moment follows the rounding of f32 sums run in another order, and the
    # weights are held to the steps' own bound, twice that sum
    schedule = linear_onecycle_schedule(100, 4e-4, pct_start=0.05, pct_final=1.0)
    lr_sum = sum(schedule(t) for t in range(steps))
    fresh = to_port(v)
    preds = tft.get_flow_model(name).predictions_fn(fresh, *map(torch.from_numpy, (a, b)), 2)
    grads = dict(zip([n for n, _ in fresh.named_parameters()], torch.autograd.grad(
        tft.sequence_loss(preds, torch.from_numpy(gt)), list(fresh.parameters()))))
    diff = moved = 0.0
    for k, t in model.state_dict().items():
        d = (t.detach() - ref[k]).abs()
        if k not in grads:  # a BatchNorm statistic or an alias name: untouched, or checked under its own name
            continue
        d = d - 2 * 2.0**-23 * ref[k].abs()  # less two f32 ulps of the weight itself
        sure = torch.where(grads[k].abs() > 1e-6, d, torch.zeros_like(d))
        assert float(sure.max()) <= 1e-3 * lr_sum and float(d.max()) <= 2 * lr_sum * (1 + 1e-4), k
        diff = max(diff, float(sure.max()))
        moved = max(moved, float((t.detach() - before[k]).abs().max()))
    print(f"{name}: losses {losses} (JAX {ref_losses}), weights off JAX's by {diff:.3g} where |g| > 1e-6 "
          f"(step {lr_sum:.3g}), largest move {moved:.3g}")
    assert moved > 0.5 * schedule(0)  # the steps moved the weights


def test_demo_cli_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ZERO_TIG_COMPILE_CACHE", "off")
    v = drawn_variables(init_raft_variables, 11)
    # one .pt of RAFT weights (the reference's keys), read by both CLIs
    torch.save(from_jax_raft_variables(v), tmp_path / "raft.pt")
    _write_frames(tmp_path / "frames", ["a.png", "b.png", "c.png"], 48, 64, 12)
    args = ["--model", str(tmp_path / "raft.pt"), "--path", str(tmp_path / "frames"), "--width", "64",
            "--height", "48", "--iters", "2"]
    j_demo.main(args + ["--save", str(tmp_path / "jax")])
    demo.main(args + ["--save", str(tmp_path / "port")], device="cpu")
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "b_flow.png", "b_overlap.png", "c_flow.png", "c_overlap.png"]
    for name in names:
        got = native.read_rgb(tmp_path / "port" / name).astype(int)
        ref = native.read_rgb(tmp_path / "jax" / name).astype(int)
        # the flow image floors 255 * a colour: a flow 1e-6 apart may land a
        # level lower; the overlap is a warp of the same frames
        assert np.abs(got - ref).max() <= 1 and np.mean(got != ref) < 0.01, name

