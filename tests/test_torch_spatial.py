"""Banded training (``pipeline/spatial.py``) on the CPU: the loss's Region
mode against the JAX package's, ``train_step_spatial`` against the port's
own ``train_step`` at the JAX package's tolerances
(``tests/test_spatial.py``) and against JAX's ``train_step_spatial``, and
``--spatial_bands`` through the train CLI. Weights: the port's seeded
``init_random_state_dict``, through the reference's state-dict keys into
the JAX package where it takes part."""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core.checkpoint import convert_torch_state_dict
from zero_tig_tpu.core.config import Config as JaxConfig
from zero_tig_tpu.losses.zero_tig_loss import Region as JaxRegion
from zero_tig_tpu.losses.zero_tig_loss import zero_tig_loss as jax_loss
from zero_tig_tpu.models.network import TrainOutputs as JaxTrainOutputs
from zero_tig_tpu.pipeline.spatial import train_step_spatial as jax_train_step_spatial
from zero_tig_tpu.pipeline.steps import init_train_state as jax_init_train_state
from zero_tig_torch.cli.train import run_training
from zero_tig_torch.core.checkpoint import state_dict_for_save
from zero_tig_torch.core.config import Config
from zero_tig_torch.data import make_rlv_fixture
from zero_tig_torch.losses.zero_tig_loss import Region, loss_factor, rgb2ycbcr_scrambled, zero_tig_loss
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.models.network import forward_train
from zero_tig_torch.pipeline.spatial import band_geometry, spatial_loss_and_grads, train_step_spatial
from zero_tig_torch.pipeline.steps import init_train_state, train_step

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

KW = dict(of_scale=2, raft_iters=2)
W = 64


@pytest.fixture(scope="module")
def sd():
    return init_random_state_dict(0)


def _frames(h, n=2):
    rng = np.random.default_rng(2)
    return [(rng.random((1, h, W, 3)) * 0.3).astype(np.float32) for _ in range(n)]


def _flat(state):
    """Parameters and BatchNorm statistics by name, as numpy."""
    return {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()
            if not k.startswith("raft.") and not k.endswith("num_batches_tracked")}


def test_region_losses_match_jax_and_sum_to_the_frame(sd):
    """The loss of each band's rows (2 bands of a 128-row frame, halo 24, on
    the monolithic forward's outputs cut to the band's slice) against the
    JAX package's on the same slices, and their sum against the port's loss
    of the whole frame."""
    h = 128
    frame = torch.from_numpy(_frames(h, 1)[0])
    model = build_model(sd, device="cpu", precision="highest")
    carry = {k: torch.zeros(1, h, W, 3) for k in ("last_H3", "last_s3")}
    with torch.no_grad():
        outs, _ = forward_train(model, frame, carry, torch.tensor(True), bn_train=False, **KW)
    whole = float(zero_tig_loss(frame, outs))
    factor, ycc = loss_factor(outs.L2), rgb2ycbcr_scrambled(outs.L2)
    slice_h, geoms = band_geometry(h, 2, 24)
    assert slice_h < h  # the slices crop
    total = 0.0
    for s0, own0, own1 in geoms:
        # full-resolution maps by rows, the pair-downsampled ones by half rows
        cut = [t[:, s0 // 2:(s0 + slice_h) // 2] if t.shape[1] == h // 2 else t[:, s0:s0 + slice_h] for t in outs]
        band = type(outs)(*cut)
        got = float(zero_tig_loss(frame[:, s0:s0 + slice_h], band, region=Region(s0, own0, own1, h),
                                  factor=factor, ycc=ycc[:, s0:s0 + slice_h]))
        ref = float(jax.jit(functools.partial(jax_loss, region=JaxRegion(s0, own0, own1, h)))(
            jnp.asarray(frame[:, s0:s0 + slice_h].numpy()), JaxTrainOutputs(*(jnp.asarray(t.numpy()) for t in cut)),
            factor=jnp.asarray(factor.numpy()), ycc=jnp.asarray(ycc[:, s0:s0 + slice_h].numpy()),
        ))
        # f32 sums in another order
        assert got == pytest.approx(ref, rel=1e-6), (s0, got, ref)
        total += got
    assert total == pytest.approx(whole, rel=3e-6)
    with pytest.raises(ValueError, match="ycc"):
        zero_tig_loss(frame, outs, region=Region(0, 0, h // 2, h), factor=factor)


@pytest.mark.parametrize("bands,halo,h,bn_train", [(2, 24, 128, False), (4, 24, 128, False), (2, 24, 128, True)])
def test_banded_step_matches_monolithic(sd, bands, halo, h, bn_train):
    """Two consecutive frames, banded and whole, from the same state: the
    tolerances of the JAX package's tests/test_spatial.py:81-131."""
    frames = _frames(h)
    cfg = Config(**KW)
    state_m = init_train_state(cfg, sd, (1, h, W, 3), "cpu")
    state_s = init_train_state(cfg, sd, (1, h, W, 3), "cpu")
    if bn_train:
        # the sharp signal: the gradients (Adam turns rounding-level gradient
        # differences into lr-sized steps, so the parameters are compared
        # loosely below)
        model = state_m.model
        outs, _ = forward_train(model, torch.from_numpy(frames[0]), state_m.carry, torch.tensor(True),
                                bn_train=True, **KW)
        zero_tig_loss(torch.from_numpy(frames[0]), outs).backward()
        g_mono = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        state_m = init_train_state(cfg, sd, (1, h, W, 3), "cpu")  # the running statistics moved
        probe = init_train_state(cfg, sd, (1, h, W, 3), "cpu")
        spatial_loss_and_grads(probe, frames[0], True, bands=bands, halo=halo, bn_train=True, **KW)
        g_band = {n: p.grad for n, p in probe.model.named_parameters() if p.grad is not None}
        assert g_band.keys() == g_mono.keys() and len(g_mono) == 20
        for name, gm in g_mono.items():
            gm, gb = gm.numpy(), g_band[name].numpy()
            if name == "enhance.conv.0.bias":
                # exactly zero under batch statistics (the batch mean absorbs
                # the bias): both sides hold cancellation noise
                assert np.abs(gm).max() < 1e-2 and np.abs(gb).max() < 1e-2, name
                continue
            scale = max(float(np.abs(gm).max()), 1e-3)
            np.testing.assert_allclose(gb, gm, atol=2e-5 * scale, rtol=1e-4, err_msg=name)

    for i, frame in enumerate(frames):
        state_m, loss_m = train_step(state_m, frame, i == 0, bn_train=bn_train, **KW)
        state_s, loss_s = train_step_spatial(state_s, frame, i == 0, bands=bands, halo=halo, bn_train=bn_train, **KW)
        assert float(loss_s) == pytest.approx(float(loss_m), rel=3e-6), i

    pm, ps = _flat(state_m), _flat(state_s)
    p_atol = 5e-4 if bn_train else 2e-6
    s_atol, s_rtol = (2e-4, 5e-3) if bn_train else (1e-6, 1e-5)
    for k in pm:
        if "running" in k:
            np.testing.assert_allclose(ps[k], pm[k], atol=s_atol, rtol=s_rtol, err_msg=k)
        else:
            np.testing.assert_allclose(ps[k], pm[k], atol=p_atol, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(state_s.carry["last_H3"].numpy(), state_m.carry["last_H3"].numpy(),
                               atol=2e-5 if bn_train else 1e-6)


def test_banded_step_matches_jax(sd):
    """One epoch-0 step (batch statistics) of 2 bands on a 96-row frame,
    halo 16, against the JAX package's train_step_spatial on the same
    weights (the .pt state-dict keys) and frame."""
    h = 96
    frame = _frames(h, 1)[0]
    state = init_train_state(Config(**KW), sd, (1, h, W, 3), "cpu")
    net_vars, raft_vars = convert_torch_state_dict(state_dict_for_save(state.model))
    jstate = jax_init_train_state(JaxConfig(**KW), net_vars, frame.shape)
    jstate, jloss_v = jax_train_step_spatial(jstate, raft_vars, jnp.asarray(frame), jnp.asarray(True),
                                             bands=2, halo=16, bn_train=True, **KW)
    state, loss = train_step_spatial(state, frame, True, bands=2, halo=16, bn_train=True, **KW)
    # f32 sums in other orders: measured 1.4e-7 relative
    print(f"banded step loss: port {float(loss)}, JAX {float(jloss_v)}")
    assert float(loss) == pytest.approx(float(jloss_v), rel=1e-6)
    got, _ = convert_torch_state_dict(state_dict_for_save(state.model))
    errs = {}
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got["params"])[0],
                                 jax.tree_util.tree_flatten_with_path(jstate.params)[0]):
        # Adam's first step is lr * g / |g| per component, so one whose
        # gradient is rounding noise moves by up to 2 lr between the packages:
        # the block conv's bias, whose exact gradient under batch statistics
        # is 0 (measured: 3 of 64 components, 2.0e-4). Every other leaf
        # measured <= 3.4e-7.
        key = jax.tree_util.keystr(path)
        d = np.abs(np.asarray(a) - np.asarray(b))
        errs[key] = f"{d.max():.1e} ({int((d > 5e-5).sum())} of {d.size} beyond 5e-5)"
        assert d.max() <= (2.5e-4 if key == "['enhance']['block']['conv']['bias']" else 1e-5), key
    print("parameters after one banded step, port against JAX:", errs)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
                                 jax.tree_util.tree_flatten_with_path(jstate.batch_stats)[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    for k in ("last_H3", "last_s3"):
        np.testing.assert_allclose(state.carry[k].numpy(), np.asarray(jstate.carry[k]), atol=1e-5)


def test_train_cli_spatial_bands(tmp_path):
    """--spatial_bands 2 through the train CLI writes the JAX layout (JAX
    tests/test_spatial.py:189)."""
    root = make_rlv_fixture(str(tmp_path / "rlv"), frames_per_scene=2, size=(64, 48))
    cfg = Config(lowlight_images_path=root, save=str(tmp_path / "exp"), dataset="RLV", frame_width=64,
                 frame_height=48, epochs=1, spatial_bands=2, spatial_halo=12, **KW)
    run_dir = run_training(cfg, device="cpu")
    assert glob.glob(os.path.join(run_dir, "model_epochs", "weights_0.pt"))
    with open(os.path.join(run_dir, "log.txt")) as f:
        log = f.read()
    assert log.count("train-epoch 000 ") >= 4
    losses = [float(line.rsplit(" ", 1)[1]) for line in log.splitlines() if "train-epoch 000 0" in line]
    assert len(losses) == 4 and np.isfinite(losses).all()
