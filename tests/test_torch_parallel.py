"""Multi-device runs (``zero_tig_torch/parallel``) on the CPU: two gloo ranks
a test, spawned through ``parallel.launch.run``, each running a rank program
of ``parallel/probe.py`` (never a function of this file: a rank imports the
module of its target, and this one loads JAX). Held against the JAX
package's single-device runs, as its own ``tests/test_parallel.py`` holds its
sharded runs (:35-74 training, :77-101 streams, :131-178 inference, :181-215
CLIs, :217-290 the spatial axis), and against the port's single-process
paths. One frame size for the file, 96x64 (a 48-row band with a 16-row halo
is smaller than the frame), of_scale 2, 2 RAFT iterations, highest mode, the
port's seeded weights carried to JAX through the reference's state-dict keys.
"""

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core.checkpoint import convert_torch_state_dict
from zero_tig_tpu.core.config import Config as JaxConfig
from zero_tig_tpu.data import RLVDataset as JaxRLVDataset
from zero_tig_tpu.losses.zero_tig_loss import zero_tig_loss as jax_loss
from zero_tig_tpu.models.network import forward_train as jax_forward_train
from zero_tig_tpu.parallel import batched_records as jax_batched_records
from zero_tig_tpu.parallel import scene_streams as jax_scene_streams
from zero_tig_tpu.pipeline.spatial import train_step_spatial as jax_train_step_spatial
from zero_tig_tpu.pipeline.steps import init_train_state as jax_init_train_state
from zero_tig_tpu.pipeline.steps import predict_step as jax_predict_step
from zero_tig_torch import native
from zero_tig_torch.cli import predict, serve, train
from zero_tig_torch.core.checkpoint import from_jax_variables, save_pt, state_dict_for_save
from zero_tig_torch.core.config import Config
from zero_tig_torch.data import RLVDataset, create_dataset, make_rlv_fixture
from zero_tig_torch.losses.zero_tig_loss import zero_tig_loss
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.models.network import forward_train
from zero_tig_torch.parallel import batched_records, launch, probe, scene_streams
from zero_tig_torch.parallel.spmd_train import stream_records
from zero_tig_torch.pipeline.spatial import spatial_loss_and_grads
from zero_tig_torch.pipeline.steps import init_carry, init_train_state, predict_step

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each (the ranks take the parent's count) spends no CPU
# time waiting on the others.
torch.set_num_threads(1)

H, W = 96, 64
KW = dict(of_scale=2, raft_iters=2)
HALO = 16


@pytest.fixture(scope="module")
def sd():
    return init_random_state_dict(0)


def _inputs():
    """Two scenes' frames and random carries, (2, 1, H, W, 3) f32."""
    rng = np.random.default_rng(2)
    frames = (rng.random((2, 1, H, W, 3)) * 0.3).astype(np.float32)
    carry = {"last_H3": rng.uniform(0, 0.5, (2, 1, H, W, 3)).astype(np.float32),
             "last_s3": rng.uniform(0.2, 1, (2, 1, H, W, 3)).astype(np.float32)}
    return frames, carry


@pytest.fixture(scope="module")
def jax_side(sd):
    """The JAX package's single-device results this file compares with,
    computed in a few threads while the tests' ranks run: each a future."""
    nv, rv = convert_torch_state_dict(state_dict_for_save(build_model(sd, device="cpu", precision="highest")))
    frames, carry = _inputs()
    pool = ThreadPoolExecutor(max_workers=3)

    def grads(bn_train):
        # JAX train_step's value_and_grad (pipeline/steps.py:82-118) on the
        # batch of both scenes, each starting a sequence
        def loss_fn(params):
            out, new_bs, new_carry = jax_forward_train(
                {"params": params, "batch_stats": nv["batch_stats"]}, rv, jnp.asarray(frames[:, 0]),
                {k: jnp.asarray(v[:, 0]) for k, v in carry.items()}, jnp.asarray(True), bn_train=bn_train, **KW)
            return jax_loss(jnp.asarray(frames[:, 0]), out), (new_bs, new_carry)

        (loss, (_, new_carry)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(nv["params"])
        return float(loss), jax.tree_util.tree_map(np.asarray, g), jax.tree_util.tree_map(np.asarray, new_carry)

    def banded_step():
        st = jax_init_train_state(JaxConfig(**KW), nv, (1, H, W, 3))
        st, loss = jax_train_step_spatial(st, rv, jnp.asarray(frames[0]), jnp.asarray(True), bands=2, halo=HALO,
                                          bn_train=True, **KW)
        return float(loss), jax.tree_util.tree_map(np.asarray, (st.params, st.batch_stats, st.carry))

    jobs = {
        "grads": {bn: pool.submit(grads, bn) for bn in (True, False)},
        "banded_step": pool.submit(banded_step),
    }
    yield nv, rv, jobs
    pool.shutdown(wait=True)


def _jax_predict(nv, rv, frame, carry, flag):
    (H2, H3, s3), c = jax_predict_step(nv, rv, jnp.asarray(frame), {k: jnp.asarray(v) for k, v in carry.items()},
                                       jnp.asarray(flag), **KW)
    return [np.asarray(t) for t in (H2, H3, s3, c["last_H3"], c["last_s3"])]


def test_scene_streams_and_batched_records_match_jax(tmp_path):
    """Three scenes of 3, 3 and 2 frames over 2 streams: the same streams,
    lockstep batches (frames, flags, paths; the short stream wraps) as the
    JAX package's, and each rank's ``stream_records`` one column of them."""
    root = make_rlv_fixture(str(tmp_path / "rlv"), scenes=("S01", "S02", "S03"), frames_per_scene=3, size=(W, H))
    os.remove(os.path.join(root, "input", "S03", "low_light_10", "00002.png"))
    ds, jds = RLVDataset(root, "train", size=(W, H)), JaxRLVDataset(root, "train", size=(W, H))
    streams = scene_streams(ds, 2)
    assert streams == jax_scene_streams(jds, 2)
    assert [len(s) for s in streams] == [5, 3]  # S01 and S03 together: the longest scene first, to the emptiest
    got, ref = list(batched_records(ds, 2)), list(jax_batched_records(jds, 2))
    assert len(got) == len(ref) == 5
    for (f, g, p), (jf, jg, jp) in zip(got, ref):
        assert p == jp and g.tolist() == jg.tolist()
        np.testing.assert_array_equal(f, jf)
    # step 3: stream 0 reaches S03, stream 1 wraps to its start; both new sequences
    assert [b[1].tolist() for b in got] == [[True, True], [False, False], [False, False], [True, True],
                                            [False, False]]
    for i in range(2):
        col = list(stream_records(ds, 2, i))
        assert [(p, g) for _, g, p in col] == [(b[2][i], bool(b[1][i])) for b in got]
        np.testing.assert_array_equal(np.stack([f for f, _, _ in col]), np.stack([b[0][i] for b in got]))


def test_scene_parallel_predict_matches_jax(tmp_path, sd, jax_side):
    """Mesh 2x1 ``predict_scenes_spmd`` over 2 scenes x 3 frames: each frame
    once, on its scene's rank, bit-equal to the port's single-process
    ``predict_step`` loop and within 2e-5 of the JAX package's (JAX
    tests/test_parallel.py:131-178)."""
    nv, rv, _ = jax_side
    root = make_rlv_fixture(str(tmp_path / "rlv"), frames_per_scene=3, size=(W, H))
    cfg = Config(dataset="RLV", lowlight_images_path=root, frame_width=W, frame_height=H, mesh_data=2, **KW)
    ranks = launch.run(probe.predict_scenes, (cfg, sd), n_data=2, device="cpu")
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["count"] for r in ranks] == [3, 3]
    got = {**ranks[0]["outputs"], **ranks[1]["outputs"]}

    model = build_model(sd, device="cpu", precision="highest")
    ds = create_dataset("RLV", root, "test", size=(W, H))
    carry, jcarry = None, None
    worst = 0.0
    for rec in ds:
        frame = rec.image[None]
        if carry is None:
            carry = init_carry(model, frame.shape)
            jcarry = {k: v.numpy() for k, v in carry.items()}
        outs, carry = predict_step(model, frame, carry, rec.is_new_seq, **KW)
        j = _jax_predict(nv, rv, frame, jcarry, rec.is_new_seq)
        jcarry = {"last_H3": j[3], "last_s3": j[4]}
        for g, o, r in zip(got[rec.path], outs, j):
            assert torch.equal(g, o[0]), rec.path
            worst = max(worst, float(np.abs(g.numpy() - r[0]).max()))
    print(f"scene-parallel predict, port against JAX: max_abs_err {worst:.2e}")
    assert worst <= 2e-5


def test_row_sharded_predict_matches_jax(sd, jax_side):
    """Mesh 1x2 ``predict_step_banded`` (bands of 48 rows, halo 16) on a
    continuing frame with a random carry: H2, H3, s3 and the carry within
    3e-5 of the JAX package's whole-frame ``predict_step`` (JAX
    tests/test_parallel.py:217-290) and equal to the port's; at enh_scale 2
    (the Enhancer on the whole frame) equal to the port's whole-frame step."""
    nv, rv, _ = jax_side
    frames, carry = _inputs()
    frame, c0 = torch.from_numpy(frames[0]), {k: torch.from_numpy(v[0]) for k, v in carry.items()}
    calls = [(probe.predict_banded, (1, 2), (sd, "highest", frame[None], c0, [False], dict(halo=HALO, **KW))),
             (probe.predict_banded, (1, 2), (sd, "highest", frame[None], c0, [False],
                                             dict(halo=HALO, enh_scale=2, **KW)))]
    ranks = launch.run(probe.sequence, (calls,), n_spatial=2, device="cpu")
    model = build_model(sd, device="cpu", precision="highest")
    ref = _jax_predict(nv, rv, frames[0], {k: v[0] for k, v in carry.items()}, False)
    for enh_scale, res in zip((1, 2), ranks[0]):
        outs, _ = predict_step(model, frame, c0, False, enh_scale=enh_scale, **KW)
        got = [*res["outputs"][0], res["carry"]["last_H3"], res["carry"]["last_s3"]]
        for g, o in zip(got, [*outs, outs[1], outs[2]]):
            assert torch.equal(g, o), enh_scale  # f64 convolutions on the CPU: one set of bits, banded or whole
        if enh_scale == 1:
            errs = [float(np.abs(g.numpy() - r).max()) for g, r in zip(got, ref)]
            print(f"row-sharded predict, port against JAX (H2, H3, s3, carry): {[f'{e:.1e}' for e in errs]}")
            assert max(errs) <= 3e-5
    for k, v in ranks[0][0]["carry"].items():
        assert torch.equal(v, ranks[1][0]["carry"][k])  # both ranks hold the whole frame


def _close_grads(got: dict, ref: dict) -> dict:
    """tests/test_torch_spatial.py:124's limits, gradient by gradient."""
    errs = {}
    for name, gm in ref.items():
        gm, gb = gm.numpy(), got[name].numpy()
        if name == "enhance.conv.0.bias":
            # exactly zero under batch statistics: both sides hold cancellation noise
            assert np.abs(gm).max() < 1e-2 and np.abs(gb).max() < 1e-2, name
            continue
        scale = max(float(np.abs(gm).max()), 1e-3)
        np.testing.assert_allclose(gb, gm, atol=2e-5 * scale, rtol=1e-4, err_msg=name)
        errs[name] = float(np.abs(gb - gm).max()) / scale
    return errs


def test_row_sharded_train_step_matches_spatial_and_jax(sd, jax_side):
    """Mesh 1x2, an epoch-0 step (batch statistics: passes A and C all-reduce
    across the ranks) of a new sequence and one of a continuing frame: the
    loss, gradients and carry against the port's single-process 2-band
    ``spatial_loss_and_grads``; the new sequence's loss, updated parameters,
    statistics and carry also against the JAX package's
    ``train_step_spatial`` at the same bands and halo, at the limits of
    tests/test_torch_spatial.py."""
    _, _, jobs = jax_side
    frames, carry = _inputs()
    f, c = torch.from_numpy(frames[:1]), {k: torch.from_numpy(v[:1]) for k, v in carry.items()}
    calls = [(probe.train_steps, (1, 2), (Config(**KW), sd, f[:, None], c, [[flag]], [True], HALO))
             for flag in (True, False)]
    ranks = launch.run(probe.sequence, (calls,), n_spatial=2, device="cpu")
    for flag, r0, r1 in zip((True, False), *ranks):
        assert r0["replicated"] and r1["replicated"]
        step = r0["steps"][0]
        for k in ("last_H3", "last_s3"):
            assert torch.equal(step["carry"][k], r1["steps"][0]["carry"][k])  # the scene's whole carry on each
        state = init_train_state(Config(**KW), sd, (1, H, W, 3), "cpu")._replace(carry={k: v[0] for k, v in c.items()})
        loss, new_carry = spatial_loss_and_grads(state, frames[0], flag, bands=2, halo=HALO, bn_train=True, **KW)
        ref = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
        assert float(step["loss"]) == pytest.approx(float(loss), rel=3e-6)
        errs = _close_grads(step["grads"], ref)
        print(f"row-sharded gradients (new sequence {flag}) against the single-process bands, worst excess "
              f"{max(errs.values()):.1e}")
        for k in ("last_H3", "last_s3"):
            torch.testing.assert_close(step["carry"][k], new_carry[k], rtol=0, atol=1e-6)
    step = ranks[0][0]["steps"][0]  # the new sequence, against JAX
    state = init_train_state(Config(**KW), sd, (1, H, W, 3), "cpu")

    jloss, (jparams, jstats, jcarry) = jobs["banded_step"].result()
    assert float(step["loss"]) == pytest.approx(jloss, rel=1e-6)
    got, got_stats = convert_torch_state_dict({**state_dict_for_save(state.model), **step["trained"]})[0].values()
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(jparams)[0]):
        # Adam's first step moves a component whose gradient is rounding noise
        # by up to 2 lr: the block conv's bias (tests/test_torch_spatial.py:160)
        key = jax.tree_util.keystr(path)
        assert np.abs(np.asarray(a) - b).max() <= (2.5e-4 if key == "['enhance']['block']['conv']['bias']" else 1e-5), key
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got_stats)[0],
                                 jax.tree_util.tree_flatten_with_path(jstats)[0]):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-6, rtol=1e-5, err_msg=jax.tree_util.keystr(path))
    for k in ("last_H3", "last_s3"):
        np.testing.assert_allclose(step["carry"][k].numpy(), jcarry[k], atol=1e-5)


def test_scene_parallel_train_steps_match_jax(sd, jax_side):
    """Mesh 2x1, one scene a rank, a step in epoch 0 (the BatchNorm statistics
    of both scenes, shared across the ranks) and one in epoch 1 (running
    statistics), each the first frame of a sequence, against the gradient of
    the JAX package's train_step on the batch of both (its value_and_grad,
    pipeline/steps.py:98-112): the loss within rtol 2e-4 (JAX
    tests/test_parallel.py:74), each gradient within
    tests/test_torch_train.py's limit of the port's single-process step on
    the batch (and of JAX's, beyond the port's own distance from it), the
    carry within its limits; and the
    parameters bit-equal across the ranks after the update. A sequence's
    first frame, as in tests/test_torch_train.py's gradient test: on a
    continuing frame the flow's f32 drift between the packages moves the
    Enhancer's input (a continuing frame measured 7.9e-4 here, against the
    port's own batch step 7.1e-5)."""
    nv, rv, jobs = jax_side
    frames, carry = _inputs()
    f, c = torch.from_numpy(frames), {k: torch.from_numpy(v) for k, v in carry.items()}
    calls = [(probe.train_steps, (2, 1), (Config(**KW), sd, f[:, None], c, [[True], [True]], [bn], HALO))
             for bn in (True, False)]
    ranks = launch.run(probe.sequence, (calls,), n_data=2, device="cpu")
    for i, bn_train in enumerate((True, False)):
        r0, r1 = ranks[0][i], ranks[1][i]
        assert r0["replicated"] and r1["replicated"]
        assert torch.equal(r0["steps"][0]["loss"], r1["steps"][0]["loss"])
        for k, v in r0["steps"][0]["trained"].items():
            assert torch.equal(v, r1["steps"][0]["trained"][k]), k
        step = r0["steps"][0]

        # the port's single-process forward and backward on the batch of 2
        state = init_train_state(Config(**KW), sd, (2, H, W, 3), "cpu")
        outs, port_carry = forward_train(state.model, f[:, 0], {k: v[:, 0] for k, v in c.items()},
                                         torch.tensor(True), bn_train=bn_train, **KW)
        loss = zero_tig_loss(f[:, 0], outs)
        loss.backward()
        port = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}

        jloss, jgrads, jcarry = jobs["grads"][bn_train].result()
        jref = from_jax_variables({"params": jgrads, "batch_stats": nv["batch_stats"]}, rv)
        print(f"scene-parallel step bn_train={bn_train}: loss {float(step['loss'])}, port's batch step "
              f"{float(loss.detach())}, JAX {jloss}")
        assert float(step["loss"]) == pytest.approx(jloss, rel=2e-4)
        assert float(step["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
        # each gradient within 1e-4 of the port's single-process batch step
        # (tests/test_torch_train.py's limit, relative to the leaf's norm;
        # the shared block's conv bias, exactly 0 under batch statistics and
        # rounding noise on each side, relative to the BatchNorm shift's);
        # against JAX the mesh may add those 1e-4 to the distance of the
        # port's own batch step from JAX, measured up to 1.7e-4 with batch
        # statistics (Enhancer in_conv: the statistics' gradient cancels)
        # and 4.7e-6 without
        worst = {"port": 0.0, "JAX": 0.0}
        for name, g in step["grads"].items():
            g, p_ref, j_ref = g.numpy(), port[name].numpy(), jref[name].numpy()
            noise = bn_train and name == "enhance.conv.0.bias"
            norm = np.linalg.norm(port["enhance.conv.1.bias"].numpy() if noise else p_ref)
            e_port = np.linalg.norm(g - p_ref) / norm
            e_jax = np.linalg.norm(g - j_ref) / norm
            assert e_port <= 1e-4, (name, e_port)
            assert e_jax <= np.linalg.norm(p_ref - j_ref) / norm + 1e-4, (name, e_jax)
            worst = {"port": max(worst["port"], e_port), "JAX": max(worst["JAX"], e_jax)}
        print(f"  gradients, |mesh - ref| / |ref|, worst leaf: {worst}")
        for scene, r in enumerate((r0, r1)):
            got = r["steps"][0]["carry"]
            for k in ("last_H3", "last_s3"):
                torch.testing.assert_close(got[k][0], port_carry[k][scene], rtol=0, atol=1e-5)
                np.testing.assert_allclose(got[k].numpy()[0], jcarry[k][scene], atol=1e-3 if bn_train else 1e-5)


def test_cli_mesh_branches(tmp_path, sd):
    """``--mesh_data 2`` through the train, predict and serve entry points,
    each called on both ranks of one launch (each finds the process group
    and joins it, as under torchrun): train writes weights_0.pt and the
    result images, predict one PNG pair a frame (JAX
    tests/test_parallel.py:181-215), and the daemon's PNGs equal the
    single-device daemon's byte for byte, with a manifest line a frame.
    ``Config(mesh_data=2)`` constructs; a height the spatial axis cannot
    band raises."""
    root = make_rlv_fixture(str(tmp_path / "rlv"), frames_per_scene=2, size=(W, H))
    inbox = os.path.join(root, "input")
    weights = str(tmp_path / "seeded.pt")
    save_pt(weights, build_model(sd, device="cpu", precision="highest"))
    tiny = dict(frame_width=W, frame_height=H, mesh_data=2, **KW)
    cpu, fast_exit = {"device": "cpu"}, {"device": "cpu", "poll_sec": 0.05, "settle_sec": 0.0, "max_idle_sec": 0.3}
    calls = [
        (train.run_training, Config(dataset="RLV", lowlight_images_path=root, epochs=1, save=str(tmp_path / "exp"),
                                    **tiny), cpu),
        (predict.run_predict, Config(dataset="RLV", lowlight_images_path=root, model_pretrain=weights,
                                     save=str(tmp_path / "pred"), **tiny), cpu),
        (serve.run_serve, Config(lowlight_images_path=inbox, model_pretrain=weights, save=str(tmp_path / "served"),
                                 **tiny), fast_exit),
    ]
    ranks = launch.run(probe.sequence, ([(probe.call, (2, 1), (fn, (cfg,), kw)) for fn, cfg, kw in calls],),
                       n_data=2, device="cpu")
    run_dir = ranks[0][0]
    assert ranks[1][0] == run_dir  # rank 0 made it and told the other
    assert os.path.exists(os.path.join(run_dir, "model_epochs", "weights_0.pt"))
    for kind in ("denoise", "enhance"):
        assert len(glob.glob(os.path.join(run_dir, "result", kind, "*.png"))) == 4  # 2 scenes x 2 test frames
    with open(os.path.join(run_dir, "log.txt")) as fh:
        log = fh.read()
    assert "backend gloo" in log and log.count("spmd-epoch 000 ") == 3  # 2 lockstep steps and the mean
    preds = glob.glob(str(tmp_path / "pred" / "**" / "*_denoise.png"), recursive=True)
    assert len(preds) == 4 and len(glob.glob(str(tmp_path / "pred" / "**" / "*_enhance.png"), recursive=True)) == 4
    assert ranks[0][2] == 4  # rank 0 counts every frame served

    single = serve.run_serve(Config(lowlight_images_path=inbox, model_pretrain=weights, save=str(tmp_path / "one"),
                                    frame_width=W, frame_height=H, **KW), **fast_exit)
    assert single == 4

    def pngs(d):
        return {os.path.relpath(p, d): native.read_rgb(p) for p in glob.glob(f"{d}/**/*.png", recursive=True)}

    got, ref = pngs(str(tmp_path / "served")), pngs(str(tmp_path / "one"))
    assert got.keys() == ref.keys() and len(got) == 8
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with open(tmp_path / "served" / "manifest.jsonl") as fh:
        lines = [json.loads(line) for line in fh]
    assert sorted(x["path"] for x in lines) == sorted(glob.glob(f"{inbox}/**/*.png", recursive=True))
    assert [x["new_seq"] for x in lines] == [True, True, False, False]  # a round: one frame of each scene

    assert Config(mesh_data=2).mesh_data == 2
    with pytest.raises(ValueError, match="even band heights"):
        Config(mesh_spatial=2, frame_height=98)
