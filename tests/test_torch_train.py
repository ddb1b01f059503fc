"""The port's zero-shot training against the JAX package's, on the CPU, at
the JAX package's own training-test size (48x64, of_scale 2, 2 RAFT
iterations): the same weights (JAX init, BatchNorm running statistics moved
off (0, 1), through ``from_jax_variables``), frames and flags.

Covered: the step-0 gradient, ``train_chunk`` over 3 frames with a reset at
frame 0 in both precisions and both BatchNorm schedules, and the kernels'
weight snapshots after a step. In fast mode the JAX package takes its
default packed-pair (xpack) training path. The filters, the loss and
``reinit_enhancer`` are held in ``tests/test_torch_train_loss.py``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core import precision
from zero_tig_tpu.core.config import Config as JaxConfig
from zero_tig_tpu.losses.zero_tig_loss import zero_tig_loss as jax_loss
from zero_tig_tpu.models.network import forward_train as jax_forward_train
from zero_tig_tpu.models.network import init_network_variables
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_tpu.pipeline.steps import init_train_state as jax_init_train_state
from zero_tig_tpu.pipeline.steps import train_chunk as jax_train_chunk
from zero_tig_torch.core.checkpoint import from_jax_variables
from zero_tig_torch.core.config import Config
from zero_tig_torch.losses.zero_tig_loss import zero_tig_loss
from zero_tig_torch.models import build_model
from zero_tig_torch.models.network import forward_train
from zero_tig_torch.pipeline.steps import (
    eval_forward_step,
    init_train_state,
    predict_step,
    train_chunk,
    train_step,
)

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

H, W = 48, 64
KW = dict(of_scale=2, raft_iters=2)
FLAGS = np.array([True, False, False])


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


MODES = [(mode, bn_train) for mode in ("fast", "highest") for bn_train in (True, False)]


@pytest.fixture(scope="module")
def jax_side():
    """Everything the JAX package computes for this file, made once: the
    weights, and the reference runs of the gradient and trajectory tests. Each program is traced here, one after the other (the precision
    mode is a global that tracing reads), and XLA compiles them side by side
    in a few threads, which takes a third of the time of compiling each
    inside its own test. The programs and their inputs are what the tests
    would build themselves."""
    pool = ThreadPoolExecutor(max_workers=4)
    key0, key1 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    # jitted: the same values as the eager init, in a third of its time
    low_rv = jax.jit(init_raft_variables, static_argnums=(1, 2)).lower(key1, H, W)
    rv_job = pool.submit(low_rv.compile)
    rv_abstract = jax.tree_util.tree_map(lambda o: jax.ShapeDtypeStruct(o.shape, o.dtype), low_rv.out_info)
    nv = _np_tree(jax.jit(init_network_variables, static_argnums=(1, 2))(key0, H, W))
    rng = np.random.default_rng(2)
    bn = nv["batch_stats"]["enhance"]["block"]["bn"]
    bn["mean"] = rng.uniform(-0.1, 0.1, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    frames = (rng.random((3, 1, H, W, 3)) * 0.2).astype(np.float32)
    carry = {
        "last_H3": rng.uniform(0, 0.5, (1, H, W, 3)).astype(np.float32),
        "last_s3": rng.uniform(0.2, 1, (1, H, W, 3)).astype(np.float32),
    }
    jcarry = {k: jnp.asarray(v) for k, v in carry.items()}
    try:
        # train_chunk in each mode and BatchNorm schedule; the RAFT weights
        # are still compiling, their shapes are enough to trace
        chunk_jobs = {}
        for mode, bn_train in MODES:
            if bn_train:
                jax.clear_caches()  # the traces made in the other mode
            precision.set_precision(mode)
            st = jax_init_train_state(JaxConfig(**KW), nv, frames[0].shape)
            low = jax_train_chunk.lower(st, rv_abstract, jnp.asarray(frames), jnp.asarray(FLAGS), bn_train=bn_train, **KW)
            chunk_jobs[mode, bn_train] = pool.submit(low.compile)
        precision.set_precision("highest")
        rv = _np_tree(rv_job.result()(key1))

        # step 0 of a sequence (the warped state zeroed) for the gradient test
        def loss_fn(params):
            out, _, _ = jax_forward_train(
                {"params": params, "batch_stats": nv["batch_stats"]}, rv, jnp.asarray(frames[1]), jcarry,
                jnp.asarray(True), **KW,
            )
            return jax_loss(jnp.asarray(frames[1]), out)

        params0 = jax.tree_util.tree_map(jnp.asarray, nv["params"])
        grad_job = pool.submit(jax.jit(jax.value_and_grad(loss_fn)).lower(params0).compile)

        chunks = {}
        for (mode, bn_train), job in chunk_jobs.items():
            precision.set_precision(mode)
            st = jax_init_train_state(JaxConfig(**KW), nv, frames[0].shape)
            st, losses = job.result()(st, rv, jnp.asarray(frames), jnp.asarray(FLAGS))
            chunks[mode, bn_train] = _np_tree((st.params, st.batch_stats, st.carry, losses))
        ref_loss, ref_grads = grad_job.result()(params0)
        grad = float(ref_loss), _np_tree(ref_grads)
    finally:
        precision.set_precision("highest")
        pool.shutdown()
        jax.clear_caches()
    return {"case": (nv, rv, frames, carry), "chunks": chunks, "grad": grad}


@pytest.fixture(scope="module")
def case(jax_side):
    return jax_side["case"]


def _sd(nv_params, nv_stats, rv=None):
    return from_jax_variables({"params": nv_params, "batch_stats": nv_stats}, rv)


def _trained_keys(sd):
    return [k for k in sd if not k.startswith("raft.") and not k.endswith("num_batches_tracked")]


def test_step0_gradient_matches_jax_value_and_grad(case, jax_side):
    """Step 0 of a sequence (the warped state zeroed): the flow branch, whose
    f32 drift between the packages (7e-6 here) moves the Enhancer's input,
    carries no gradient and is held by the trajectory test instead."""
    nv, rv, frames, carry = case
    frame = frames[1]
    ref_loss, ref_grads = jax_side["grad"]
    ref = _sd(ref_grads, nv["batch_stats"])

    model = init_train_state(Config(**KW), _sd(nv["params"], nv["batch_stats"], rv), (1, H, W, 3), "cpu").model
    outs, _ = forward_train(model, torch.from_numpy(frame), {k: torch.from_numpy(v) for k, v in carry.items()},
                            torch.tensor(True), **KW)
    loss = zero_tig_loss(torch.from_numpy(frame), outs)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    grads = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
    assert len(grads) == 20  # the shared Enhancer block once; RAFT frozen
    errs = {}
    for name, g in grads.items():
        r = ref[name].numpy()
        # the shared block's conv bias feeds batch-statistics BatchNorm: its
        # exact gradient is 0, and both sides hold rounding noise; measured
        # 1.8e-5 of the BatchNorm shift's gradient norm
        norm = np.linalg.norm(ref["enhance.conv.1.bias"] if name == "enhance.conv.0.bias" else r)
        errs[name] = float(np.linalg.norm(g.numpy() - r) / norm)
    print("step-0 gradient, |port - JAX| / |JAX| per leaf:", {k: f"{v:.1e}" for k, v in errs.items()})
    # f32 convolutions and sums in another order; measured <= 2.1e-6 of the norm
    assert max(errs.values()) <= 1e-4, errs


# --------------------------------------------------------------- trajectory


@pytest.mark.parametrize("bn_train", [True, False])
@pytest.mark.parametrize("mode", ["highest", "fast"])
def test_train_chunk_matches_jax(case, jax_side, mode, bn_train):
    nv, rv, frames, _ = case
    j_params, j_stats, j_carry, j_losses = jax_side["chunks"][mode, bn_train]
    state = init_train_state(Config(precision=mode, **KW), _sd(nv["params"], nv["batch_stats"], rv), (1, H, W, 3), "cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, losses = train_chunk(state, frames, FLAGS, bn_train=bn_train, **KW)
    after = state.model.state_dict()
    ref = _sd(j_params, j_stats)
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    keys = _trained_keys(ref)
    stats = [k for k in keys if "running" in k]
    params = [k for k in keys if "running" not in k and not k.startswith("enhance.blocks.")]
    d_port = torch.cat([(after[k] - before[k]).flatten() for k in params])
    d_jax = torch.cat([(ref[k] - before[k]).flatten() for k in params])
    cos = float(torch.dot(d_port, d_jax) / (d_port.norm() * d_jax.norm()))
    carry = {k: state.carry[k].numpy() for k in j_carry}
    spread = _spread(after, losses.numpy(), carry, ref, j_losses, j_carry, params, stats)
    print(f"train_chunk {mode} bn_train={bn_train}, port against JAX: {spread}, update cosine {cos:.6f}")
    if mode == "highest":
        # Measured: losses within 2.9e-6 relative; bn_train False: parameters
        # 2e-7, carry 4e-7. With bn_train True a few components move by
        # rounding: their gradient is at rounding level (zero inputs at the
        # reset frame, cancellation in batch-statistics BatchNorm), and Adam's
        # normalised step takes its sign from that rounding. 3 components
        # (of 5184 and 36864) then differ by up to 1.94 lr, the running mean
        # by 7.4e-5 and the carry by 2.9e-4 -- as much as the JAX package
        # differs from itself when the frames are scaled by 1 + 2^-22
        # (5 components, 1.94 lr; 7.3e-5; 2.4e-4: measured once, by a second
        # JAX run on the scaled frames).
        np.testing.assert_allclose(losses.numpy(), j_losses, rtol=1e-5)
        for k in keys:
            d = (after[k] - ref[k]).abs()
            if k in stats:
                assert float(d.max()) <= (2e-4 if bn_train else 0.0), k
            else:
                assert float(d.max()) <= 2.5e-4 and float((d > 5e-5).float().mean()) <= 1e-3, k
        for k in ("last_H3", "last_s3"):
            np.testing.assert_allclose(carry[k], j_carry[k], atol=1e-3 if bn_train else 1e-5)
    else:
        # bf16 rounded at other places (the bias inside the library conv,
        # 0.2 * x in f32, the unfolded eval BatchNorm, gradient ties at 0 and
        # at the clip bounds): measured losses within 0.14%, update cosine
        # 0.9958 (bn_train True) and 0.9990, running statistics within 5e-4
        np.testing.assert_allclose(losses.numpy(), j_losses, rtol=1e-2)
        assert cos > 0.98, cos
        for k in stats:
            np.testing.assert_allclose(after[k].numpy(), ref[k].numpy(), rtol=2e-2, atol=1e-3)
    moved = [k for k in params if not torch.equal(after[k], before[k])]
    assert len(moved) == len(params)
    for k in stats:
        assert torch.equal(after[k], before[k]) != bn_train, k


def _spread(sd, losses, carry, ref, ref_losses, ref_carry, params, stats) -> str:
    """How far one training run lands from another."""
    dp = torch.cat([(sd[k] - ref[k]).abs().flatten() for k in params])
    ds = max(float((sd[k] - ref[k]).abs().max()) for k in stats)
    dc = max(float(np.abs(carry[k] - ref_carry[k]).max()) for k in ref_carry)
    dl = float(np.abs(np.asarray(losses) / ref_losses - 1).max())
    return (f"losses {dl:.2e} relative, parameters max {float(dp.max()):.2e} "
            f"({int((dp > 5e-5).sum())} of {dp.numel()} beyond 5e-5), statistics {ds:.2e}, carry {dc:.2e}")


# ------------------------------------------------------- init and snapshots


def test_second_step_and_inference_see_the_trained_weights(case):
    nv, rv, frames, carry = case
    sd0 = _sd(nv["params"], nv["batch_stats"], rv)
    cfg = Config(**KW)
    state = init_train_state(cfg, sd0, (1, H, W, 3), "cpu")
    state, _ = train_step(state, frames[0], True, **KW)
    sd1 = {k: v.clone() for k, v in state.model.state_dict().items()}
    carry1 = {k: v.clone() for k, v in state.carry.items()}
    state, loss2 = train_step(state, frames[1], False, **KW)

    # a fresh state holding the weights after step 1 computes step 2's loss
    fresh = init_train_state(cfg, sd1, (1, H, W, 3), "cpu")._replace(carry=carry1)
    _, loss2_fresh = train_step(fresh, frames[1], False, **KW)
    np.testing.assert_allclose(float(loss2), float(loss2_fresh), rtol=1e-6)

    # inference on the trained model uses its new weights, not the snapshot
    # taken when it was built: the same outputs as a model built from them
    trained = state.model
    assert not trained.prepared
    sd2 = trained.state_dict()
    (H2, H3, _), _ = predict_step(trained, frames[2], carry, False, **KW)
    assert trained.prepared
    (rH2, rH3, _), _ = predict_step(build_model(sd2, device="cpu", precision="highest"), frames[2], carry, False, **KW)
    (oH2, _, _), _ = predict_step(build_model(sd0, device="cpu", precision="highest"), frames[2], carry, False, **KW)
    torch.testing.assert_close(H2, rH2, rtol=0, atol=0)
    torch.testing.assert_close(H3, rH3, rtol=0, atol=0)
    assert float((H2 - oH2).abs().max()) > 1e-6
    # eval_forward_step reads the parameters themselves, and updates nothing
    stats = trained.enhance.conv[1].running_mean.clone()
    (eH2, eH3), _ = eval_forward_step(trained, frames[2], carry, False, **KW)
    assert eH2.shape == eH3.shape == (1, H, W, 3) and torch.isfinite(eH3).all()
    assert torch.equal(trained.enhance.conv[1].running_mean, stats)
