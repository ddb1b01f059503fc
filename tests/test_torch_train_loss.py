"""The port's training filters and 17-term loss against the JAX package's,
on the CPU, and the reference's Enhancer init: the cases of
``tests/test_torch_train.py`` that need no JAX training step, kept in their
own file so that the JAX compile of that file's trajectories does not hold
up these.

The loss is compared on one identical set of outputs: the JAX package's
``forward_train`` on frame 1 with a carried state, in highest mode, on the
weights, frames and carry of ``tests/test_torch_train.py`` (48x64,
of_scale 2, 2 RAFT iterations; JAX init, BatchNorm running statistics moved
off (0, 1)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core import precision
from zero_tig_tpu.losses.zero_tig_loss import zero_tig_loss as jax_loss
from zero_tig_tpu.models.network import forward_train as jax_forward_train
from zero_tig_tpu.models.network import init_network_variables
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_tpu.ops import filters as jf
from zero_tig_torch.losses.zero_tig_loss import zero_tig_loss
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.models.network import TrainOutputs, reinit_enhancer
from zero_tig_torch.ops import filters as tf

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

H, W = 48, 64
KW = dict(of_scale=2, raft_iters=2)


@pytest.fixture(scope="module")
def jax_forward():
    """(frame 1, the JAX forward's outputs on it), the inputs drawn as
    ``tests/test_torch_train.py::jax_side`` draws them."""
    key0, key1 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    # jitted: the same values as the eager init, in a third of its time
    nv = jax.tree_util.tree_map(np.asarray, jax.jit(init_network_variables, static_argnums=(1, 2))(key0, H, W))
    rv = jax.jit(init_raft_variables, static_argnums=(1, 2))(key1, H, W)
    rng = np.random.default_rng(2)
    bn = nv["batch_stats"]["enhance"]["block"]["bn"]
    bn["mean"] = rng.uniform(-0.1, 0.1, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    frames = (rng.random((3, 1, H, W, 3)) * 0.2).astype(np.float32)
    carry = {
        "last_H3": jnp.asarray(rng.uniform(0, 0.5, (1, H, W, 3)).astype(np.float32)),
        "last_s3": jnp.asarray(rng.uniform(0.2, 1, (1, H, W, 3)).astype(np.float32)),
    }
    precision.set_precision("highest")
    try:
        out = jax.jit(functools.partial(jax_forward_train, **KW))(nv, rv, jnp.asarray(frames[1]), carry,
                                                                 jnp.asarray(False))[0]
        return frames[1], jax.tree_util.tree_map(np.asarray, out)
    finally:
        jax.clear_caches()


# ---------------------------------------------------------------- filters


@pytest.mark.parametrize("shape", [(1, 48, 64, 3), (2, 13, 17, 3)])
def test_filters_match_jax(shape):
    rng = np.random.default_rng(5)
    x = rng.random(shape).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(tf.gauss_kernel(21, 1.0), np.asarray(jf.gauss_kernel(21, 1.0)))
    for got, ref in zip(tf.pair_downsampler(tx), jf.pair_downsampler(jx)):
        assert got.shape == ref.shape  # floor on odd sizes
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)
    # f32 windows summed in another order: measured <= 6.7e-7 (local_stddev)
    for name, got, ref in [
        ("blur", tf.blur(tx), jf.blur(jx)),
        ("local_mean", tf.local_mean(tx), jf.local_mean(jx)),
        ("local_stddev", tf.local_stddev(tx), jf.local_stddev(jx)),
        ("avg_pool2d", tf.avg_pool2d(tx, 5, 1, 2), jf.avg_pool2d(jx, 5, 1, 2)),
        ("local_variance", tf.calculate_local_variance(tx), jf.calculate_local_variance(jx)),
    ]:
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=1e-5, err_msg=name)
    # a step function: equal wherever the similarity is not within rounding of 0.975
    smooth = torch.from_numpy(x * 0.1 + y * 0.01)
    for a, b in [(tx, torch.from_numpy(y)), (tx, smooth)]:
        got = tf.texture_difference(a, b).numpy()
        ref = np.asarray(jf.texture_difference(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
        assert got.shape == ref.shape == shape[:3] + (1,)
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("is_wb", [False, True])
def test_loss_matches_jax_on_identical_outputs(jax_forward, is_wb):
    frame, jax_outputs = jax_forward
    loss_fn = jax.jit(functools.partial(jax_loss, is_wb=is_wb))
    ref = float(loss_fn(jnp.asarray(frame), jax.tree_util.tree_map(jnp.asarray, jax_outputs)))
    outs = TrainOutputs(*(torch.from_numpy(np.array(v)) for v in jax_outputs[:23]))
    got = float(zero_tig_loss(torch.from_numpy(frame), outs, is_wb=is_wb))
    print(f"loss is_wb={is_wb}: {got} against {ref}, {abs(got / ref - 1):.2e} relative")
    # f32 sums in another order; measured 6.5e-8 relative
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# ------------------------------------------------------------------- init


def test_reinit_enhancer_statistics():
    sd = init_random_state_dict(0)
    model = build_model(sd, device="cpu", precision="highest")
    reinit_enhancer(model, torch.Generator().manual_seed(3))
    assert not model.prepared
    enh = dict(model.enhance.named_parameters())
    for name, p in enh.items():
        v = p.detach().double()
        if name.endswith("bias"):
            assert torch.count_nonzero(v) == 0, name
            continue
        n, centre = v.numel(), 1.0 if p.dim() == 1 else 0.0
        assert abs(float(v.mean()) - centre) < 4 * 0.02 / n**0.5, name
        assert 0.02 * (1 - 4 / (2 * n) ** 0.5) < float(v.std()) < 0.02 * (1 + 4 / (2 * n) ** 0.5), name
    out = model.state_dict()
    for alias in ("enhance.blocks.0", "enhance.blocks.2"):
        assert torch.equal(out[f"{alias}.0.weight"], out["enhance.conv.0.weight"])
    for k in ("running_mean", "running_var"):
        assert torch.equal(out[f"enhance.conv.1.{k}"], sd[f"enhance.conv.1.{k}"])
    again = build_model(sd, device="cpu", precision="highest")
    reinit_enhancer(again, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(model.enhance.parameters(), again.enhance.parameters()))
