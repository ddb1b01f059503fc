"""The flow sidecar's models against the JAX package on the CPU: small-RAFT,
PWC-lite and pyramidal Lucas-Kanade forwards, RAFT's differentiable
``return_predictions`` path, and the two sampling ops they add.

Weights are drawn with numpy into the JAX trees' shapes and carried to the
port by ``core.checkpoint``; inputs are numpy draws from a seed. JAX runs in
"highest" unless a test says otherwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core import precision as j_precision
from zero_tig_tpu.models.classical_flow import lk_forward
from zero_tig_tpu.models.pwc import init_pwc_variables, pwc_forward
from zero_tig_tpu.models.raft.raft import init_raft_variables, raft_forward
from zero_tig_tpu.models.raft.small import init_raft_small_variables, raft_small_forward
from zero_tig_tpu.ops.resize import upflow8 as j_upflow8
from zero_tig_tpu.ops.sampling import grid_sample_pixel as j_grid_sample_pixel
from zero_tig_torch.core.checkpoint import (
    from_jax_pwc_variables,
    from_jax_raft_small_variables,
    from_jax_raft_variables,
)
from zero_tig_torch.flowtools.registry import get_flow_model
from zero_tig_torch.models.classical_flow import LucasKanade
from zero_tig_torch.models.pwc import PWCLite
from zero_tig_torch.models.raft.raft import RAFT
from zero_tig_torch.models.raft.small import RAFTSmall
from zero_tig_torch.ops.resize import upflow8
from zero_tig_torch.ops.sampling import grid_sample_pixel

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

H, W = 48, 64


def drawn_variables(init, seed):
    """The tree ``init`` makes, its shapes from tracing alone (an eager init
    compiles op by op), with values drawn with numpy: conv kernels and
    biases uniform in +-1/sqrt(fan_in), BatchNorm near identity."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(functools.partial(init, h=16, w=16), jax.random.PRNGKey(0))
    fan_in = {}

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        parent = jax.tree_util.keystr(path[:-1])
        if "kernel" in name:
            fan_in[parent] = int(np.prod(leaf.shape[:-1]))
            b = 1 / np.sqrt(fan_in[parent])
        elif "mean" in name or ("bias" in name and "batch_stats" not in jax.tree_util.keystr(path)):
            b = 0.1
        else:  # scale, var
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.uniform(-b, b, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture
def jax_mode():
    """Set the JAX package's global precision for one test, then restore it."""
    saved = j_precision.get_mode()
    yield j_precision.set_precision
    j_precision.set_precision(saved)


def frames(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.float32)
    return a, b


def compiled(fn, *args):
    """``fn`` jitted for ``args``, compiled at XLA's backend optimisation
    level 0 (half the compile time; XLA's arithmetic, its code less tuned),
    and called."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _port(model, state_dict):
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing), (missing, unexpected)
    return model.eval()


def test_raft_small_matches_jax(jax_mode):
    jax_mode("highest")
    v = drawn_variables(init_raft_small_variables, 0)
    model = _port(RAFTSmall(), from_jax_raft_small_variables(v))
    a, b = frames(1, 44, 60)  # padded to 48x64
    ref_low, ref_seq = compiled(lambda v, a, b: raft_small_forward(v, a, b, iters=3, return_predictions=True), v, a, b)
    with torch.no_grad():
        low, up = model(torch.from_numpy(a), torch.from_numpy(b), 3)
        _, seq = model(torch.from_numpy(a), torch.from_numpy(b), 3, return_predictions=True)
    assert up.shape == (1, H, W, 2) and seq.shape == (3, 1, H, W, 2)
    # f32 on both sides; sums in another order, carried through 3 iterations
    np.testing.assert_allclose(low.numpy(), np.asarray(ref_low), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(seq.numpy(), np.asarray(ref_seq), atol=2e-4, rtol=1e-5)
    torch.testing.assert_close(up, seq[-1], atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["highest", "fast"])
def test_pwc_lite_matches_jax(jax_mode, mode):
    jax_mode(mode)
    v = drawn_variables(init_pwc_variables, 2)
    model = _port(PWCLite(), from_jax_pwc_variables(v))
    a, b = frames(3, 40, 60)  # padded to 48x64
    (ref_low, ref_up), ref_seq = compiled(
        lambda v, a, b: (pwc_forward(v, a, b), pwc_forward(v, a, b, return_predictions=True)[1]), v, a, b)
    dtype = torch.float32 if mode == "highest" else torch.bfloat16
    with torch.no_grad():
        low, up = model(torch.from_numpy(a), torch.from_numpy(b), dtype=dtype)
    assert low.dtype == up.dtype == torch.float32 and up.shape == (1, H, W, 2)
    if mode == "highest":
        # f32 on both sides: sums in another order
        tol = dict(atol=1e-5, rtol=1e-5)
        with torch.no_grad():
            _, seq = model(torch.from_numpy(a), torch.from_numpy(b), return_predictions=True)
        assert seq.shape == (3, 1, H, W, 2)
        np.testing.assert_allclose(seq.numpy(), np.asarray(ref_seq), **tol)
    else:
        # bf16 activations through 14 conv layers and 3 warps: an activation
        # one bf16 ulp (2^-8) apart in one package moves the flow by ~1e-2
        # of its range; the two round in different places (torch rounds a
        # conv once with its bias, XLA the conv and then the sum)
        scale = float(np.abs(np.asarray(ref_up)).max())
        tol = dict(atol=3e-2 * scale, rtol=0)
    np.testing.assert_allclose(low.numpy(), np.asarray(ref_low), **tol)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up), **tol)


def test_lk_pyramid_matches_jax(jax_mode):
    jax_mode("highest")
    # a smooth texture and the same texture moved by (1.5, -0.75) px
    h, w = 96, 128
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def texture(x, y):
        return 127 + 60 * np.sin(x / 5.3) * np.cos(y / 7.1) + 50 * np.sin((x + 2 * y) / 11.7)

    img1 = np.repeat(texture(x, y)[None, ..., None], 3, -1).astype(np.float32)
    img2 = np.repeat(texture(x - 1.5, y + 0.75)[None, ..., None], 3, -1).astype(np.float32)
    ref_low, ref = compiled(lambda a, b: lk_forward({}, a, b, iters=3), img1, img2)
    low, got = LucasKanade()(torch.from_numpy(img1), torch.from_numpy(img2), 3)
    ref, got = np.asarray(ref), got.numpy()
    # the Shi-Tomasi gate lam_min > lam_tau and the near-singular solves
    # beside it turn an f32 rounding into a larger step at a few pixels, and
    # the x2 upsampling and the 11x11 windows spread it (JAX against itself,
    # compiled at XLA's default and at level 0: 22 pixels beyond 1e-4).
    # Count those pixels (at most 1%) and bound them; hold every other pixel
    # to f32 sums in another order.
    off = np.abs(got - ref).max(axis=-1) > 1e-4
    assert off.sum() <= 0.01 * off.size, f"{off.sum()} pixels differ beyond 1e-4"
    np.testing.assert_allclose(got[~off], ref[~off], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)
    assert low.shape == np.asarray(ref_low).shape
    # and the known motion (1.68 px) is found inside the frame, to the
    # accuracy of the JAX function's own estimate (an EPE of ~0.2 px)
    inner = got[0, 16:-16, 16:-16]
    epe = float(np.sqrt(((inner - np.float32([1.5, -0.75])) ** 2).sum(-1)).mean())
    assert epe < 0.5, epe


def test_raft_return_predictions_matches_jax(jax_mode):
    jax_mode("highest")
    v = drawn_variables(init_raft_variables, 4)
    sd = {k.removeprefix("raft."): t for k, t in from_jax_raft_variables(v).items()}
    model = _port(RAFT(), sd)
    a, b = frames(5)
    _, ref_seq = compiled(lambda v, a, b: raft_forward(v, a, b, iters=2, return_predictions=True), v, a, b)
    seq = get_flow_model("raft").predictions_fn(model, torch.from_numpy(a), torch.from_numpy(b), 2)
    assert seq.requires_grad and seq.shape == (2, 1, H, W, 2)
    # f32 on both sides: sums in another order, through the convex upsample
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(ref_seq), atol=2e-5, rtol=1e-5)
    # the last prediction is the inference loop's flow (K2's twin on the CPU)
    _, up = get_flow_model("raft").forward_fn(model, torch.from_numpy(a), torch.from_numpy(b), 2)
    torch.testing.assert_close(seq[-1].detach(), up, atol=1e-5, rtol=1e-5)
    # gradients reach every parameter but the BatchNorm running statistics
    seq[-1].sum().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_grid_sample_pixel_and_upflow8_match_jax():
    rng = np.random.default_rng(6)
    img = rng.normal(0, 1, (2, 9, 13, 5)).astype(np.float32)
    # coordinates inside, on the border and beyond it on every side
    x = rng.uniform(-2, 14, (2, 7, 11)).astype(np.float32)
    y = rng.uniform(-2, 10, (2, 7, 11)).astype(np.float32)
    x[0, 0, :4] = [0, 12, -1, 12.5]
    flow = rng.normal(0, 2, (1, 5, 7, 2)).astype(np.float32)
    ref32, ref16, ref_up = jax.jit(lambda img, x, y, flow: (
        j_grid_sample_pixel(img, x, y), j_grid_sample_pixel(img.astype(jnp.bfloat16), x, y), j_upflow8(flow)
    ))(img, x, y, flow)
    for dt, want in ((torch.float32, ref32), (torch.bfloat16, ref16)):
        got = grid_sample_pixel(torch.from_numpy(img).to(dt), torch.from_numpy(x), torch.from_numpy(y))
        assert got.dtype == torch.float32
        # f32 weights and sums on both sides, one fused multiply-add apart
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(upflow8(torch.from_numpy(flow)).numpy(), np.asarray(ref_up), atol=1e-5, rtol=1e-6)
