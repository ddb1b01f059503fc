"""The port's streaming inference against the JAX package's, end to end on
the CPU: the same weights (JAX init -> ``from_jax_variables``), frames and
carry, over 4 frames with a new sequence at frame 2, in both precisions.

The fast comparison runs the JAX package with its Pallas kernels on
(``set_pack_conv`` and ``set_raft_kernel``, interpret mode), the kernels
this slice ports. Its warp is the TPU block gather, the port's the exact
bilinear sample, so the fast check is a tolerance check.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core import precision
from zero_tig_tpu.models.network import init_network_variables
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_tpu.pipeline.steps import predict_chunk as jax_predict_chunk
from zero_tig_torch.core.checkpoint import from_jax_variables
from zero_tig_torch.models import build_model
from zero_tig_torch.pipeline.steps import predict_chunk, predict_step

H, W = 48, 64
KW = dict(of_scale=2, raft_iters=3)
# measured on this case: highest <= 8e-7 on H2/H3/s3 and u8 <= 1 (a value on
# a truncation edge); fast <= 2^-7 (one bf16 ulp at 1.0) and u8 <= 2
TOL = {"highest": (1e-5, 1), "fast": (2e-2, 3)}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def case():
    # jitted, and the two compiled side by side: the same values as the eager
    # inits, which compile op by op, in half their time
    keys = [jax.random.PRNGKey(0), jax.random.PRNGKey(1)]
    lowered = [jax.jit(init, static_argnums=(1, 2)).lower(key, H, W)
               for init, key in zip((init_network_variables, init_raft_variables), keys)]
    with ThreadPoolExecutor(max_workers=2) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    nv, rv = (_np_tree(fn(key)) for fn, key in zip(compiled, keys))
    rng = np.random.default_rng(0)
    # running statistics away from (0, 1) so the folded BatchNorm matters
    bn = nv["batch_stats"]["enhance"]["block"]["bn"]
    bn["mean"] = rng.uniform(-0.1, 0.1, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    frames = rng.uniform(0, 1, (4, 1, H, W, 3)).astype(np.float32)
    carry = {
        "last_H3": rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32),
        "last_s3": rng.uniform(0.2, 1, (1, H, W, 3)).astype(np.float32),
    }
    flags = np.array([False, False, True, False])
    return nv, rv, frames, carry, flags


def _jax_run(case, mode):
    nv, rv, frames, carry, flags = case
    jc = {k: jnp.asarray(v) for k, v in carry.items()}
    precision.set_precision(mode)
    if mode == "fast":
        precision.set_pack_conv(True)
        precision.set_raft_kernel(True)
    try:
        out = jax_predict_chunk(nv, rv, jnp.asarray(frames), jc, jnp.asarray(flags), **KW)
    finally:
        precision.set_pack_conv(False)
        precision.set_raft_kernel(False)
        precision.set_precision("highest")
        jax.clear_caches()
    return out


def _quantize_u8(x):
    """JAX's emit="u8" formula (steps.py:263) on the host: bit-identical to
    the in-graph quantisation of the same f32 values."""
    return np.clip(np.asarray(x) * np.float32(255.0), 0.0, 255.0).astype(np.uint8)


@pytest.mark.parametrize("mode", ["highest", "fast"])
def test_predict_chunk_matches_jax(case, mode):
    nv, rv, frames, carry, flags = case
    (jH2, jH3, js3), jcarry = _jax_run(case, mode)
    model = build_model(from_jax_variables(nv, rv), device="cpu", precision=mode)
    (H2, H3, s3), tcarry = predict_chunk(model, frames, carry, flags, **KW)
    (vH2, vH3), _ = predict_chunk(model, frames, carry, flags, emit="u8", **KW)

    atol, u8_tol = TOL[mode]
    for got, ref in [(H2, jH2), (H3, jH3), (s3, js3), (tcarry["last_H3"], jcarry["last_H3"])]:
        assert got.shape == (4, 1, H, W, 3)[-got.dim():] and np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0)
    for got, ref in [(vH2, jH2), (vH3, jH3)]:
        diff = got.numpy().astype(np.int32) - _quantize_u8(ref).astype(np.int32)
        assert int(np.abs(diff).max()) <= u8_tol
    # the carry moved the output: frame 1 differs from its new-sequence run
    (alone, _, _), _ = predict_step(model, frames[1], carry, True, **KW)
    assert float((alone - H2[1]).abs().max()) > 1e-3


def test_predict_chunk_accepts_uint8_frames(case):
    nv, rv, frames, carry, flags = case
    model = build_model(from_jax_variables(nv, rv), device="cpu", precision="highest")
    u8 = (frames * 255).astype(np.uint8)
    (a, _, _), _ = predict_chunk(model, u8, carry, flags, **KW)
    (b, _, _), _ = predict_chunk(model, u8.astype(np.float32) / 255.0, carry, flags, **KW)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_enh_scale_matches_jax(case):
    # the Enhancer at half resolution (24x32) and s2 resized back up, in
    # highest mode: the same tolerance as the full-resolution comparison
    nv, rv, frames, carry, flags = case
    jc = {k: jnp.asarray(v) for k, v in carry.items()}
    (jH2, jH3, js3), _ = jax_predict_chunk(nv, rv, jnp.asarray(frames), jc, jnp.asarray(flags), enh_scale=2, **KW)
    model = build_model(from_jax_variables(nv, rv), device="cpu", precision="highest")
    (H2, H3, s3), _ = predict_chunk(model, frames, carry, flags, enh_scale=2, **KW)
    for got, ref in [(H2, jH2), (H3, jH3), (s3, js3)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL["highest"][0], rtol=0)
    (full, _, _), _ = predict_chunk(model, frames, carry, flags, **KW)
    assert float((full - H2).abs().max()) > 1e-3  # the half-resolution Enhancer is live
    # a frame that does not divide by enh_scale runs at full resolution, with a warning
    with pytest.warns(UserWarning, match="not divisible"):
        (odd, _, _), _ = predict_chunk(model, frames[:1], carry, flags[:1], enh_scale=5, **KW)
    torch.testing.assert_close(odd, full[:1], rtol=0, atol=0)
