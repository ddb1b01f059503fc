"""The plain twins of the port's CUDA kernels against the Pallas kernels
they replace (interpret mode, as the JAX package's own tests run them) and
against the JAX package's XLA paths, on the CPU.

K1 fused_conv, K2 update_core (K1 + the GRU kernel), K3 equalize_u8, and
conv3x3_bf16 (K1 without an epilogue).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core import precision
from zero_tig_tpu.models.layers import Conv
from zero_tig_tpu.models.raft.update import BasicUpdateBlock, update_block_apply_fast
from zero_tig_tpu.models.raft.update_kernel import update_core_kernel
from zero_tig_tpu.ops import pack_conv as pc
from zero_tig_tpu.ops.equalize import equalize_uint8
from zero_tig_tpu.ops.pallas_conv import conv3x3_bf16 as conv3x3_bf16_pallas
from zero_tig_tpu.ops.pallas_equalize import equalize_uint8_pallas
from zero_tig_torch.core.checkpoint import from_jax_raft_variables
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.models.raft.update import update_core
from zero_tig_torch.ops.conv3x3 import conv3x3_bf16
from zero_tig_torch.ops.equalize import equalize_u8
from zero_tig_torch.ops.fused_conv import ConvWeights, fused_conv

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

BF16 = torch.bfloat16
PACK_TOL = dict(atol=2e-2, rtol=2e-2)  # as tests/test_pack_conv.py: bf16 outputs


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _cw(wk, scale, shift, dtype):
    return ConvWeights(_t(wk, dtype).contiguous(), _t(scale), _t(shift))


@pytest.fixture
def conv_case():
    rng = np.random.default_rng(11)

    def make(h, w, cins, cout):
        xs = [rng.standard_normal((1, h, w, c)).astype(np.float32) for c in cins]
        wk = (0.2 * rng.standard_normal((3, 3, sum(cins), cout))).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, (cout,)).astype(np.float32)
        shift = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
        return xs, wk, scale, shift

    return make


@pytest.mark.parametrize("act", ["none", "relu", "leaky", "sigmoid_clip"])
@pytest.mark.parametrize("residual", [False, True])
def test_k1_bf16_matches_conv3x3_packed(conv_case, act, residual):
    (x,), wk, scale, shift = conv_case(8, 12, [6], 6)
    ref = pc.conv3x3_packed(
        pc.pack(jnp.asarray(x)), pc.build_weight_blocks(jnp.asarray(wk)),
        pc.pair_params(jnp.asarray(scale)), pc.pair_params(jnp.asarray(shift)),
        h=8, w=12, act=act, residual=residual, interpret=True,
    )
    ref = np.asarray(pc.unpack(ref, 8, 12), np.float32)
    xb = _t(x, BF16)
    got = fused_conv([xb], _cw(wk, scale, shift, BF16), act=act, residual=xb if residual else None)
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), ref, **PACK_TOL)


def test_k1_bf16_matches_conv3x3_packed_multi(conv_case):
    xs, wk, scale, shift = conv_case(8, 10, [6, 3, 3], 8)
    ref = pc.conv3x3_packed_multi(
        [pc.pack(jnp.asarray(x)) for x in xs],
        pc.build_weight_blocks_multi(jnp.asarray(wk), (6, 3, 3)),
        pc.pair_params(jnp.asarray(scale)), pc.pair_params(jnp.asarray(shift)),
        h=8, w=10, act="leaky", interpret=True,
    )
    ref = np.asarray(pc.unpack(ref, 8, 10), np.float32)
    got = fused_conv([_t(x, BF16) for x in xs], _cw(wk, scale, shift, BF16), act="leaky")
    np.testing.assert_allclose(got.float().numpy(), ref, **PACK_TOL)


@pytest.mark.parametrize("parts", [[6], [3, 3]])
def test_k1_bf16_matches_residual1x1_packed(parts):
    rng = np.random.default_rng(12)
    h, w, cin, cout = 8, 12, 16, sum(parts)
    x = rng.standard_normal((1, h, w, cin)).astype(np.float32)
    anchors = [rng.uniform(0, 1, (1, h, w, c)).astype(np.float32) for c in parts]
    wk = (0.1 * rng.standard_normal((cin, cout))).astype(np.float32)
    b = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
    if len(parts) == 1:
        ref = pc.residual1x1_packed(
            pc.pack(jnp.asarray(x)), pc.pack(jnp.asarray(anchors[0])), jnp.asarray(wk),
            jnp.asarray(b), h=h, w_img=w, interpret=True,
        )
    else:
        ref = pc.residual1x1_packed_multi(
            pc.pack(jnp.asarray(x)), [pc.pack(jnp.asarray(a)) for a in anchors],
            jnp.asarray(wk), jnp.asarray(b), h=h, w_img=w, interpret=True,
        )
    ref = np.asarray(pc.unpack(ref, h, w), np.float32)
    cw = _cw(wk[None, None], np.ones(cout), b, BF16)
    got = fused_conv([_t(x, BF16)], cw, anchor=[_t(a, BF16) for a in anchors], lo=1e-4, hi=1.0)
    np.testing.assert_allclose(got.float().numpy(), ref, **PACK_TOL)


@pytest.mark.parametrize("kernel,pad", [((1, 1), 0), ((3, 3), 1), ((1, 5), (0, 2)), ((5, 1), (2, 0))])
def test_k1_f32_matches_jax_conv_highest(kernel, pad):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 7, 9, 10)).astype(np.float32)
    conv = Conv(12, kernel, padding=pad)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    precision.set_precision("highest")
    ref = np.asarray(conv.apply(v, jnp.asarray(x)))
    p = v["params"]
    cw = _cw(p["kernel"], np.ones(12), p["bias"], torch.float32)
    # the multi-input path: the 10 channels arrive as two tensors
    got = fused_conv([_t(x[..., :4]).contiguous(), _t(x[..., 4:]).contiguous()], cw)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def _draw_convs(tree, rng):
    """Each conv {'kernel', 'bias'} of a parameter tree uniform in
    +-1/sqrt(fan_in), torch's default bound."""
    if "kernel" in tree:
        bound = 1 / np.sqrt(np.prod(tree["kernel"].shape[:-1]))
        return {k: rng.uniform(-bound, bound, v.shape).astype(np.float32) for k, v in tree.items()}
    return {k: _draw_convs(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def update_case():
    """The RAFT update block's parameters, drawn with numpy into the tree the
    JAX block's init makes (its shapes, from tracing alone: the init itself
    compiles for seconds), and a port state dict that holds them."""
    shapes = {"net": 128, "inp": 128, "corr": 324, "flo": 64, "flow": 2}
    abstract = [jax.ShapeDtypeStruct((1, 2, 2, shapes[k]), jnp.float32) for k in ("net", "inp", "corr", "flow")]
    tree = jax.eval_shape(BasicUpdateBlock(hidden_dim=128).init, jax.random.PRNGKey(0), *abstract)["params"]
    rng = np.random.default_rng(7)
    params = _draw_convs(tree, rng)
    sd = init_random_state_dict(0)
    sd.update(from_jax_raft_variables({"params": {"update_block": params}}))
    x = {k: rng.standard_normal((1, 6, 10, c)).astype(np.float32) for k, c in shapes.items()}
    x["flo"] = np.abs(x["flo"])  # a relu output
    return params, sd, x


def test_k2_bf16_matches_update_core_kernel(update_case):
    params, sd, x = update_case
    ref_net, ref_delta = update_core_kernel(
        params, *(jnp.asarray(x[k]) for k in ("net", "inp", "corr", "flo", "flow")), interpret=True
    )
    ub = build_model(sd, device="cpu", precision="fast").raft.update_block
    net, delta = update_core(
        ub.kw, _t(x["net"], BF16), _t(x["inp"], BF16), _t(x["corr"], BF16),
        _t(x["flo"], BF16), _t(x["flow"]),
    )
    assert net.dtype == BF16 and delta.dtype == torch.float32
    # same roundings on both sides; a sum taken in another order can move a
    # bf16 value by one ulp (2^-7 for |net| < 1). Measured: net 3.9e-3 (one ulp
    # at |net| in [0.5, 1)), delta 1.3e-4
    np.testing.assert_allclose(net.float().numpy(), np.asarray(ref_net, np.float32), atol=2.0**-7)
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref_delta), atol=2e-3)


def test_k2_f32_matches_update_block_apply_fast_highest(update_case):
    params, sd, x = update_case
    precision.set_precision("highest")
    ref_net, ref_delta = update_block_apply_fast(
        params, *(jnp.asarray(x[k]) for k in ("net", "inp", "corr", "flow"))
    )
    ub = build_model(sd, device="cpu", precision="highest").raft.update_block
    flow = _t(x["flow"])
    net, delta = update_core(ub.kw, _t(x["net"]), _t(x["inp"]), _t(x["corr"]), ub.flow_features(flow), flow)
    # f32 on both sides, sums in another order. Measured: net 8.3e-7, delta 1.1e-7
    np.testing.assert_allclose(net.numpy(), np.asarray(ref_net), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref_delta), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout", [(3, 48), (9, 16), (64, 64)])
@pytest.mark.parametrize("out_dtype", ["bf16", "f32"])
def test_conv3x3_bf16_twin_matches_pallas(cin, cout, out_dtype):
    """K1 in the role of conv3x3_bf16 (its twin here) against the Pallas
    kernel in interpret mode, as tests/test_pallas_kernels.py:37-56 runs it."""
    rng = np.random.default_rng(14)
    x = np.asarray(jnp.asarray(rng.random((2, 9, 16, cin)), jnp.bfloat16), np.float32)
    w = np.asarray(jnp.asarray(rng.standard_normal((3, 3, cin, cout)) * 0.1, jnp.bfloat16), np.float32)
    b = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, BF16) if out_dtype == "bf16" else (jnp.float32, torch.float32)
    ref = np.asarray(conv3x3_bf16_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), out_dtype=jdt, interpret=True),
                     np.float32)
    got = conv3x3_bf16(_t(x), _t(w), _t(b), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (2, 9, 16, cout)
    # the same bf16 products summed in f32 in another order: f32 outputs to
    # f32 rounding, bf16 outputs within one bf16 ulp (2^-7 |ref|) plus that
    # f32 difference, which can flip the sign of a sum near 0. Measured:
    # f32 2.4e-6, bf16 identical
    if out_dtype == "f32":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got.float().numpy() - ref) <= 2.0**-7 * np.abs(ref) + 1e-5)


def test_conv3x3_bf16_refuses_other_taps():
    with pytest.raises(ValueError, match="3, 3"):
        conv3x3_bf16(torch.zeros(1, 4, 4, 2), torch.zeros(1, 1, 2, 2))


def test_k3_exact_against_equalize_uint8_and_pallas():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
    img[0, ..., 1] = 77  # constant channel: step == 0, identity
    img[1, ..., 2] = rng.choice([3, 200], (24, 40)).astype(np.uint8)  # two levels
    img[1, ..., 0] = rng.integers(10, 40, (24, 40), dtype=np.uint8)  # narrow range
    got = equalize_u8(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(equalize_uint8(jnp.asarray(img))))
    np.testing.assert_array_equal(got, np.asarray(equalize_uint8_pallas(jnp.asarray(img), interpret=True)))
    np.testing.assert_array_equal(got[0, ..., 1], img[0, ..., 1])
