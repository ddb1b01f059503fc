"""K1's launch plan and packed weights, on the CPU.

``k1_plan`` decides in Python which of K1's two kernels a launch takes and
how the tensor-core kernel is tiled, so it can be held here without a card:
every bf16 launch of a main-path frame (``chip_smoke.K1_LAYERS``) goes to the
tensor-core kernel with a grid that fills the H100 where the layer has the
work for it, every f32 launch to the FMA kernel. The packed weights are the
originals with zeros around them, and the plain twin cannot tell them apart.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.ops.fused_conv import (
    K1_TILES,
    SM_COUNT,
    SMEM_LIMIT,
    ConvWeights,
    conv_weights,
    fused_conv,
    fused_conv_reference,
    k1_plan,
    pack_weights,
    unpack_weights,
)

BF16 = torch.bfloat16
# the Enhancer's launches at enh_scale=2: its five layers at 540x960
ENH_HALF = [(f"{la[0]}@540x960", *la[1:3], (540, 960), *la[4:]) for la in chip_smoke.K1_LAYERS if la[0].startswith("enh.")]
LAYERS = chip_smoke.K1_LAYERS + ENH_HALF


@pytest.fixture(scope="module")
def fast_model():
    return build_model(init_random_state_dict(0), device="cpu", precision="fast")


def _plan(layer, cw, dtype=BF16):
    kh, kw, _, cout = cw.w.shape
    return k1_plan(dtype, kh, kw, tuple(layer[2]), *layer[3], cout)


@pytest.mark.parametrize("layer", LAYERS, ids=[la[0] for la in LAYERS])
def test_main_path_layer_takes_the_tensor_core_kernel(fast_model, layer):
    cw = chip_smoke.layer_weights(fast_model, layer[1])
    kh, kw, cin, cout = cw.w.shape
    assert cw.w.dtype == BF16 and sum(layer[2]) == cin
    plan = _plan(layer, cw)
    assert plan.kernel == "mma"
    rows, bn = K1_TILES[plan.tile]
    h, w = layer[3]
    tiles = math.ceil(h / rows) * math.ceil(w / 16)
    # the grid covers every output channel and walks over every spatial tile
    assert plan.grid[1] == math.ceil(plan.cout_p / bn) and 1 <= plan.grid[0] <= tiles
    assert plan.cin_p % 16 == 0 and 0 <= plan.cin_p - cin < 16
    assert plan.cout_p % 8 == 0 and 0 <= plan.cout_p - cout < 8
    assert plan.kc % 16 == 0 and 16 <= plan.kc <= 64 and plan.smem <= SMEM_LIMIT
    # each part is copied in units that divide its channels and its offset
    off = 0
    for c, v in zip(layer[2], plan.vec):
        assert v in (1, 2, 4, 8) and c % v == 0 and off % v == 0
        off += c
    # where the layer has 100 blocks' worth of 4-row x 64-channel tiles, the
    # plan launches at least 100 blocks (of 132 SMs); a wide layer at full
    # resolution keeps every SM's resident blocks busy
    work = math.ceil(h / 4) * math.ceil(w / 16) * math.ceil(cout / 64)
    if work >= 100:
        assert plan.blocks >= 100, plan
    if (h, w) == chip_smoke.FULL:
        assert plan.blocks >= SM_COUNT and rows == 8


@pytest.mark.parametrize("layer", chip_smoke.K1_LAYERS[::4], ids=[la[0] for la in chip_smoke.K1_LAYERS[::4]])
def test_f32_launches_take_the_fma_kernel(fast_model, layer):
    cw = chip_smoke.layer_weights(fast_model, layer[1])
    assert _plan(layer, cw, torch.float32).kernel == "fma"
    with pytest.raises(ValueError, match="f32 or bf16"):
        _plan(layer, cw, torch.float16)


def test_copy_width_follows_part_widths_offsets_and_pointers():
    # the GRU convs' concat [net, inp, motion features, flow]
    assert k1_plan(BF16, 1, 5, (128, 128, 126, 2), 45, 80, 256).vec == (8, 8, 2, 2)
    assert k1_plan(BF16, 3, 3, (6, 3, 3), 1080, 1920, 48).vec == (2, 1, 1)
    assert k1_plan(BF16, 1, 1, (324,), 45, 80, 256).vec == (4,)
    # a part that starts at an odd channel of the concat is copied by element
    assert k1_plan(BF16, 3, 3, (5, 8), 37, 53, 16).vec == (1, 1)
    # a view whose pointer is only 4-byte aligned cannot take 16-byte copies
    assert k1_plan(BF16, 3, 3, (64, 64), 45, 80, 64, 1, (16, 4)).vec == (8, 2)


@pytest.mark.parametrize("shape", [(3, 3, 3, 48), (1, 1, 48, 3), (1, 5, 384, 256), (5, 1, 17, 126), (3, 3, 64, 64)])
def test_packed_weights_are_the_originals_in_zeros(shape):
    kh, kw, cin, cout = shape
    w = torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)).to(BF16)
    wp = pack_weights(w)
    cin_p, cout_p = cin + -cin % 16, cout + -cout % 8
    assert wp.shape == (kh * kw, cin_p, cout_p) and wp.dtype == BF16 and wp.is_contiguous()
    assert torch.equal(unpack_weights(wp, kh, kw, cin, cout), w)
    assert torch.count_nonzero(wp[:, cin:, :]) == 0 and torch.count_nonzero(wp[:, :, cout:]) == 0
    assert torch.count_nonzero(wp) == torch.count_nonzero(w)
    cw = conv_weights(w, torch.ones(cout), torch.zeros(cout))
    assert torch.equal(cw.wp, wp) and torch.equal(cw.w, w)
    assert conv_weights(w.float(), torch.ones(cout), torch.zeros(cout)).wp is None


@pytest.mark.parametrize("taps,parts,cout", [((3, 3), (5, 7, 3, 1), 6), ((1, 5), (20, 12), 126), ((1, 1), (48,), 3)])
def test_twin_on_unpacked_packed_weights_is_bit_equal(taps, parts, cout):
    rng = np.random.default_rng(cout)
    cin = sum(parts)
    w = torch.from_numpy(rng.standard_normal((*taps, cin, cout)).astype(np.float32) / (cin * 3) ** 0.5).to(BF16)
    cw = conv_weights(w, torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)),
                      torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1))
    xs = [torch.from_numpy(rng.standard_normal((2, 11, 19, c)).astype(np.float32)).to(BF16) for c in parts]
    res = torch.from_numpy(rng.standard_normal((2, 11, 19, cout)).astype(np.float32)).to(BF16)
    again = ConvWeights(unpack_weights(cw.wp, *taps, cin, cout), cw.scale, cw.shift)
    for kwargs in (dict(act="tanh", residual=res), dict(anchor=[res[..., :1], res[..., 1:]]),
                   dict(act="sigmoid_clip", out_dtype=torch.float32)):
        a = fused_conv_reference(xs, cw, **kwargs)
        assert torch.equal(a, fused_conv_reference(xs, again, **kwargs))
        # a CPU tensor takes the twin, and only because it lies on the CPU
        assert torch.equal(a, fused_conv(xs, cw, **kwargs))
