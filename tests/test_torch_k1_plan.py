"""K1's launch plan and packed weights, on the CPU.

``k1_plan`` decides in Python which of K1's two kernels a launch takes and
how each is tiled, so it can be held here without a card: every bf16 launch
of a main-path frame (``chip_smoke.K1_LAYERS``) goes to the tensor-core
kernel, every f32 launch (those of a highest-mode frame, the Enhancer at
half resolution, the flow sidecar's RAFT grids at batch 1 and 4, ragged
shapes) to the FMA kernel, each with a grid that covers every pixel and
channel tile, shared memory that fits, copy widths its parts allow, and
enough blocks to fill the H100 where the layer has the work for it. The
packed weights are the originals with zeros around them, and the plain twin
cannot tell them apart.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from zero_tig_torch.models import build_model, init_random_state_dict
from zero_tig_torch.ops.fused_conv import (
    F32_COLS,
    F32_MIN_THREADS,
    F32_THREADS,
    K1_TILES,
    SM_COUNT,
    SMEM_LIMIT,
    ConvWeights,
    conv_weights,
    fused_conv,
    fused_conv_reference,
    k1_plan,
    pack_weights,
    pack_weights_f32,
    unpack_weights,
)
from zero_tig_torch.ops.fused_conv import _fma_smem

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

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


def _check_f32_plan(kh, kw, parts, h, w, cout, batch=1, aligns=None):
    plan = k1_plan(torch.float32, kh, kw, tuple(parts), h, w, cout, batch, aligns)
    assert plan.kernel == "fma"
    # the grid covers every pixel tile and every output channel
    assert plan.grid == (math.ceil(h / plan.rows) * math.ceil(w / F32_COLS), batch * math.ceil(cout / (8 * plan.cg)))
    assert plan.cout_p % 4 == 0 and 0 <= plan.cout_p - cout < 4 and plan.cin_p == sum(parts)
    assert 1 <= plan.cg <= 8 and plan.kc % 4 == 0 and 1 <= plan.kg <= plan.kc // 4
    assert plan.threads <= F32_THREADS and plan.resident in (1, 2) and not (plan.resident == 2 and kw == 5)
    # shared memory as the kernel counts it, for as many blocks as must be resident
    assert plan.smem == _fma_smem(plan.rows, plan.cg, plan.kg, plan.kc, kh, kw, sum(parts))
    assert plan.smem * plan.resident <= SMEM_LIMIT
    # each part is copied in units that divide its channels, its offset and its pointer's alignment
    off = 0
    for j, (c, v) in enumerate(zip(parts, plan.vec)):
        assert v in (1, 2, 4) and c % v == 0 and off % v == 0
        assert aligns is None or aligns[j] % (4 * v) == 0
        off += c
    # off the 1080p branch no block of more than 8 channels has fewer than 4 warps
    if plan.grid_rule and plan.cg > 1:
        assert plan.threads >= F32_MIN_THREADS, plan
    # where the layer has two blocks' work of 64 pixels x 64 channels for
    # every SM, it launches a block on each
    if math.ceil(h * w * batch / 64) * math.ceil(cout / 64) >= 2 * SM_COUNT:
        assert plan.blocks >= SM_COUNT, plan
    return plan


SIDECAR = [(grid, batch) for grid in chip_smoke.FLOW_GRIDS.values() for batch in (1, 4)]


@pytest.mark.parametrize("layer", LAYERS, ids=[la[0] for la in LAYERS])
def test_f32_launches_take_the_fma_kernel(fast_model, layer):
    cw = chip_smoke.layer_weights(fast_model, layer[1])
    kh, kw, _, cout = cw.w.shape
    _check_f32_plan(kh, kw, layer[2], *layer[3], cout)
    with pytest.raises(ValueError, match="f32 or bf16"):
        _plan(layer, cw, torch.float16)


@pytest.mark.parametrize("grid,batch", SIDECAR, ids=[f"{g[0]}x{g[1]}b{b}" for g, b in SIDECAR])
def test_f32_plan_at_the_flow_sidecar_grids(fast_model, grid, batch):
    for layer in chip_smoke.RAFT_K1_LAYERS + chip_smoke.GMA_K1_LAYERS:
        kh, kw, _, cout = chip_smoke.layer_weights(fast_model, layer[1]).w.shape
        _check_f32_plan(kh, kw, layer[2], *grid, cout, batch)


# the 1080p branch's tilings (rows, cg, kg, kc, resident), as measured and
# chosen at 1080p; the grid rule's 4-warp floor does not reach them
FULL_PLANS = {
    "d1.conv1": (16, 6, 1, 4, 1),
    "d1.conv2": (16, 6, 1, 8, 1),
    "d1.conv3+anchor": (16, 1, 2, 8, 2),
    "enh.in_conv": (16, 8, 1, 12, 2),
    "enh.block+res": (16, 8, 1, 8, 2),
    "enh.out_conv": (16, 1, 2, 8, 2),
    "d2.conv1": (16, 6, 1, 12, 1),
    "d2.conv2": (16, 6, 1, 8, 1),
    "d2.conv3+anchor": (16, 1, 2, 8, 2),
    "enh.in_conv@540x960": (16, 8, 1, 12, 2),
    "enh.block+res@540x960": (16, 8, 1, 8, 2),
    "enh.out_conv@540x960": (16, 1, 2, 8, 2),
}


@pytest.mark.parametrize("name", FULL_PLANS)
def test_f32_plans_at_1080p_are_unchanged(fast_model, name):
    layer = next(la for la in LAYERS if la[0] == name)
    kh, kw, _, cout = chip_smoke.layer_weights(fast_model, layer[1]).w.shape
    plan = _check_f32_plan(kh, kw, layer[2], *layer[3], cout)
    assert (plan.rows, plan.cg, plan.kg, plan.kc, plan.resident) == FULL_PLANS[name] and not plan.grid_rule


# the grid rule's tilings (rows, cg, kg, kc) of RAFT's and GMA's launches at
# batch 1: the last-wave rule's, but where its 4-warp floor moved a layer off
# one- and two-warp blocks to 64 channels (every mask2, convc2 at 63x125, the
# 256-wide layers at 55x128; timed against the old plans in PERF.md)
GRID_PLANS = {
    "raft.convc1@45x80": (8, 8, 2, 32),
    "raft.convc2@45x80": (8, 2, 4, 16),
    "raft.conv@45x80": (8, 4, 4, 32),
    "raft.gru.zr1@45x80": (8, 8, 2, 32),
    "raft.gru.q1@45x80": (8, 4, 4, 64),
    "raft.gru.zr2@45x80": (8, 8, 2, 32),
    "raft.gru.q2@45x80": (8, 4, 4, 64),
    "raft.fh1@45x80": (8, 8, 2, 32),
    "raft.fh2@45x80": (8, 1, 8, 64),
    "raft.mask0@45x80": (8, 8, 2, 32),
    "raft.mask2@45x80": (8, 8, 1, 16),
    "raft.convc1@63x125": (8, 8, 1, 16),
    "raft.convc2@63x125": (8, 8, 1, 16),
    "raft.conv@63x125": (8, 8, 2, 32),
    "raft.gru.zr1@63x125": (8, 8, 1, 16),
    "raft.gru.q1@63x125": (8, 8, 2, 32),
    "raft.gru.zr2@63x125": (8, 8, 1, 16),
    "raft.gru.q2@63x125": (8, 8, 2, 32),
    "raft.fh1@63x125": (8, 8, 1, 16),
    "raft.fh2@63x125": (8, 1, 8, 64),
    "raft.mask0@63x125": (8, 8, 1, 16),
    "raft.mask2@63x125": (8, 8, 1, 16),
    "raft.convc1@47x156": (8, 8, 1, 16),
    "raft.convc2@47x156": (8, 4, 2, 16),
    "raft.conv@47x156": (8, 8, 2, 32),
    "raft.gru.zr1@47x156": (8, 8, 1, 16),
    "raft.gru.q1@47x156": (8, 8, 2, 32),
    "raft.gru.zr2@47x156": (8, 8, 1, 16),
    "raft.gru.q2@47x156": (8, 8, 2, 32),
    "raft.fh1@47x156": (8, 8, 1, 16),
    "raft.fh2@47x156": (8, 1, 8, 64),
    "raft.mask0@47x156": (8, 8, 1, 16),
    "raft.mask2@47x156": (8, 8, 1, 16),
    "raft.convc1@55x128": (8, 8, 1, 16),
    "raft.convc2@55x128": (8, 4, 2, 16),
    "raft.conv@55x128": (8, 8, 2, 32),
    "raft.gru.zr1@55x128": (8, 8, 1, 16),
    "raft.gru.q1@55x128": (8, 8, 2, 32),
    "raft.gru.zr2@55x128": (8, 8, 1, 16),
    "raft.gru.q2@55x128": (8, 8, 2, 32),
    "raft.fh1@55x128": (8, 8, 1, 16),
    "raft.fh2@55x128": (8, 1, 8, 64),
    "raft.mask0@55x128": (8, 8, 1, 16),
    "raft.mask2@55x128": (8, 8, 1, 16),
    "gma.gru.zr1@55x128": (8, 8, 1, 16),
    "gma.gru.q1@55x128": (8, 8, 2, 32),
    "gma.gru.zr2@55x128": (8, 8, 1, 16),
    "gma.gru.q2@55x128": (8, 8, 2, 32),
    "gma.to_v@55x128": (8, 8, 2, 32),
}
GRID_LAYERS = {f"{la[0]}@{g[0]}x{g[1]}": (la, g) for g in (chip_smoke.RAFT, chip_smoke.SIDECAR, (47, 156), chip_smoke.SINTEL_GRID)
               for la in chip_smoke.RAFT_K1_LAYERS + (chip_smoke.GMA_K1_LAYERS if g == chip_smoke.SINTEL_GRID else [])}


@pytest.mark.parametrize("label", GRID_PLANS)
def test_f32_plans_at_the_raft_grids(fast_model, label):
    layer, grid = GRID_LAYERS[label]
    kh, kw, _, cout = chip_smoke.layer_weights(fast_model, layer[1]).w.shape
    plan = _check_f32_plan(kh, kw, layer[2], *grid, cout)
    assert (plan.rows, plan.cg, plan.kg, plan.kc, plan.resident) == (*GRID_PLANS[label], 1) and plan.grid_rule


SINTEL = [la for la in chip_smoke.K1_F32_LAYERS if la[3] == chip_smoke.SINTEL_GRID]


@pytest.mark.parametrize("layer", SINTEL, ids=[la[0] for la in SINTEL])
def test_f32_plan_at_the_sintel_grid_meets_the_floor(fast_model, layer):
    # RAFT's and GMA's launches at 55x128: every block holds 4 warps or
    # more, and the 256-wide layers take 64 channels a block (the last-wave
    # rule alone gave them one-warp blocks of 16)
    kh, kw, _, cout = chip_smoke.layer_weights(fast_model, layer[1]).w.shape
    plan = _check_f32_plan(kh, kw, layer[2], *layer[3], cout)
    assert plan.grid_rule and plan.rows == 8 and plan.threads >= F32_MIN_THREADS
    if cout >= 256:
        assert plan.cg == 8, plan


def test_grid_rule_launches_are_counted(monkeypatch):
    # launch_k1 counts, where it calls the library, each launch that the
    # grid rule tiled: not a 1080p-branch launch, not a plan given by hand
    import zero_tig_torch.ops.fused_conv as fc
    from zero_tig_torch.core import spans

    records = []

    class Library:  # the kernel library, which this box cannot build
        def zt_fused_conv(self, record, stream):
            records.append(record)
            return 0

    monkeypatch.setattr(fc.build, "library", Library)
    monkeypatch.setattr(fc.build, "stream_handle", lambda device: 0)

    def launch(b, h, w, parts, taps, cout, plan=None):
        xs = [torch.zeros(b, h, w, c) for c in parts]
        cw = conv_weights(torch.zeros(*taps, sum(parts), cout), torch.ones(cout), torch.zeros(cout))
        fc.launch_k1(xs, cw, plan=plan)
        return fc.k1_plan(torch.float32, *taps, tuple(parts), h, w, cout, b)

    before = dict(spans.COUNTS)
    gate = launch(1, 55, 128, (128, 128, 126, 2), (1, 5), 256)  # RAFT's zr1 at Sintel's grid
    launch(1, 55, 128, (128, 128, 126, 2), (1, 5), 256)
    head = launch(1, 55, 128, (256,), (3, 3), 2)  # fh2: a head of 2 channels
    full = launch(2, 200, 528, (48,), (3, 3), 61)  # the 1080p branch
    assert gate.grid_rule and head.grid_rule and not full.grid_rule
    assert spans.COUNTS["fused_conv_f32_grid"] - before["fused_conv_f32_grid"] == 3
    launch(1, 55, 128, (128, 128, 126, 2), (1, 5), 256, plan=fc.fma_plan(
        1, 5, (128, 128, 126, 2), 55, 128, 256, 1, None, rows=8, cg=2, kg=1, kc=8))
    assert spans.COUNTS["fused_conv_f32_grid"] - before["fused_conv_f32_grid"] == 3 and len(records) == 5
    # the wrappers' own counts are theirs: launch_k1 adds to no other entry
    assert {k: n for k, n in spans.COUNTS.items() if k != "fused_conv_f32_grid"} == \
        {k: n for k, n in before.items() if k != "fused_conv_f32_grid"}


@pytest.mark.parametrize("case", chip_smoke.FMA_CASES, ids=lambda c: f"{c[0]}{c[1]}{c[2]}{c[3]}")
def test_f32_plan_of_the_ragged_card_cases(case):
    (b, h, w), parts, (kh, kw), cout, _ = case
    aligns = (16, 4) if parts == (192, 64) else None  # chip_smoke's view one float into its buffer
    plan = _check_f32_plan(kh, kw, parts, h, w, cout, b, aligns)
    if aligns:
        assert plan.vec == (4, 1)


def test_f32_plans_reach_every_branch():
    # the card's f32 cases (chip_smoke.k1_fma_ragged) reach each of the plan's branches
    seen = {chip_smoke.fma_branch(k1_plan(torch.float32, kh, kw, parts, h, w, cout, b))
            for (b, h, w), parts, (kh, kw), cout, _ in chip_smoke.FMA_CASES}
    assert len(seen) == chip_smoke.FMA_BRANCHES


def test_copy_width_follows_part_widths_offsets_and_pointers():
    # the GRU convs' concat [net, inp, motion features, flow]
    assert k1_plan(BF16, 1, 5, (128, 128, 126, 2), 45, 80, 256).vec == (8, 8, 2, 2)
    assert k1_plan(BF16, 3, 3, (6, 3, 3), 1080, 1920, 48).vec == (2, 1, 1)
    assert k1_plan(BF16, 1, 1, (324,), 45, 80, 256).vec == (4,)
    # a part that starts at an odd channel of the concat is copied by element
    assert k1_plan(BF16, 3, 3, (5, 8), 37, 53, 16).vec == (1, 1)
    # a view whose pointer is only 4-byte aligned cannot take 16-byte copies
    assert k1_plan(BF16, 3, 3, (64, 64), 45, 80, 64, 1, (16, 4)).vec == (8, 2)
    # f32: units of 4, 2 or 1 elements (16, 8 or 4 bytes) by the same rules
    f32 = torch.float32
    assert k1_plan(f32, 1, 5, (128, 128, 126, 2), 45, 80, 256).vec == (4, 4, 2, 2)
    assert k1_plan(f32, 3, 3, (6, 3, 3), 1080, 1920, 48).vec == (2, 1, 1)
    assert k1_plan(f32, 1, 1, (324,), 45, 80, 256).vec == (4,)
    assert k1_plan(f32, 3, 3, (5, 8), 37, 53, 16).vec == (1, 1)
    assert k1_plan(f32, 3, 3, (64, 64), 45, 80, 64, 1, (16, 4)).vec == (4, 1)
    assert k1_plan(f32, 3, 3, (64, 64), 45, 80, 64, 1, (16, 8)).vec == (4, 2)


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
    # f32 weights: Cout padded to 4 for the FMA kernel, the originals otherwise
    wf = pack_weights_f32(w.float())
    assert wf.shape == (kh * kw, cin, cout + -cout % 4) and wf.is_contiguous()
    assert torch.equal(unpack_weights(wf, kh, kw, cin, cout), w.float())
    assert torch.count_nonzero(wf[:, :, cout:]) == 0
    assert torch.equal(conv_weights(w.float(), torch.ones(cout), torch.zeros(cout)).wp, wf)


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
