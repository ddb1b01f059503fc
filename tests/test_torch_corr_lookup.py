"""RAFT's correlation lookup: the kernel ``csrc/corr_lookup.cu`` behind
``models/raft/corr.py::lookup_corr`` and its plain twin
``lookup_corr_reference`` (the hat-weight form).

On the CPU: the twin against a naive bilinear sampler written per window
position (align_corners, zeros outside), which pins the function the kernel
implements apart from the matmul form; the wrapper's refusals; the CPU
wrapper as the twin rounded once; gradients through the differentiable
paths, which call the twin by name. On a card (marker ``card``;
``python -m pytest --noconftest -m card tests/test_torch_corr_lookup.py``):
the kernel against the twin at RAFT's grids in both level and output
dtypes, two launches bit-equal, and a graph replay of ``flow_graphed`` equal
to its eager pass with one counted launch an iteration. This file imports
no JAX."""

import pytest
import torch

from zero_tig_torch.core import spans
from zero_tig_torch.core.precision import numerics
from zero_tig_torch.flowtools.registry import get_flow_model, prepare_raft
from zero_tig_torch.models.raft.corr import build_corr_pyramid, lookup_corr, lookup_corr_reference
from zero_tig_torch.ops.sampling import coords_grid

torch.set_num_threads(1)


def _coords(b, h, w, seed, device="cpu"):
    """Pixel centres moved by up to a few pixels, with every kind of centre
    the lookup meets: exact integers, half-pixels, off the level's edges and
    far outside the image."""
    g = torch.Generator().manual_seed(seed)
    c = coords_grid(b, h, w) + 3 * torch.randn(b, h, w, 2, generator=g)
    k = torch.arange(b * h * w).reshape(b, h, w)
    c[k % 5 == 0] = c[k % 5 == 0].round()
    c[k % 5 == 1] = c[k % 5 == 1].floor() + 0.5
    c[k % 11 == 2] = torch.tensor([-1.5, h - 0.5])
    c[k % 13 == 3] = torch.tensor([1e4, -3e4])
    c[k % 17 == 4] = torch.tensor([w + 2.25, -6.75])
    return c.to(device).contiguous()


def _levels(b, h, w, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    f1, f2 = (torch.randn(b, h, w, 64, generator=g).to(device) for _ in range(2))
    return build_corr_pyramid(f1, f2, 4, dtype)


def _sample(grid, sx, sy):
    """One bilinear sample per query (align_corners: pixel k at k), zero
    outside: grid (q, h, w) f64, sx and sy (q,) f64."""
    q, h, w = grid.shape
    out = torch.zeros(q, dtype=torch.float64)
    if h == 0 or w == 0:
        return out
    x0, y0 = sx.floor(), sy.floor()
    fx, fy = sx - x0, sy - y0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = (x0 + dx).long(), (y0 + dy).long()
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            v = grid[torch.arange(q), yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            out += torch.where(inside, wx * wy * v, 0.0)
    return out


def naive_windows(levels, coords, radius):
    """The lookup one window position at a time, in f64: channel a*(2r+1)+b
    of level i samples (x/2^i + a - r, y/2^i + b - r)."""
    b, h1, w1, _ = coords.shape
    q = b * h1 * w1
    cx, cy = (coords[..., k].reshape(q).double() for k in (0, 1))
    cols = []
    for i, level in enumerate(levels):
        grid = level.reshape(q, *level.shape[-2:]).double()
        for a in range(2 * radius + 1):
            for bb in range(2 * radius + 1):
                cols.append(_sample(grid, cx / 2**i + a - radius, cy / 2**i + bb - radius))
    return torch.stack(cols, -1).reshape(b, h1, w1, -1)


@pytest.mark.parametrize("grid", [(6, 8), (13, 17)])
@pytest.mark.parametrize("radius", [3, 4])
def test_twin_matches_a_naive_sampler(grid, radius):
    """6x8 is ragged: levels 6x8, 3x4, 1x2 and an empty 0x1."""
    levels = _levels(2, *grid, seed=1)
    coords = _coords(2, *grid, seed=2)
    got = lookup_corr_reference(levels, coords, radius)
    want = naive_windows(levels, coords, radius)
    assert got.shape == (2, *grid, 4 * (2 * radius + 1) ** 2) and got.dtype == torch.float32
    # f32 against f64: the twin rounds each centre plus offset once
    tol = 1e-5 + 1e-5 * float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= tol


def _valid():
    return _levels(1, 6, 8, seed=3), _coords(1, 6, 8, seed=4)


def _refused_cases():
    def levels_as(fn):
        return lambda lv, c: ([fn(x) for x in lv], c, 4, torch.float32)

    return {
        "radius 5": lambda lv, c: (lv, c, 5, torch.float32),
        "radius 0": lambda lv, c: (lv, c, 0, torch.float32),
        "f16 levels": levels_as(lambda x: x.half()),
        "levels of two dtypes": lambda lv, c: ([lv[0]] + [x.bfloat16() for x in lv[1:]], c, 4, torch.float32),
        "f64 coords": lambda lv, c: (lv, c.double(), 4, torch.float32),
        "coords of 3 channels": lambda lv, c: (lv, torch.cat([c, c[..., :1]], -1), 4, torch.float32),
        "a level of other queries": lambda lv, c: ([lv[0][1:]] + lv[1:], c, 4, torch.float32),
        "a level that requires grad": levels_as(lambda x: x.clone().requires_grad_(True)),
    }


@pytest.mark.parametrize("case", list(_refused_cases()))
def test_lookup_refuses_what_the_kernel_does_not_take(case):
    levels, coords, radius, out_dtype = _refused_cases()[case](*_valid())
    with pytest.raises(ValueError):
        lookup_corr(levels, coords, radius, out_dtype)


def test_cpu_lookup_is_the_twin_rounded_once():
    levels, coords = _valid()
    want = lookup_corr_reference(levels, coords, 4)
    before = spans.COUNTS["corr_lookup"]
    assert torch.equal(lookup_corr(levels, coords, 4), want)
    got = lookup_corr(levels, coords, 4, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous() and torch.equal(got, want.to(torch.bfloat16))
    bf = [x.bfloat16() for x in levels]  # bf16 levels are read as stored
    assert torch.equal(lookup_corr(bf, coords, 4), lookup_corr_reference(bf, coords, 4))
    assert spans.COUNTS["corr_lookup"] == before  # the CPU launches no kernel


@pytest.mark.parametrize("name", ["raft", "raft_small"])
def test_differentiable_paths_train_the_feature_encoder(name):
    """The training pass looks up through the twin, so gradients reach the
    fnet through the correlation volume."""
    model = get_flow_model(name).init_fn(0, device="cpu")
    g = torch.Generator().manual_seed(5)
    a, b = (torch.rand(1, 48, 64, 3, generator=g) * 255 for _ in range(2))
    _, flows = model(a, b, 2, return_predictions=True)
    flows.square().mean().backward()
    grads = [p.grad for p in model.fnet.parameters() if p.requires_grad]
    assert grads and all(gr is not None and bool(torch.isfinite(gr).all()) for gr in grads)
    assert any(float(gr.abs().max()) > 0 for gr in grads)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _bf16_ulp(v):
    """One bf16 ulp at each value of v (bf16 keeps 8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-126))) - 7)


@pytest.mark.card
def test_kernel_matches_the_twin_on_the_card():
    """The streams' 45x80 and Sintel's 55x128 grids and a ragged 6x8 with
    an empty fourth level; f32 and bf16 levels, f32 and bf16 windows;
    radius 4 and 3. Two launches give the same bits."""
    dev = _card()
    bf16, f32 = torch.bfloat16, torch.float32
    for grid, radius in (((45, 80), 4), ((55, 128), 4), ((6, 8), 4), ((45, 80), 3), ((6, 8), 3)):
        coords = _coords(1, *grid, seed=grid[1] + radius, device=dev)
        for ldt in (f32, bf16):
            levels = _levels(1, *grid, seed=grid[0], dtype=ldt, device=dev)
            with numerics("highest"):  # the twin's products in f32, not TF32
                ref = lookup_corr_reference(levels, coords, radius)
            tol32 = 1e-5 + 1e-5 * float(ref.abs().max())
            got = lookup_corr(levels, coords, radius, f32)
            again = lookup_corr(levels, coords, radius, f32)
            low = lookup_corr(levels, coords, radius, bf16)
            torch.cuda.synchronize()
            label = f"{grid} r={radius} {ldt}"
            assert got.shape == ref.shape and low.dtype == bf16, label
            # f32: the same products, summed in another order than bmm's
            assert float((got - ref).abs().max()) <= tol32, label
            assert torch.equal(got, again), label
            # bf16: the f32 windows rounded once; within one bf16 ulp of the
            # twin rounded once, where the two f32 results may straddle a
            # rounding boundary by up to the f32 tolerance
            assert torch.equal(low, got.to(bf16)), label
            want = ref.to(bf16).float()
            assert bool(((low.float() - want).abs() <= _bf16_ulp(want) + tol32).all()), label


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "fast"])
def test_graph_replay_equals_the_eager_pass_on_the_card(precision):
    """A 440x1024 pair (Sintel's padded frame, grid 55x128), 6 iterations:
    the eager pass launches the lookup kernel once an iteration; the graph's
    capture launches it twice as often (its eager pass and the recorded
    one), its replay not at all, and the replay equals the eager pass."""
    dev = _card()
    iters = 6
    model = get_flow_model("raft").init_fn(0, device="cuda")
    prepare_raft(model, precision)
    g = torch.Generator(device=dev).manual_seed(7)
    a, b = (torch.rand(1, 440, 1024, 3, generator=g, device=dev) * 255 for _ in range(2))
    spans.reset_counts()
    with torch.no_grad(), numerics(precision):
        want = model(a, b, iters)
        assert spans.COUNTS["corr_lookup"] == iters
        model.flow_graphed(a, b, iters)  # the capture
        assert spans.COUNTS["corr_lookup"] == 3 * iters
        got = model.flow_graphed(a, b, iters)  # a replay
        torch.cuda.synchronize()
    assert spans.COUNTS["corr_lookup"] == 3 * iters
    assert spans.GRAPHS == {"raft_graph_capture": 1, "raft_graph_replay": 1}
    assert all(map(torch.equal, got, want))
