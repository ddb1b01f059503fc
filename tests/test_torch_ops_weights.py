"""The PyTorch port's weights, plain ops and import hygiene, against the JAX
package on the same numpy inputs (CPU, f32 / "highest")."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.core.checkpoint import export_torch_state_dict
from zero_tig_tpu.models.network import init_network_variables
from zero_tig_tpu.models.raft.corr import build_corr_pyramid as j_pyramid
from zero_tig_tpu.models.raft.corr import lookup_corr as j_lookup
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_tpu.ops.padding import pad8_replicate as j_pad8
from zero_tig_tpu.ops.resize import resize_bilinear as j_resize
from zero_tig_tpu.ops.warp import warp_tensor as j_warp
from zero_tig_torch.core.checkpoint import from_jax_variables
from zero_tig_torch.models import build_model, init_random_state_dict, network
from zero_tig_torch.models.raft.corr import build_corr_pyramid, lookup_corr
from zero_tig_torch.ops.padding import pad8_replicate
from zero_tig_torch.ops.resize import resize_bilinear
from zero_tig_torch.ops.sampling import coords_grid
from zero_tig_torch.ops.warp import warp_tensor
from zero_tig_torch.pipeline.steps import init_carry

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F32_TOL = dict(atol=1e-5, rtol=1e-5)  # f32 on both sides; sums in another order


def _drawn_like(init, key, rng):
    """The variable tree ``init(key, 16, 16)`` makes, its shapes from tracing
    alone (the eager init compiles op by op for tens of seconds), with
    values drawn with numpy: the conversion under test moves values, it
    does not read them."""
    tree = jax.eval_shape(functools.partial(init, h=16, w=16), key)
    return jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(a.dtype), tree)


def test_from_jax_variables_matches_export():
    rng = np.random.default_rng(0)
    nv = _drawn_like(init_network_variables, jax.random.PRNGKey(0), rng)
    rv = _drawn_like(init_raft_variables, jax.random.PRNGKey(1), rng)
    ref = export_torch_state_dict(nv, rv)
    got = from_jax_variables(nv, rv)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # and the port's model takes exactly these keys
    model = build_model(got, device="cpu", precision="highest")
    assert set(init_random_state_dict(0)) == set(model.state_dict())
    torch.testing.assert_close(
        model.state_dict()["raft.update_block.gru.convq2.weight"],
        got["raft.update_block.gru.convq2.weight"],
    )


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(8, 11), (36, 60), (24, 20)])
def test_resize_matches_jax(align_corners, size):
    x = np.random.default_rng(3).uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    ref = j_resize(jnp.asarray(x), size, align_corners=align_corners)
    got = resize_bilinear(torch.from_numpy(x), size, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_pad8_matches_jax():
    x = np.random.default_rng(4).uniform(0, 1, (1, 21, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pad8_replicate(torch.from_numpy(x)).numpy(), np.asarray(j_pad8(jnp.asarray(x)))
    )


def test_warp_matches_jax_with_scale_swap():
    # non-square scales: h_scale = 24/8 = 3, w_scale = 40/16 = 2.5, so the
    # reference's swap (h_scale on x, w_scale on y) changes the result
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (1, 24, 40, 6)).astype(np.float32)
    flow = rng.normal(0, 1.5, (1, 8, 16, 2)).astype(np.float32)
    ref, _ = jax.jit(j_warp)(jnp.asarray(flow), jnp.asarray(img))
    got = warp_tensor(torch.from_numpy(flow), torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # the quirk is live: the same warp without the swap disagrees
    swapped = warp_tensor(torch.from_numpy(flow * np.float32([2.5 / 3.0, 3.0 / 2.5])), torch.from_numpy(img))
    assert float((swapped - got).abs().max()) > 1e-2


def test_corr_pyramid_and_lookup_match_jax():
    # 6x8 at 1/8 resolution: levels 6x8, 3x4, 1x2 and an empty 0x1 level
    rng = np.random.default_rng(6)
    f1 = rng.normal(0, 1, (1, 6, 8, 32)).astype(np.float32)
    f2 = rng.normal(0, 1, (1, 6, 8, 32)).astype(np.float32)
    coords = np.asarray(coords_grid(1, 6, 8)) + rng.normal(0, 2, (1, 6, 8, 2)).astype(np.float32)
    ref = jax.jit(lambda a, b, c: j_lookup(j_pyramid(a, b, 4), c, 4))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords)
    )
    levels = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4, torch.float32)
    assert [tuple(lv.shape[-2:]) for lv in levels] == [(6, 8), (3, 4), (1, 2), (0, 1)]
    got = lookup_corr(levels, torch.from_numpy(coords), 4)
    assert got.shape == (1, 6, 8, 324)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_import_pulls_in_no_jax():
    # nor flax, OpenCV, Pillow, optax or matplotlib: the machine with the
    # card has none of them
    banned = ("jax", "flax", "cv2", "PIL", "optax", "matplotlib")
    code = (
        "import sys, zero_tig_torch.pipeline.steps, zero_tig_torch.models, zero_tig_torch.data, zero_tig_torch.eval,"
        " zero_tig_torch.core.train_ckpt, zero_tig_torch.native, chip_smoke;"
        "import zero_tig_torch.cli.train, zero_tig_torch.cli.predict, zero_tig_torch.cli.evals,"
        " zero_tig_torch.cli.run_pipeline, zero_tig_torch.cli.serve, zero_tig_torch.pipeline.spatial;"
        "import zero_tig_torch.utils, zero_tig_torch.flowtools, zero_tig_torch.flowtools.benchmark,"
        " zero_tig_torch.flowtools.train, zero_tig_torch.cli.demo, zero_tig_torch.eval.vmaf,"
        " zero_tig_torch.data.augmentor, zero_tig_torch.models.pwc, zero_tig_torch.models.classical_flow,"
        " zero_tig_torch.models.raft.small;"
        f"banned = {banned!r};"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned or m.startswith('zero_tig_tpu')];"
        "assert not bad, bad"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO, timeout=120)


def test_port_sources_name_no_jax():
    files = list((REPO / "zero_tig_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    files += list((REPO / "zero_tig_torch" / "csrc").glob("*.cu*"))
    files += [REPO / "zero_tig_torch" / "native" / "pngio.cpp"]
    for f in files:
        text = f.read_text()
        assert "zero_tig_tpu" not in text.replace("zero_tig_tpu/", ""), f
        assert "import jax" not in text and "from jax" not in text, f


def test_highest_mode_scopes_the_tf32_switches(monkeypatch):
    # building a model of either mode leaves the process's switches alone;
    # a highest-mode frame runs with TF32 off and restores them after
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    sd = init_random_state_dict(0)
    fast = build_model(sd, device="cpu", precision="fast")
    highest = build_model(sd, device="cpu", precision="highest")
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32

    seen = []

    def spy(raft, last_H3, last_s3, L2, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return torch.zeros(*last_H3.shape[:3], 6, dtype=last_H3.dtype)

    monkeypatch.setattr(network, "update_cache", spy)
    frame, carry = torch.rand(1, 16, 16, 3), init_carry(highest, (1, 16, 16, 3))
    for model in (highest, fast):
        network.forward_inference(model, frame, carry, torch.tensor(True))
    assert seen == [(False, False), (True, True)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_entry_point_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(init_random_state_dict(0))
