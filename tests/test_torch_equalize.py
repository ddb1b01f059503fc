"""The port's ``equalize01`` (K3 with its casts; the plain twin on the CPU)
against the JAX package's ``equalize01``, exactly, in f32 and in bf16.

bf16 is exact too: for every bf16 value in [0, 1] the product x * 255
gives the same truncated byte whether it is rounded to bf16 (ATen, and the
kernel) or kept in f32 (XLA may keep excess precision inside a fusion). The
"bf16_sweep" case holds all 16257 of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_tig_tpu.ops.equalize import equalize01 as jax_equalize01
from zero_tig_torch.ops.equalize import equalize01, equalize01_reference

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)


def _edges(rng, shape):
    """k / 255 and its f32 neighbours: the cast's truncation edges."""
    k = rng.integers(0, 256, shape).astype(np.float32) / np.float32(255)
    side = rng.integers(-1, 2, shape)
    down, up = np.nextafter(k, np.float32(-1)), np.nextafter(k, np.float32(2))
    return np.where(side < 0, down, np.where(side > 0, up, k)).astype(np.float32)


def _bf16_sweep():
    """Every bf16 value in [0, 1] (bit patterns 0x0000-0x3f80), then 0.5 to
    a whole number of 16-pixel rows."""
    bits = torch.arange(0, 0x3F81, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float().numpy()
    x = np.concatenate([x, np.full((-x.size) % 48, 0.5, np.float32)])
    return x.reshape(1, -1, 16, 3)


def _case(name):
    rng = np.random.default_rng(21)
    if name == "low_light":  # as the main path's denoised frames: bins 0-63
        return (rng.random((1, 24, 40, 3)) * 0.25).astype(np.float32)
    if name == "edges":
        return _edges(rng, (1, 24, 40, 3))
    if name == "constant_channel":
        x = rng.random((1, 24, 40, 3)).astype(np.float32)
        x[..., 1] = 0.4
        return x
    if name == "step0":  # 64 pixels a channel: step == 0 everywhere
        return rng.random((1, 8, 8, 3)).astype(np.float32)
    if name == "batch2_odd":
        x = rng.random((2, 37, 53, 3)).astype(np.float32)
        x[1, ..., 0] = 0.02
        return x
    return _bf16_sweep()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["low_light", "edges", "constant_channel", "step0", "batch2_odd", "bf16_sweep"])
def test_equalize01_exact_against_jax(name, dtype):
    x = _case(name)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jax.jit(jax_equalize01)(jnp.asarray(x, jdt)))
    got = equalize01(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "step0":  # the identity LUT: the truncated bytes themselves
        u8 = torch.clamp(torch.from_numpy(x).to(tdt) * 255.0, 0.0, 255.0).to(torch.uint8)
        np.testing.assert_array_equal(got.numpy(), u8.float().numpy())
    if name == "constant_channel":
        assert torch.equal(got[..., 1], torch.full_like(got[..., 1], float(int(0.4 * 255))))


def test_equalize01_on_the_cpu_is_its_twin():
    x = torch.from_numpy(_case("low_light"))
    assert torch.equal(equalize01(x), equalize01_reference(x))
