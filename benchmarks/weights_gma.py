"""Seeded GMA weights, drawn on the device in one call, as ``weights.py``
draws RAFT's.

Every conv with a bias uniform in +-1/sqrt(fan_in) (torch's ``Conv2d``
bound, weight and bias), the context net's BatchNorm affine and running
statistics near identity (``weights._RANGES``), ``to_v`` at its default
bound. Two draws are not the published initialisation, on purpose:

- ``gamma`` U(0.5, 1.0). The published init is 0, where the aggregation
  adds nothing to the motion features and the check could not see it; a
  trained GMA has learnt it away from 0.
- ``to_qk`` U(+-QK_GAIN/sqrt(fan_in)). The seeded context features are
  small (root mean square 0.06-0.09 at Sintel's size), and at the default
  bound the logits of a row spread by ~3e-4: every row of the attention is
  the mean of all 7040 positions (entropy ln 7040 = 8.86), and the
  aggregation is a constant shift. QK_GAIN 200 multiplies the logits by
  40000, and the rows are peaked, as a trained attention's are: a mean row
  entropy of 0.05-4.35 nats over 12 seeds drawn on the H100
  (``drivers/flowseq_gma.py`` reports it as ``attn_entropy``).

The relative position embeddings are U(-1, 1) (never read), and the state
gets RelPosEmb's index buffer and the cnet's second names of its strided
blocks' BatchNorm (``downsample.1``), so that it loads into RAFTGMA whole.
"""

from __future__ import annotations

import math

import torch

from reference.gma_sintel import GMA_PARAMS, MAX_POS
from weights import _RANGES

QK_GAIN = 200.0
_UNIFORM = {"gamma": (0.5, 1.0), "emb": (-1.0, 1.0), **_RANGES}


def make_state(seed: int, device) -> dict[str, torch.Tensor]:
    """A state dict under GMA's published names, float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in GMA_PARAMS]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, shape, kind), n in zip(GMA_PARAMS, sizes):
        v = u[off:off + n].reshape(shape)
        off += n
        if kind in ("conv_w", "conv_b", "qk_w", "v_w"):
            w_shape = shape if kind != "conv_b" else next(s for k, s, _ in GMA_PARAMS if k == key[:-4] + "weight")
            bound = (QK_GAIN if kind == "qk_w" else 1.0) / math.sqrt(math.prod(w_shape[1:]))
            out[key] = (2.0 * v - 1.0) * bound
        else:
            lo, hi = _UNIFORM[kind]
            out[key] = lo + (hi - lo) * v
    deltas = torch.arange(MAX_POS, device=device).view(1, -1) - torch.arange(MAX_POS, device=device).view(-1, 1)
    out["att.pos_emb.rel_ind"] = deltas + MAX_POS - 1
    for k in [k for k in out if k.startswith("cnet.") and ".norm3." in k]:
        out[k.replace(".norm3.", ".downsample.1.")] = out[k]
    return {k: v.contiguous() for k, v in out.items()}
