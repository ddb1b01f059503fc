"""K2's elementwise kernel: the SepConvGRU gate products (``csrc/gru.cu``).

With the K1 convolutions these make up the RAFT update core that the Pallas
kernel ``zero_tig_tpu/models/raft/update_kernel.py::update_core_kernel``
computed on the TPU (see ``models/raft/update.py::update_core``).

    gru_reset(zr, net)     -> r * net                 r = zr[..., hd:]
    gru_update(zr, q, net) -> (1 - z) * net + z * q   z = zr[..., :hd]

``zr`` and ``q`` are f32, ``net`` f32 or bf16; the products are f32 and are
rounded once, to the dtype asked for. For CPU tensors the plain twins below
run instead of the kernel.
"""

from __future__ import annotations

import torch

from ..core import spans
from ..kernels import build


def gru_reset_reference(zr: torch.Tensor, net: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    hd = net.shape[-1]
    return (zr[..., hd:] * net.float()).to(out_dtype).contiguous()


def gru_update_reference(
    zr: torch.Tensor, q: torch.Tensor, net: torch.Tensor, out_dtypes: tuple[torch.dtype, ...]
) -> tuple[torch.Tensor, ...]:
    hd = net.shape[-1]
    z = zr[..., :hd]
    v = (1.0 - z) * net.float() + z * q
    return tuple(v.to(dt).contiguous() for dt in out_dtypes)


def _check(zr: torch.Tensor, net: torch.Tensor, q: torch.Tensor | None = None) -> None:
    hd = net.shape[-1]
    if zr.dtype != torch.float32 or zr.shape[:-1] != net.shape[:-1] or zr.shape[-1] != 2 * hd:
        raise ValueError("zr must be f32 with 2*hd channels over net's pixels")
    if net.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"net must be f32 or bf16, not {net.dtype}")
    tensors = [zr, net] + ([q] if q is not None else [])
    for t in tensors:
        if t.device != net.device or not t.is_contiguous():
            raise ValueError("GRU tensors must be contiguous on one device")
    if q is not None and (q.dtype != torch.float32 or q.shape != net.shape):
        raise ValueError("q must be f32 of net's shape")


def gru_reset(zr: torch.Tensor, net: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """r * net rounded to ``out_dtype`` (the next conv's operand type)."""
    if net.device.type == "cpu":
        return gru_reset_reference(zr, net, out_dtype)
    _check(zr, net)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rh dtype must be f32 or bf16, not {out_dtype}")
    hd = net.shape[-1]
    out = torch.empty(net.shape, dtype=out_dtype, device=net.device)
    lib = build.library()
    code = lib.zt_gru_reset(
        zr.data_ptr(), net.data_ptr(), out.data_ptr(), net.numel() // hd, hd,
        int(net.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        build.stream_handle(net.device),
    )
    build.check(code, "gru_reset")
    spans.COUNTS["gru"] += 1
    return out


def gru_update(
    zr: torch.Tensor, q: torch.Tensor, net: torch.Tensor, out_dtypes: tuple[torch.dtype, ...]
) -> tuple[torch.Tensor, ...]:
    """(1 - z) * net + z * q, once for each dtype in ``out_dtypes`` (f32
    and/or bf16, each at most once), in that order."""
    if net.device.type == "cpu":
        return gru_update_reference(zr, q, net, out_dtypes)
    _check(zr, net, q)
    if not out_dtypes or len(set(out_dtypes)) != len(out_dtypes) or not set(out_dtypes) <= {
        torch.float32, torch.bfloat16
    }:
        raise ValueError(f"out_dtypes must name f32 and/or bf16 once each: {out_dtypes}")
    hd = net.shape[-1]
    outs = {dt: torch.empty(net.shape, dtype=dt, device=net.device) for dt in out_dtypes}
    f32 = outs.get(torch.float32)
    b16 = outs.get(torch.bfloat16)
    lib = build.library()
    code = lib.zt_gru_update(
        zr.data_ptr(), q.data_ptr(), net.data_ptr(),
        f32.data_ptr() if f32 is not None else None,
        b16.data_ptr() if b16 is not None else None,
        net.numel() // hd, hd, int(net.dtype == torch.bfloat16),
        build.stream_handle(net.device),
    )
    build.check(code, "gru_update")
    spans.COUNTS["gru"] += 1
    return tuple(outs[dt] for dt in out_dtypes)
