"""K1: fused stride-1 same convolution with an epilogue, on NHWC tensors.

Replaces the four Pallas call sites of ``zero_tig_tpu/ops/pack_conv.py``
(``conv3x3_packed``, ``conv3x3_packed_multi``, ``residual1x1_packed``,
``residual1x1_packed_multi``) and runs every convolution of the RAFT update
core (``zero_tig_tpu/models/raft/update_kernel.py::update_core_kernel``).
K1 is two kernels that compute the same function: ``csrc/fused_conv_mma.cu``
(bf16 tensor cores, implicit GEMM) takes every launch with bf16 operands,
``csrc/fused_conv.cu`` (f32 FMAs on the CUDA cores, implicit GEMM) every
launch with f32 operands, which must stay exact f32. ``k1_plan`` decides
which, and each kernel's tiles and grid; nothing falls back from one to the
other. The source notes say what bounds each on the
H100 and what its design does about that.

    out = act(conv(cat(inputs)) * scale + shift) [+ residual]
    out = clip(cat(anchor) - (conv(cat(inputs)) * scale + shift), lo, hi)

Operands are bf16 (fast mode) or f32 (highest mode); the sum and the
epilogue are f32; the output has the operand type unless ``out_dtype``
asks for f32. ``fused_conv`` launches the kernel for CUDA tensors and runs
``fused_conv_reference``, its plain PyTorch twin, for CPU tensors, and
counts each launch under its kernel in ``core/spans.py::COUNTS``:
``fused_conv`` (bf16) or ``fused_conv_f32``.
"""

from __future__ import annotations

import functools
import math
import struct
import time
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..core import spans
from ..kernels import build

ACTS = {"none": 0, "relu": 1, "leaky": 2, "sigmoid": 3, "tanh": 4, "sigmoid_clip": 5}
BN_EPS = 1e-5
SM_COUNT = 132  # H100 SXM
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may take
K1_STAGES = 3  # chunk buffers of the tensor-core kernel's cp.async ring
# tile shapes of csrc/fused_conv_mma.cu by index (dispatch_tile): image rows
# (x 16 columns) and output channels of one block, and how many blocks of the
# shape an SM's registers admit (the kernel's __launch_bounds__)
K1_TILES = ((8, 64), (8, 8), (4, 64), (4, 32), (4, 8))
K1_TILE_BLOCKS = (2, 5, 2, 2, 8)
K1_STAGE_BYTES = 36 * 1024  # a chunk of a streamed conv: 3 stages x 2 blocks fill an SM's shared memory
# the FMA kernel (csrc/fused_conv.cu): a thread's 8 pixels x 8 output
# channels, tiles of F32_COLS columns, at most F32_THREADS threads a block
F32_COLS = 16
F32_THREADS = 256
F32_STAGES = 2  # chunk buffers of its cp.async double buffer (csrc/fused_conv.cu::kStages)
F32_MIN_THREADS = 128  # the grid rule's smallest block, 4 warps (_fma_plan)
# a launch's record as csrc/fused_conv.cuh::Slot lays it out, in 8-byte slots:
# 28 addresses and integers, lo and hi, and the integers of the kernel's
# plan: 10 for the tensor-core kernel (Slot), 10 for the FMA kernel (FmaSlot)
_FMA_RECORD = struct.Struct("28q2d10q")
_MMA_RECORD = struct.Struct("28q2d10q")


class ConvWeights(NamedTuple):
    """A convolution prepared for K1.

    w: (kh, kw, Cin, Cout) in the operand dtype, contiguous;
    scale, shift: (Cout,) f32 -- the bias, or a folded eval BatchNorm;
    wp: what the kernel reads: for bf16 operands ``pack_weights(w)``, for
    f32 operands ``pack_weights_f32(w)`` (``launch_k1`` packs at the launch
    when it is None).
    """

    w: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    wp: torch.Tensor | None = None

    @property
    def padding(self) -> tuple[int, int]:
        return (self.w.shape[0] - 1) // 2, (self.w.shape[1] - 1) // 2


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, Cin, Cout) -> (kh*kw, CinP, CoutP), contiguous: Cin padded to
    a multiple of 16 (the depth of one mma) and Cout to a multiple of 8 (the
    width of one), zeros in the padding. A view of ``w`` where nothing pads."""
    kh, kw, cin, cout = w.shape
    wp = w.reshape(kh * kw, cin, cout)
    if cin % 16 or cout % 8:
        wp = F.pad(wp, (0, -cout % 8, 0, -cin % 16))
    return wp.contiguous()


def pack_weights_f32(w: torch.Tensor) -> torch.Tensor:
    """(kh, kw, Cin, Cout) -> (kh*kw, Cin, CoutP), contiguous: Cout padded to
    a multiple of 4 with zeros, so that the FMA kernel stages every weight
    row as whole 16-byte words. A view of ``w`` where nothing pads."""
    kh, kw, cin, cout = w.shape
    wp = w.reshape(kh * kw, cin, cout)
    if cout % 4:
        wp = F.pad(wp, (0, -cout % 4))
    return wp.contiguous()


def unpack_weights(wp: torch.Tensor, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """The inverse of ``pack_weights`` and of ``pack_weights_f32``."""
    return wp[:, :cin, :cout].reshape(kh, kw, cin, cout).contiguous()


def conv_weights(w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> ConvWeights:
    """K1's operands from (kh, kw, Cin, Cout) weights, packed once here for
    the kernel their dtype takes."""
    w = w.contiguous()
    wp = pack_weights(w) if w.dtype == torch.bfloat16 else pack_weights_f32(w)
    return ConvWeights(w, scale.contiguous(), shift.contiguous(), wp)


class K1Plan(NamedTuple):
    """Which kernel a K1 launch takes and how it is tiled.

    kernel: "mma" (csrc/fused_conv_mma.cu) or "fma" (csrc/fused_conv.cu).
    Both: the input channels per staged chunk, the elements per copy of each
    input part, the padded widths of the weights the kernel reads, the grid
    and the shared memory of a block. "mma": the index into ``K1_TILES``;
    its grid is (blocks that walk over the spatial tiles, batch x channel
    tiles). "fma": the tile rows (of ``F32_COLS`` columns), the channel
    groups (8 output channels each), the k-groups that split each chunk's
    channels and the blocks of ``F32_THREADS`` threads an SM must hold (1, or 2, which caps the kernel at 128 registers a thread);
    its grid is (spatial tiles, batch x channel tiles); ``grid_rule``: the
    tiling is the one ``_fma_plan``'s grid rule chose (``launch_k1`` counts
    such launches).
    """

    kernel: str
    tile: int = -1
    kc: int = 0
    vec: tuple[int, ...] = ()
    cin_p: int = 0
    cout_p: int = 0
    grid: tuple[int, int] = (0, 0)
    smem: int = 0
    rows: int = 0
    cg: int = 0
    kg: int = 0
    resident: int = 0
    grid_rule: bool = False

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    @property
    def threads(self) -> int:
        """Threads of one block of the FMA kernel."""
        return 2 * self.rows * self.cg * self.kg


def _mma_smem(tile: int, kh: int, kw: int, kc: int, cin_p: int) -> int:
    """Shared memory of one block, as csrc/fused_conv_mma.cu::launch_mma
    computes it: the staged chunks, or the output tile where that is larger."""
    rows, bn = K1_TILES[tile]
    b_stride = bn * 2 + (16 if (bn // 8) % 2 == 0 else 0)
    a_bytes = (rows + kh - 1) * (16 + kw - 1) * (kc * 2 + 16)
    out_bytes = 4 * 16 * (bn * 4 + 32)  # the epilogue's f32 tile, 4 rows a round
    nchunks = math.ceil(cin_p / kc)
    if nchunks == 1:
        a_bytes = max(a_bytes, out_bytes)
    npix = (rows + kh - 1) * (16 + kw - 1)
    return max(min(K1_STAGES, nchunks) * (a_bytes + kh * kw * kc * b_stride), out_bytes) + 2 * bn * 4 + npix * 4


def _fma_smem(rows: int, cg: int, kg: int, kc: int, kh: int, kw: int, cin: int) -> int:
    """Shared memory of one block of the FMA kernel, as
    csrc/fused_conv.cu::geometry computes it: the staged chunks (input halo
    tile, pixel stride an odd number of 16-byte words, and the weight slab),
    or the k-groups' partial sums or the output tile (rows of 8 * cg + 4
    floats) where one of those is larger, then an int per halo pixel."""
    npix = (rows + kh - 1) * (F32_COLS + kw - 1)
    ps = kc + 4 if (kc // 4) % 2 == 0 else kc
    stage = npix * ps + kh * kw * kc * 8 * cg
    partials = (kg - 1) * 2 * rows * cg * 64
    tile = rows * F32_COLS * (8 * cg + 4)
    return 4 * (max(min(F32_STAGES, math.ceil(cin / kc)) * stage, partials, tile) + npix)


def _copy_widths(parts: tuple[int, ...], aligns: tuple[int, ...] | None, widest: int, esz: int) -> tuple[int, ...]:
    """Elements per copy of each input part: the widest unit (``widest``
    elements of ``esz`` bytes, halved down to one) that divides the part's
    channels and its offset in the concat and that its pointer is aligned
    to."""
    vec, off = [], 0
    for j, c in enumerate(parts):
        v = math.gcd(widest, c, off) if off else math.gcd(widest, c)
        if aligns is not None:
            v = min(v, max(1, math.gcd(16, aligns[j]) // esz))
        vec.append(v)
        off += c
    return tuple(vec)


def fma_plan(kh: int, kw: int, parts: tuple[int, ...], h: int, w: int, cout: int, batch: int,
             aligns: tuple[int, ...] | None, *, rows: int, cg: int, kg: int, kc: int,
             resident: int = 1) -> K1Plan:
    """The FMA kernel's plan with the given tiling (what ``k1_plan`` picks,
    or one that ``compare_k1.py --sweep`` times against it); raises where
    the kernel cannot take it."""
    cin = sum(parts)
    threads = 2 * rows * cg * kg
    smem = _fma_smem(rows, cg, kg, kc, kh, kw, cin)
    if (kw not in (1, 3, 5) or not 1 <= cg <= 8 or kc % 4 or not 1 <= kg <= kc // 4 or threads > F32_THREADS
            or resident not in (1, 2) or (resident == 2 and kw == 5)):
        raise ValueError(f"K1's f32 kernel cannot take a {kh}x{kw} conv with rows={rows} cg={cg} kg={kg} "
                         f"kc={kc} resident={resident}")
    if smem * resident > SMEM_LIMIT:
        raise ValueError(f"K1: a {kh}x{kw} f32 conv needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    return K1Plan("fma", kc=kc, vec=_copy_widths(parts, aligns, 4, 4), cin_p=cin, cout_p=cout + -cout % 4,
                  grid=(math.ceil(h / rows) * math.ceil(w / F32_COLS), batch * math.ceil(cout / (8 * cg))),
                  smem=smem, rows=rows, cg=cg, kg=kg, resident=resident)


def _fma_plan(kh: int, kw: int, parts: tuple[int, ...], h: int, w: int, cout: int, batch: int,
              aligns: tuple[int, ...] | None) -> K1Plan:
    """The FMA kernel's tiling, as measured on the H100 (compare_k1.py
    --sweep). Where 8-row x 64-channel tiles number 8 or more for every SM
    (the 1080p layers): 16-row tiles of all of Cout, chunks of all of Cin
    up to 16, else of 8; two resident blocks where the tile is 64 channels
    wide, one otherwise; a head of 8 channels or fewer takes them in one
    channel group over 2 k-groups. Otherwise (the RAFT grids, and 1x5 taps,
    which need every register), the grid rule: 8-row tiles and one resident
    block; a head of 8 channels or fewer over 8 k-groups; else tiles of 64,
    32 or 16 channels, whichever leaves the fewest SMs idle in the last wave
    of blocks (the wider on a tie) among those whose blocks hold
    ``F32_MIN_THREADS`` or more, and k-groups, a power of two, until the
    blocks hold about 32K threads (256 for each SM); chunks of 16 channels a
    k-group (at most 64), halved until every block of the launch can be
    resident at once, or at least one. The floor keeps a layer off blocks of
    one or two warps, which stage the whole input tile for 16 or 32 output
    channels: at Sintel's 55x128 the last-wave rule alone took one-warp
    blocks of 16 channels (7 waves, the last 0.97 full) over 4-warp blocks
    of 64 (2 waves, 0.85), which run 1.2-1.6x faster."""
    if kw not in (1, 3, 5):
        raise ValueError(f"K1's f32 kernel takes 1, 3 or 5 taps along a row, not {kh}x{kw}")
    cin = sum(parts)
    cin_r = cin + -cin % 4
    cout_p = cout + -cout % 4
    plan = functools.partial(fma_plan, kh, kw, parts, h, w, cout, batch, aligns)
    tiles = math.ceil(h / 8) * math.ceil(w / F32_COLS) * batch
    if tiles * math.ceil(cout_p / 64) >= 8 * SM_COUNT and kw != 5:
        cg = min(8, math.ceil(cout_p / 8))
        if cg == 1:
            return plan(rows=16, cg=1, kg=min(2, cin_r // 4), kc=min(8, cin_r), resident=2)
        return plan(rows=16, cg=cg, kg=1, kc=cin_r if cin <= 16 else 8, resident=2 if cg == 8 else 1)
    if cout_p <= 8:
        cg, kg = 1, 8
    else:
        def waves_filled(cg: int) -> float:  # the share of the last wave of blocks that has a block
            blocks = tiles * math.ceil(cout / (8 * cg))
            return blocks / (SM_COUNT * math.ceil(blocks / SM_COUNT))

        def k_groups(cg: int) -> int:
            kg = 2 ** max(0, round(math.log2(32 * 1024 / (tiles * math.ceil(cout / (8 * cg)) * 16 * cg))))
            return min(kg, F32_THREADS // (16 * cg))

        # 64-channel blocks always hold 4 warps
        cg = max((c for c in (8, 4, 2) if 16 * c * k_groups(c) >= F32_MIN_THREADS),
                 key=lambda c: (round(waves_filled(c), 2), c))
        kg = k_groups(cg)
    # as deep as lets every block of the launch be resident at once
    per_sm = math.ceil(tiles * math.ceil(cout / (8 * cg)) / SM_COUNT)
    kc = min(64, 16 * kg)
    while kc > 4 and _fma_smem(8, cg, kg, kc, kh, kw, cin) * (per_sm if kc > 4 * kg else 1) > SMEM_LIMIT:
        kc //= 2
    return plan(rows=8, cg=cg, kg=min(kg, kc // 4), kc=kc)._replace(grid_rule=True)


@functools.lru_cache(maxsize=512)
def k1_plan(
    dtype: torch.dtype,
    kh: int,
    kw: int,
    parts: tuple[int, ...],
    h: int,
    w: int,
    cout: int,
    batch: int = 1,
    aligns: tuple[int, ...] | None = None,
) -> K1Plan:
    """Plan one K1 launch from what the launch can observe: the operand
    dtype, the taps, the channels of each input part, the image size and
    Cout. ``aligns``: the byte alignment of each part's pointer (16 or more
    when None, as every whole tensor has).

    f32 operands take the FMA kernel, tiled by ``_fma_plan``. bf16 operands
    take the tensor-core kernel: 8-row tiles when those alone fill the card twice over, else
    4-row tiles (the 45x80 RAFT grid has only 60 of them), and there 32
    output channels per block instead of 64 when 64 would leave SMs without
    a block; 8 output channels for the 2-6 channel heads. A part is copied
    in the widest units (8, 4, 2 or 1 elements) that divide its channels and
    its offset in the concat and that its pointer is aligned to. Up to 64
    input channels are one chunk: the whole weight slab is staged once and
    a block walks over as many tiles as it takes to fill the card with
    resident blocks and no more. A deeper conv streams chunks of 64/32/16
    channels through a ring of 3 stages of at most 36 KB each, so that two
    blocks share an SM, one block a tile."""
    if dtype == torch.float32:
        return _fma_plan(kh, kw, parts, h, w, cout, batch, aligns)
    if dtype != torch.bfloat16:
        raise ValueError(f"K1 operands must be f32 or bf16, not {dtype}")
    cin = sum(parts)
    cin_p, cout_p = cin + -cin % 16, cout + -cout % 8
    tiles8 = math.ceil(h / 8) * math.ceil(w / 16)
    tiles4 = math.ceil(h / 4) * math.ceil(w / 16)
    n64 = batch * math.ceil(cout_p / 64)
    if cout_p == 8:
        tile = 1 if tiles8 * batch >= 2 * SM_COUNT else 4
    elif tiles8 * n64 >= 2 * SM_COUNT:
        tile = 0
    else:
        tile = 2 if tiles4 * n64 >= SM_COUNT else 3
    rows, bn = K1_TILES[tile]
    vec = _copy_widths(parts, aligns, 8, 2)
    tiles = tiles8 if rows == 8 else tiles4
    grid_y = batch * math.ceil(cout_p / bn)
    if cin_p <= 64:
        kc = cin_p
        smem = _mma_smem(tile, kh, kw, kc, cin_p)
        resident = max(1, min(K1_TILE_BLOCKS[tile], (SMEM_LIMIT + 1024) // (smem + 1024))) * SM_COUNT
        grid_x = min(tiles, max(1, resident // grid_y))
    else:
        kc = next((k for k in (64, 32) if _mma_smem(tile, kh, kw, k, cin_p) <= K1_STAGES * K1_STAGE_BYTES), 16)
        smem = _mma_smem(tile, kh, kw, kc, cin_p)
        grid_x = tiles
    if smem > SMEM_LIMIT:
        raise ValueError(f"K1: a {kh}x{kw} conv needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    return K1Plan("mma", tile, kc, vec, cin_p, cout_p, (grid_x, grid_y), smem)


def prepare_conv(
    conv: torch.nn.Conv2d,
    dtype: torch.dtype,
    *,
    bn: torch.nn.BatchNorm2d | None = None,
    out_scale: float = 1.0,
) -> ConvWeights:
    """Turn an OIHW ``nn.Conv2d`` (and an eval BatchNorm after it) into K1's
    operands. ``out_scale`` multiplies the whole affine output (the RAFT
    mask head's 0.25)."""
    w = conv.weight.detach().float()
    cout = w.shape[0]
    bias = conv.bias.detach().float() if conv.bias is not None else w.new_zeros(cout)
    scale = torch.ones_like(bias)
    shift = bias
    if bn is not None:
        # eval BN folded as in zero_tig_tpu/models/fastpath.py:150-162
        inv = torch.rsqrt(bn.running_var.float() + BN_EPS)
        scale = bn.weight.detach().float() * inv
        shift = bn.bias.detach().float() + (bias - bn.running_mean.float()) * scale
    return conv_weights(w.permute(2, 3, 1, 0).to(dtype), scale * out_scale, shift * out_scale)


def fused_conv_reference(
    inputs: Sequence[torch.Tensor],
    cw: ConvWeights,
    *,
    act: str = "none",
    residual: torch.Tensor | None = None,
    anchor: Sequence[torch.Tensor] = (),
    lo: float = 1e-4,
    hi: float = 1.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: operands as given, an f32 epilogue
    and one cast of the result. On the card the convolution sums in f32, as
    the kernel does; on the CPU it sums in f64 and rounds once to f32.

    The CPU's f64 sum is there so that one set of values gives one set of
    bits on every call. An f32 convolution on the CPU goes through oneDNN,
    which picks its kernel and blocking per call, so the order of its sums
    and with it the last bit may change between calls. An f64 convolution
    takes PyTorch's own im2col and GEMM path instead. A product of two bf16
    operands has at most 16 significant bits, so it is exact in f64, and a
    sum of such products is exact in any order unless its terms span more
    than about 2^30 (f64's 53 bits, less the products' 16 and the bits of
    the count): any order then gives the same f64 value and the same f32
    rounding. Where a sum is not exact, as with f32 operands, two orders
    differ by ~2^-29 of an f32 ulp, which shows after the rounding only for
    a value that close to a rounding boundary."""
    cpu = inputs[0].device.type == "cpu"
    acc_dtype = torch.float64 if cpu else torch.float32
    x = torch.cat([t.to(acc_dtype) for t in inputs], dim=-1).permute(0, 3, 1, 2)
    w = cw.w.to(acc_dtype).permute(3, 2, 0, 1)
    acc = F.conv2d(x, w, padding=cw.padding).permute(0, 2, 3, 1).float()
    v = acc * cw.scale + cw.shift
    if act == "relu":
        v = torch.relu(v)
    elif act == "leaky":
        v = torch.where(v >= 0, v, 0.2 * v)
    elif act == "sigmoid":
        v = torch.sigmoid(v)
    elif act == "tanh":
        v = torch.tanh(v)
    elif act == "sigmoid_clip":
        v = torch.clamp(torch.sigmoid(v), 1e-4, 1.0)
    if residual is not None:
        v = v + residual.float()
    if anchor:
        v = torch.clamp(torch.cat([a.float() for a in anchor], -1) - v, lo, hi)
    return v.to(out_dtype or inputs[0].dtype).contiguous()


def fused_conv(
    inputs: Sequence[torch.Tensor],
    cw: ConvWeights,
    *,
    act: str = "none",
    residual: torch.Tensor | None = None,
    anchor: Sequence[torch.Tensor] = (),
    lo: float = 1e-4,
    hi: float = 1.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K1 on (B, H, W, C_j) inputs whose channels concatenate to the conv's
    Cin. ``residual`` (B, H, W, Cout) is added after the activation;
    ``anchor`` (up to 2 parts, channels summing to Cout) switches to the
    ``clip(anchor - conv, lo, hi)`` epilogue."""
    if inputs[0].device.type == "cpu":
        return fused_conv_reference(
            inputs, cw, act=act, residual=residual, anchor=anchor,
            lo=lo, hi=hi, out_dtype=out_dtype,
        )
    out = launch_k1(inputs, cw, act=act, residual=residual, anchor=anchor, lo=lo, hi=hi, out_dtype=out_dtype)
    spans.COUNTS["fused_conv_f32" if inputs[0].dtype == torch.float32 else "fused_conv"] += 1
    return out


def launch_k1(
    inputs: Sequence[torch.Tensor],
    cw: ConvWeights,
    *,
    act: str = "none",
    residual: torch.Tensor | None = None,
    anchor: Sequence[torch.Tensor] = (),
    lo: float = 1e-4,
    hi: float = 1.0,
    out_dtype: torch.dtype | None = None,
    plan: K1Plan | None = None,
) -> torch.Tensor:
    """Check the operands and launch K1 once on CUDA tensors, on the kernel
    and tile ``k1_plan`` names, or on ``plan`` where one is given (an
    ``fma_plan`` that ``compare_k1.py --sweep`` times); raises on what it
    cannot take, and no launch gives way to the other kernel or to the twin. The wrappers
    ``fused_conv`` and ``conv3x3_bf16`` call it and count the launch under
    their own names. A frame makes over a hundred of these calls, so the
    checks read each tensor's attributes once. While a profiler records,
    the call counts in the session counters ``k1.launches`` and
    ``k1.host_ns`` (``core/spans.py``); an f32 launch that ``_fma_plan``'s
    grid rule tiled also counts in ``COUNTS["fused_conv_f32_grid"]``."""
    t0 = time.perf_counter_ns() if spans.on() else 0
    x0 = inputs[0]
    dtype, dev = x0.dtype, x0.device
    kh, kw, cin, cout = cw.w.shape
    b, h, w, _ = x0.shape
    nin, nanc = len(inputs), len(anchor)
    if not 1 <= nin <= 4 or nanc > 2:
        raise ValueError(f"K1 takes 1-4 inputs and 0-2 anchor parts, got {nin}, {nanc}")
    if dtype not in (torch.float32, torch.bfloat16) or cw.w.dtype != dtype:
        raise ValueError(f"K1 operands must be f32 or bf16 and match the weights: {dtype}, {cw.w.dtype}")
    if act not in ACTS or (nanc and (act != "none" or residual is not None)):
        raise ValueError(f"unsupported epilogue act={act!r} anchor={bool(nanc)}")
    out_dtype = out_dtype or dtype
    if out_dtype not in (dtype, torch.float32):
        raise ValueError(f"K1 writes the operand dtype or f32, not {out_dtype}")

    def operand(t: torch.Tensor) -> tuple[int, int]:
        """(address, channels) of a contiguous (b, h, w, C) tensor like x0."""
        s = t.shape
        if (len(s) != 4 or s[0] != b or s[1] != h or s[2] != w or t.dtype != dtype
                or t.device != dev or not t.is_contiguous()):
            raise ValueError("K1 tensors must be contiguous NHWC of one device, dtype and shape")
        return t.data_ptr(), s[3]

    ptrs, parts = zip(*[operand(t) for t in inputs])
    if sum(parts) != cin:
        raise ValueError(f"inputs carry {list(parts)} channels, weights take {cin}")
    res_ptr = 0
    if residual is not None:
        res_ptr, res_c = operand(residual)
        if res_c != cout or res_ptr % 16:
            raise ValueError("residual must have Cout channels and start on a 16-byte boundary")
    anc, anc_c = zip(*[operand(a) for a in anchor]) if nanc else ((), ())
    if nanc and sum(anc_c) != cout:
        raise ValueError("anchor parts must carry Cout channels")
    for t in (cw.w, cw.scale, cw.shift):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K1 weights must be contiguous on the inputs' device")

    # every whole tensor starts on 16 bytes or more; only a view may not
    aligns = None if not any(p % 16 for p in ptrs) else tuple(min(16, p & -p) for p in ptrs)
    plan = plan or k1_plan(dtype, kh, kw, parts, h, w, cout, b, aligns)
    wts = cw.wp if cw.wp is not None else (pack_weights if plan.kernel == "mma" else pack_weights_f32)(cw.w)
    if (wts.shape != (kh * kw, plan.cin_p, plan.cout_p) or wts.dtype != dtype or wts.device != dev
            or not wts.is_contiguous() or wts.data_ptr() % 16):
        raise ValueError(f"K1 packed weights {tuple(wts.shape)} do not fit {tuple(cw.w.shape)}")
    lib = build.library()
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=dev)
    zeros = (0,) * 4
    record = (
        *ptrs, *zeros[nin:], *parts, *zeros[nin:], nin,
        wts.data_ptr(), cw.scale.data_ptr(), cw.shift.data_ptr(), res_ptr,
        *anc, *zeros[2 + nanc:], *anc_c, *zeros[2 + nanc:], nanc,
        out.data_ptr(), b, h, w, cout, kh, kw, (kh - 1) // 2, (kw - 1) // 2, ACTS[act], lo, hi,
    )
    stream = build.stream_handle(dev)
    if plan.kernel == "mma":
        code = lib.zt_fused_conv_mma(
            _MMA_RECORD.pack(
                *record, out_dtype == torch.float32, plan.tile, plan.grid[0], plan.kc,
                *plan.vec, *(1,) * (4 - nin), plan.cin_p, plan.cout_p,
            ),
            stream,
        )
    else:
        code = lib.zt_fused_conv(
            _FMA_RECORD.pack(
                *record, plan.rows, plan.cg, plan.kg, plan.kc, *plan.vec, *(1,) * (4 - nin), plan.cout_p, plan.resident,
            ),
            stream,
        )
    build.check(code, f"fused_conv ({plan.kernel})")
    if plan.grid_rule:
        spans.COUNTS["fused_conv_f32_grid"] += 1
    if t0:
        spans.count_k1(time.perf_counter_ns() - t0)
    return out
