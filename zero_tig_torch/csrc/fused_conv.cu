// K1: fused stride-1 "same" convolution on NHWC tensors with an epilogue.
//
// Replaces the Pallas kernels of zero_tig_tpu/ops/pack_conv.py:
//   conv3x3_packed (_kernel), conv3x3_packed_multi (_kernel_multi),
//   residual1x1_packed (_res1x1_kernel) and residual1x1_packed_multi
//   (_res1x1_multi_kernel),
// and runs every convolution inside the RAFT update core that
// zero_tig_tpu/models/raft/update_kernel.py::update_core_kernel fused on the
// TPU (1x1, 3x3, 1x5 and 5x1 taps).
//
// What it computes, for output pixel p and output channel o:
//   acc   = sum_{tap, c} x[p + tap - pad, c] * w[tap, c, o]   (zero outside)
//   v     = acc * scale[o] + shift[o]            (bias, or folded eval BN)
//   v     = act(v)        none | relu | leaky 0.2 | sigmoid | tanh |
//                         sigmoid clipped to [1e-4, 1]
//   v    += res[p, o]     (optional residual)
//   or, in anchor mode:  v = clip(anchor[p, o] - v, lo, hi)
// where x is the channel concatenation of up to 4 input tensors and the
// anchor the concatenation of up to 2 parts. Neither concatenation is ever
// written to memory: the tile loader picks each channel from its tensor.
//
// This file is K1 for f32 operands (the "highest" precision mode): every
// product and sum is an f32 FMA on the CUDA cores, because TF32 tensor-core
// products would break that mode's f32 parity with the reference. bf16
// operands (the "fast" mode) never come here: fused_conv_mma.cu computes the
// same function for them on the bf16 tensor cores, and ops/fused_conv.py
// (k1_plan) sends each launch to one of the two by its operand type alone.
//
// What bounds it on the H100: the f32 FMA rate (67 TFLOP/s peak) and
// shared-memory loads. Its design keeps that cost down: a block stages an
// 8x32-pixel input tile (with halo) and the weights of 8 input channels at
// a time in shared memory, each thread keeps 2 pixels
// x COB output channels of f32 sums in registers, weights are read as
// broadcast float4 loads (one load feeds 8 FMAs), and the input tile is laid
// out channel-major with a row stride of 16 mod 32 words so that the two
// image rows a warp reads fall on disjoint banks.
#include <cstdint>

#include "fused_conv.cuh"

namespace zt {

constexpr int kTH = 8;         // output rows per block
constexpr int kTX = 16;        // threads along a row
constexpr int kPX = 2;         // pixels per thread, kTX apart
constexpr int kTW = kTX * kPX; // output columns per block
constexpr int kCIB = 8;        // input channels staged per step
constexpr int kThreads = kTH * kTX;

__host__ __device__ inline int row_stride(int cols) {
  // smallest stride >= cols with stride % 32 == 16: rows ty and ty+1 of a
  // warp then land on disjoint shared-memory banks
  return cols + ((16 - cols % 32) + 32) % 32;
}

template <typename T>
__device__ __forceinline__ float fetch_in(const ConvArgs<T>& a, size_t pix, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < a.nin) {
      if (c < a.cin_part[j]) return to_f(a.in[j][pix * a.cin_part[j] + c]);
      c -= a.cin_part[j];
    }
  }
  return 0.f;
}

template <typename T, typename TO, int COB>
__global__ void __launch_bounds__(kThreads) fused_conv_kernel(const ConvArgs<T> a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cols = kTW + a.kw - 1;
  const int rows = kTH + a.kh - 1;
  const int rs = row_stride(cols);
  const int np = rows * rs;
  float* sx = smem;              // [kCIB][rows][rs]
  float* sw = smem + kCIB * np;  // [kh*kw][kCIB][COB]

  const int ncob = (a.Cout + COB - 1) / COB;
  const int b = blockIdx.z / ncob;
  const int co0 = (blockIdx.z % ncob) * COB;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int ty = tid / kTX;
  const int tx = tid % kTX;
  const int ntap = a.kh * a.kw;

  float acc[kPX][COB];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int o = 0; o < COB; ++o) acc[p][o] = 0.f;

  for (int c0 = 0; c0 < a.Cin; c0 += kCIB) {
    const int nc = min(kCIB, a.Cin - c0);
    // input tile with halo, channel fastest in the loop (coalesced reads of
    // NHWC), channel-major in shared memory (conflict-free compute reads)
    for (int i = tid; i < rows * cols * kCIB; i += kThreads) {
      const int ci = i % kCIB;
      const int p = i / kCIB;
      const int r = p / cols;
      const int c = p - r * cols;
      const int gy = y0 + r - a.ph;
      const int gx = x0 + c - a.pw;
      float v = 0.f;
      if (ci < nc && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
        v = fetch_in(a, ((size_t)b * a.H + gy) * a.W + gx, c0 + ci);
      sx[ci * np + r * rs + c] = v;
    }
    for (int i = tid; i < ntap * kCIB * COB; i += kThreads) {
      const int o = i % COB;
      const int rest = i / COB;
      const int ci = rest % kCIB;
      const int tap = rest / kCIB;
      float v = 0.f;
      if (ci < nc && co0 + o < a.Cout)
        v = to_f(a.w[((size_t)tap * a.Cin + c0 + ci) * a.Cout + co0 + o]);
      sw[i] = v;
    }
    __syncthreads();

    for (int ky = 0; ky < a.kh; ++ky) {
      for (int kx = 0; kx < a.kw; ++kx) {
        const float* xr = sx + (ty + ky) * rs + tx + kx;
        const float* wr = sw + (ky * a.kw + kx) * kCIB * COB;
        for (int ci = 0; ci < nc; ++ci) {
          float xv[kPX];
#pragma unroll
          for (int p = 0; p < kPX; ++p) xv[p] = xr[ci * np + p * kTX];
          const float4* w4 = reinterpret_cast<const float4*>(wr + ci * COB);
#pragma unroll
          for (int q = 0; q < COB / 4; ++q) {
            const float4 wv = w4[q];
#pragma unroll
            for (int p = 0; p < kPX; ++p) {
              acc[p][4 * q + 0] = fmaf(xv[p], wv.x, acc[p][4 * q + 0]);
              acc[p][4 * q + 1] = fmaf(xv[p], wv.y, acc[p][4 * q + 1]);
              acc[p][4 * q + 2] = fmaf(xv[p], wv.z, acc[p][4 * q + 2]);
              acc[p][4 * q + 3] = fmaf(xv[p], wv.w, acc[p][4 * q + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  TO* out = reinterpret_cast<TO*>(a.out);
  const int y = y0 + ty;
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int x = x0 + tx + p * kTX;
    if (y >= a.H || x >= a.W) continue;
    const size_t pix = ((size_t)b * a.H + y) * a.W + x;
#pragma unroll
    for (int o = 0; o < COB; ++o) {
      const int oc = co0 + o;
      if (oc >= a.Cout) continue;
      out[pix * a.Cout + oc] = from_f<TO>(epilogue(a, acc[p][o], a.scale[oc], a.shift[oc], pix, oc));
    }
  }
}

template <typename T, typename TO, int COB>
cudaError_t launch(const ConvArgs<T>& a, cudaStream_t stream) {
  const int cols = kTW + a.kw - 1;
  const int rows = kTH + a.kh - 1;
  const size_t smem =
      (size_t)(kCIB * rows * row_stride(cols) + a.kh * a.kw * kCIB * COB) * sizeof(float);
  auto kernel = fused_conv_kernel<T, TO, COB>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int ncob = (a.Cout + COB - 1) / COB;
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, a.B * ncob);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t dispatch_cob(const ConvArgs<T>& a, cudaStream_t stream) {
  // output channels per thread: 8 for the 2-6 channel heads, 16 where it
  // divides the width (48), else 32 -- unless the image has too few pixel
  // tiles to fill the card's 132 SMs with 32-channel blocks (the 45x80
  // RAFT update grid: 18 tiles), where 8 channels per thread gives 4x the
  // blocks
  const long tiles = (long)((a.W + kTW - 1) / kTW) * ((a.H + kTH - 1) / kTH) * a.B;
  if (a.Cout <= 8 || tiles * ((a.Cout + 31) / 32) < 4 * 132) return launch<T, TO, 8>(a, stream);
  if (a.Cout <= 16 || a.Cout % 32 == 16) return launch<T, TO, 16>(a, stream);
  return launch<T, TO, 32>(a, stream);
}

}  // namespace zt

// C entry point, bound with ctypes: the launch record of fused_conv.cuh
// (kCommonSlots slots; every address a device pointer of a contiguous f32
// tensor) and the stream. Returns cudaGetLastError() after the launch.
extern "C" int zt_fused_conv(const long long* record, void* stream) {
  using namespace zt;
  return dispatch_cob<float, float>(make_args<float>(record), static_cast<cudaStream_t>(stream));
}
