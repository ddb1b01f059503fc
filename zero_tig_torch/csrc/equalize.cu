// K3: per-(image, channel) histogram equalisation, bit-exact with
// torchvision.transforms.functional.equalize, in one cooperative launch.
//
// Replaces the Pallas kernel zero_tig_tpu/ops/pallas_equalize.py::
// equalize_uint8_pallas (_equalize_kernel), which computes exactly
// zero_tig_tpu/ops/equalize.py::equalize_uint8, and also takes the casts of
// zero_tig_tpu/ops/equalize.py::equalize01 around it:
//
//   u8    = x for uint8 input, else trunc(clamp(x * 255, 0, 255)) with the
//           product rounded in x's dtype (f32, or bf16 in fast mode)
//   hist  = 256-bin histogram of the channel
//   last  = the highest non-empty bin
//   step  = (N - hist[last]) / 255                      (integer division)
//   lut[0] = 0, lut[i] = min((cum[i-1] + step/2) / step, 255) for i >= 1
//   out   = lut[u8], or u8 unchanged where step == 0; uint8, or f32 for
//           equalize01
//
// The TPU kernel kept a whole channel in VMEM and walked it in order. Here
// the blocks of one image run in parallel and meet at grid barriers, so the
// launch is cooperative (every block resident at once):
//   1. each block zeroes its share of the (B*C, 256) int32 counts; each
//      thread loads 48-element groups (16 pixels x 3 channels, so the
//      channel of an element is its position mod 3, known at compile time)
//      with 16-byte loads, casts them to bytes, keeps them in registers and
//      counts them into its warp's own copy of the C x 256 histogram in
//      shared memory (a low-light frame fills ~64 bins, where one
//      block-wide copy would serialise its atomics);
//   2. grid barrier; each block adds its copies into the global counts with
//      atomics, skipping empty bins; grid barrier;
//   3. each block builds its image's C LUTs from the global counts, 256 bins
//      in parallel: an exclusive prefix sum with warp shuffles, the last
//      non-empty bin by a max-reduce, integers throughout, so the result is
//      exact;
//   4. each thread maps the bytes still in its registers and stores them
//      with 16-byte stores.
// The image is read from device memory once and written once. Groups past
// what the registers hold, pixels past the last whole group, channel counts
// other than 3 and buffers that are not 16-byte aligned take a scalar path
// that reads its elements again in step 4.
//
// What bounds it on the H100: at 360x640x3 (0.7 MB in, 0.7 or 2.8 MB out)
// not the bytes but the latency of one launch, two grid barriers and the
// dependent loads between them; one launch replaces three device operations
// (memset, histogram, apply) and, for equalize01, the ATen casts around them.
#include <cooperative_groups.h>

#include <cstdint>

#include "zt_common.cuh"

namespace cg = cooperative_groups;

namespace zt {

constexpr int kEqThreads = 128;
constexpr int kEqWarps = kEqThreads / 32;
constexpr int kGroup = 48;           // elements of a group: 16 pixels x 3 channels
constexpr int kWords = kGroup / 4;   // a group's bytes as 32-bit words
constexpr int kHeld = 2;             // groups a thread keeps in registers across the barriers
constexpr int kCopyBytes = 48 * 1024;  // shared memory for the per-warp histogram copies

__device__ __forceinline__ uint32_t to_u8(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t to_u8(float v) {
  const float p = fminf(fmaxf(__fmul_rn(v, 255.f), 0.f), 255.f);
  return (uint32_t)p;  // truncates toward zero, as a cast to uint8
}
__device__ __forceinline__ uint32_t to_u8(bf16 v) {
  // the product is rounded to bf16 before the clamp, as ATen's bf16 multiply
  const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(v), 255.f)));
  return (uint32_t)fminf(fmaxf(p, 0.f), 255.f);
}
__device__ __forceinline__ uint32_t bf16_bits_to_u8(uint32_t bits) {
  return to_u8(__ushort_as_bfloat16((unsigned short)bits));
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

// one group of 48 elements at p -> its 48 bytes in w
__device__ __forceinline__ void load_group(const uint8_t* p, bool vec, uint32_t (&w)[kWords]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = pack4(p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]);
  }
}
__device__ __forceinline__ void load_group(const float* p, bool vec, uint32_t (&w)[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const float4 v = vec ? reinterpret_cast<const float4*>(p)[k]
                         : make_float4(p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]);
    w[k] = pack4(to_u8(v.x), to_u8(v.y), to_u8(v.z), to_u8(v.w));
  }
}
__device__ __forceinline__ void load_group(const bf16* p, bool vec, uint32_t (&w)[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords / 2; ++k) {  // 8 bf16 per 16 bytes
    uint4 v;
    if (vec) {
      v = reinterpret_cast<const uint4*>(p)[k];
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p) + 8 * k;
      v = make_uint4(q[0] | (q[1] << 16), q[2] | (q[3] << 16), q[4] | (q[5] << 16), q[6] | (q[7] << 16));
    }
    w[2 * k] = pack4(bf16_bits_to_u8(v.x), bf16_bits_to_u8(v.x >> 16), bf16_bits_to_u8(v.y),
                     bf16_bits_to_u8(v.y >> 16));
    w[2 * k + 1] = pack4(bf16_bits_to_u8(v.z), bf16_bits_to_u8(v.z >> 16), bf16_bits_to_u8(v.w),
                         bf16_bits_to_u8(v.w >> 16));
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[kWords], int j) {
  return (w[j >> 2] >> ((j & 3) * 8)) & 0xffu;
}

__device__ __forceinline__ void count_group(const uint32_t (&w)[kWords], int* h) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) atomicAdd(&h[(j % 3) * 256 + byte_of(w, j)], 1);
}

// element j of a group through its channel's LUT (lut: [3][256])
__device__ __forceinline__ uint32_t mapped(const uint32_t (&w)[kWords], const int* lut, int j) {
  return (uint32_t)lut[(j % 3) * 256 + byte_of(w, j)];
}

// the group's bytes through the LUTs to p
__device__ __forceinline__ void store_group(const uint32_t (&w)[kWords], const int* lut, uint8_t* p,
                                            bool vec) {
  uint32_t o[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    o[k] = pack4(mapped(w, lut, 4 * k), mapped(w, lut, 4 * k + 1), mapped(w, lut, 4 * k + 2),
                 mapped(w, lut, 4 * k + 3));
  if (vec) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      reinterpret_cast<uint4*>(p)[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) p[j] = (uint8_t)mapped(w, lut, j);
  }
}
__device__ __forceinline__ void store_group(const uint32_t (&w)[kWords], const int* lut, float* p, bool vec) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const float4 v = make_float4((float)mapped(w, lut, 4 * k), (float)mapped(w, lut, 4 * k + 1),
                                 (float)mapped(w, lut, 4 * k + 2), (float)mapped(w, lut, 4 * k + 3));
    if (vec) {
      reinterpret_cast<float4*>(p)[k] = v;
    } else {
      p[4 * k] = v.x, p[4 * k + 1] = v.y, p[4 * k + 2] = v.z, p[4 * k + 3] = v.w;
    }
  }
}

// grid (blocks per image, B), kEqThreads threads; dynamic shared memory:
// `copies` histograms of [C][256] ints, later the C LUTs. ws: B*C*256 ints
// of scratch, zeroed here. gpi: whole groups per image (C == 3), else 0.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kEqThreads)
    equalize_kernel(const TI* __restrict__ in, TO* __restrict__ out, int* __restrict__ ws, int hw, int C,
                    int gpi, int copies, int vec) {
  extern __shared__ int sh[];
  __shared__ int s_sum[kEqWarps], s_max[kEqWarps];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, C256 = C * 256;
  const int64_t per_image = (int64_t)hw * C;
  const TI* src = in + (int64_t)b * per_image;
  TO* dst = out + (int64_t)b * per_image;
  const int gtid = blockIdx.x * kEqThreads + tid, gstride = gridDim.x * kEqThreads;

  // 1. zero this block's share of the global counts; count into shared copies
  const int nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  for (int i = bid * kEqThreads + tid; i < (int)gridDim.y * C256; i += nblocks * kEqThreads) ws[i] = 0;
  for (int i = tid; i < copies * C256; i += kEqThreads) sh[i] = 0;
  __syncthreads();
  int* mine = sh + (warp % copies) * C256;
  uint32_t held[kHeld][kWords];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int g = gtid + k * gstride;
    if (g < gpi) {
      load_group(src + (int64_t)g * kGroup, vec, held[k]);
      count_group(held[k], mine);
    }
  }
  for (int g = gtid + kHeld * gstride; g < gpi; g += gstride) {
    uint32_t w[kWords];
    load_group(src + (int64_t)g * kGroup, vec, w);
    count_group(w, mine);
  }
  const int64_t tail = (int64_t)gpi * kGroup;
  for (int64_t e = tail + gtid; e < per_image; e += gstride)
    atomicAdd(&mine[(int)(e % C) * 256 + to_u8(src[e])], 1);
  grid.sync();  // every block's share of ws is zero

  // 2. the block's counts into the global ones
  int* gh = ws + (int64_t)b * C256;
  for (int i = tid; i < C256; i += kEqThreads) {
    int s = 0;
    for (int k = 0; k < copies; ++k) s += sh[k * C256 + i];
    if (s) atomicAdd(&gh[i], s);
  }
  grid.sync();  // every image's counts are complete

  // 3. the C LUTs of this image into sh[c * 256 + i]; thread t takes bins 2t, 2t + 1
  for (int c = 0; c < C; ++c) {
    const int i0 = 2 * tid, i1 = i0 + 1;
    const int h0 = __ldcg(gh + c * 256 + i0), h1 = __ldcg(gh + c * 256 + i1);
    int incl = h0 + h1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int top = __reduce_max_sync(0xffffffffu, h1 ? i1 : (h0 ? i0 : -1));
    if (lane == 31) s_sum[warp] = incl;
    if (lane == 0) s_max[warp] = top;
    __syncthreads();
    int before = 0, last = -1;
#pragma unroll
    for (int k = 0; k < kEqWarps; ++k) {
      before += k < warp ? s_sum[k] : 0;
      last = max(last, s_max[k]);
    }
    const int cum0 = before + incl - h0 - h1;  // count of the bins below i0
    const int step = (hw - __ldcg(gh + c * 256 + last)) / 255;
    int* lut = sh + c * 256;
    if (step == 0) {
      lut[i0] = i0, lut[i1] = i1;
    } else {
      lut[i0] = i0 == 0 ? 0 : min((cum0 + step / 2) / step, 255);
      lut[i1] = min((cum0 + h0 + step / 2) / step, 255);
    }
    __syncthreads();  // s_sum and s_max are read again for the next channel
  }

  // 4. map: the held groups from registers, the rest read again
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int g = gtid + k * gstride;
    if (g < gpi) store_group(held[k], sh, dst + (int64_t)g * kGroup, vec);
  }
  for (int g = gtid + kHeld * gstride; g < gpi; g += gstride) {
    uint32_t w[kWords];
    load_group(src + (int64_t)g * kGroup, vec, w);
    store_group(w, sh, dst + (int64_t)g * kGroup, vec);
  }
  for (int64_t e = tail + gtid; e < per_image; e += gstride)
    dst[e] = (TO)sh[(int)(e % C) * 256 + to_u8(src[e])];
}

template <typename TI, typename TO>
cudaError_t launch_equalize(const void* in, void* out, void* ws, int B, int hw, int C, cudaStream_t s) {
  int copies = max(1, min(kEqWarps, kCopyBytes / (C * 256 * (int)sizeof(int))));
  const size_t smem = sizeof(int) * 256 * (size_t)C * copies;
  const void* kern = reinterpret_cast<const void*>(&equalize_kernel<TI, TO>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, equalize_kernel<TI, TO>, kEqThreads, smem);
  if (e != cudaSuccess) return e;
  // a cooperative launch needs every block resident: at most per_sm * sms
  const int cap = per_sm * sms / B;
  if (cap < 1) return cudaErrorCooperativeLaunchTooLarge;
  int gpi = C == 3 ? hw / 16 : 0;
  const int64_t scalar = (int64_t)hw * C - (int64_t)gpi * kGroup;
  const int64_t items = gpi > scalar ? gpi : scalar;
  const int want = (int)((items + kEqThreads - 1) / kEqThreads);
  const dim3 grid((unsigned)max(1, min(cap, want)), (unsigned)B);
  // 16-byte loads and stores where every group starts on a 16-byte boundary
  int vec = (B == 1 || hw % 16 == 0) && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const TI* in_p = static_cast<const TI*>(in);
  TO* out_p = static_cast<TO*>(out);
  int* ws_p = static_cast<int*>(ws);
  void* args[] = {&in_p, &out_p, &ws_p, &hw, &C, &gpi, &copies, &vec};
  e = cudaLaunchCooperativeKernel(kern, grid, dim3(kEqThreads), args, smem, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace zt

// in, out: (B, H, W, C) contiguous, hw = H * W. kind 0: uint8 -> uint8
// (equalize_u8); 1: f32 -> f32 and 2: bf16 -> f32 (equalize01). ws: B*C*256
// int32 scratch, zeroed by the kernel. Returns the launch's error code.
extern "C" int zt_equalize(const void* in, void* out, void* ws, int B, int hw, int C, int kind, void* stream) {
  using namespace zt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch_equalize<uint8_t, uint8_t>(in, out, ws, B, hw, C, s);
    case 1: return launch_equalize<float, float>(in, out, ws, B, hw, C, s);
    case 2: return launch_equalize<bf16, float>(in, out, ws, B, hw, C, s);
    default: return cudaErrorInvalidValue;
  }
}
