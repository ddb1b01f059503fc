// K3: per-(image, channel) uint8 histogram equalisation, bit-exact with
// torchvision.transforms.functional.equalize.
//
// Replaces the Pallas kernel zero_tig_tpu/ops/pallas_equalize.py::
// equalize_uint8_pallas (_equalize_kernel), which computes exactly
// zero_tig_tpu/ops/equalize.py::equalize_uint8.
//
//   hist  = 256-bin histogram of the channel
//   last  = the highest non-empty bin
//   step  = (N - hist[last]) / 255                      (integer division)
//   lut[0] = 0, lut[i] = min((cum[i-1] + step/2) / step, 255) for i >= 1
//   out   = lut[x], or x unchanged where step == 0
//
// The TPU kernel kept a whole channel in VMEM and walked it in order. Here
// the blocks of one image run in parallel, so the work splits in two
// launches:
//   pass 1 (eq_hist_kernel): each block histograms a contiguous slice of the
//     interleaved NHWC bytes into shared memory with shared atomics, then
//     adds its counts into a (B*C, 256) int32 buffer with global atomics;
//   pass 2 (eq_apply_kernel): each block rebuilds the C LUTs of its image
//     from those counts in shared memory, in integers, and maps its slice.
// What bounds it on the H100: bytes (the image is read twice and written
// once, 0.7 MB at 360x640x3) and, at that size, launch latency. Contiguous
// byte slices keep the reads coalesced; integer LUT arithmetic makes the
// result exact, so no float division can round across a floor.
#include <cstdint>

#include "zt_common.cuh"

namespace zt {

constexpr int kEqThreads = 256;

__global__ void eq_hist_kernel(const uint8_t* __restrict__ img, int* __restrict__ hist,
                               int64_t per_image, int C, int64_t per_block) {
  extern __shared__ int sh[];  // [C][256]
  for (int i = threadIdx.x; i < C * 256; i += kEqThreads) sh[i] = 0;
  __syncthreads();
  const int b = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * per_block;
  const int64_t end = start + per_block < per_image ? start + per_block : per_image;
  const uint8_t* src = img + (int64_t)b * per_image;
  for (int64_t i = start + threadIdx.x; i < end; i += kEqThreads)
    atomicAdd(&sh[(int)(i % C) * 256 + src[i]], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < C * 256; i += kEqThreads)
    if (sh[i]) atomicAdd(&hist[(int64_t)b * C * 256 + i], sh[i]);
}

__global__ void eq_apply_kernel(const uint8_t* __restrict__ img, const int* __restrict__ hist,
                                uint8_t* __restrict__ out, int64_t per_image, int C,
                                int64_t per_block) {
  extern __shared__ int lut[];  // [C][256]
  const int b = blockIdx.y;
  const int n = (int)(per_image / C);  // pixels per channel
  for (int c = threadIdx.x; c < C; c += kEqThreads) {
    const int* h = hist + ((int64_t)b * C + c) * 256;
    int* l = lut + c * 256;
    int last = 255;
    while (last > 0 && h[last] == 0) --last;
    const int step = (n - h[last]) / 255;
    if (step == 0) {
      for (int v = 0; v < 256; ++v) l[v] = v;
    } else {
      int cum = 0;
      l[0] = 0;
      for (int v = 0; v < 255; ++v) {
        cum += h[v];
        l[v + 1] = min((cum + step / 2) / step, 255);
      }
    }
  }
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * per_block;
  const int64_t end = start + per_block < per_image ? start + per_block : per_image;
  const uint8_t* src = img + (int64_t)b * per_image;
  uint8_t* dst = out + (int64_t)b * per_image;
  for (int64_t i = start + threadIdx.x; i < end; i += kEqThreads)
    dst[i] = (uint8_t)lut[(int)(i % C) * 256 + src[i]];
}

}  // namespace zt

// img, out: (B, H, W, C) uint8 contiguous; hist: (B*C*256) int32 scratch,
// zeroed here on the stream. Returns cudaGetLastError() after both launches.
extern "C" int zt_equalize_u8(const void* img, void* out, void* hist, int B, int HW, int C,
                              void* stream) {
  using namespace zt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)B * C * 256, s);
  if (e != cudaSuccess) return e;
  const int64_t per_image = (int64_t)HW * C;
  const int64_t per_block = 16384;  // bytes per block: ~45 blocks per 1/3-1080p image
  const dim3 grid((unsigned)((per_image + per_block - 1) / per_block), (unsigned)B);
  const size_t smem = sizeof(int) * 256 * (size_t)C;
  eq_hist_kernel<<<grid, kEqThreads, smem, s>>>(static_cast<const uint8_t*>(img),
                                                static_cast<int*>(hist), per_image, C, per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  eq_apply_kernel<<<grid, kEqThreads, smem, s>>>(static_cast<const uint8_t*>(img),
                                                 static_cast<const int*>(hist),
                                                 static_cast<uint8_t*>(out), per_image, C,
                                                 per_block);
  return cudaGetLastError();
}
