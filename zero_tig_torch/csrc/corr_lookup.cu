// RAFT's correlation lookup: a bilinear gather of a (2r+1)^2 window per
// query pixel and pyramid level.
//
// It replaces the hat-weight lookup of zero_tig_tpu/models/raft/corr.py::
// lookup_corr (no Pallas kernel there: XLA's two batched matmuls against
// hat-weight matrices, a layout for the TPU's matrix unit). That form reads
// every level whole for every query, about 264 MB a lookup at a 55x128
// grid, plus the hat weights it builds each time. The lookup needs far
// less: the 9 offsets of a level are integers, so one query and level share
// one pair of fractional weights (fx, fy) and read only the (2r+2)^2 patch
// at the floor of the centre, about 11-18 MB a lookup at 55x128.
//
// For query q = (b, y, x) and level i (the level holds q's correlations
// with the second image pooled i times, (H/2^i, W/2^i)), with c = (x, y) /
// 2^i read from coords:
//   out[q, i*(2r+1)^2 + a*(2r+1) + b] = bilinear(level_i[q], c + (a - r, b - r))
// with align_corners semantics and zeros outside the level; a level of side 0
// reads as zeros. The window transpose is the reference's: channel a*(2r+1)+b
// samples (x + a - r, y + b - r). Level-major, (B, h, w, levels*(2r+1)^2).
//
// What bounds it on the H100: latency and bytes, no arithmetic to speak of
// and no tensor cores. One block per query, one thread per output channel
// (32 x ceil(C/32) threads): the threads of a warp store consecutive
// channels of one query, so each 324-channel row is written coalesced;
// each thread reads its four corners straight from device memory (the L1
// cache serves the neighbours' shared corners), with no shared-memory
// staging. Levels are read as stored (f32 or bf16), sums are f32, and the
// output is rounded once to the consumer's dtype. No atomics: two launches
// give the same bits. The radius is a template parameter (1-4) so the
// channel decomposition is multiplies and shifts.
#include <cstdint>

#include "zt_common.cuh"

namespace zt {

constexpr int kCorrMaxLevels = 4;
constexpr int kCorrMaxThreads = 352;  // 4 levels x 81 channels, in whole warps

struct CorrLevels {
  const void* ptr[kCorrMaxLevels];  // (queries, h, w) each, contiguous
  int h[kCorrMaxLevels];
  int w[kCorrMaxLevels];
};

// a[i] by selects: an index into a kernel parameter's array that is known
// only at run time would copy the parameter to the stack
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kCorrMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

template <int R, typename TL, typename TO>
__global__ void __launch_bounds__(kCorrMaxThreads)
corr_lookup_kernel(const float* __restrict__ coords, CorrLevels lv, int levels, TO* __restrict__ out) {
  constexpr int N = 2 * R + 1;
  constexpr int NN = N * N;
  const int channels = levels * NN;
  const int ch = threadIdx.y * 32 + threadIdx.x;
  if (ch >= channels) return;
  const int64_t q = blockIdx.x;
  const int li = ch / NN;
  const int k = ch - li * NN;
  const int a = k / N;  // x offset index
  const int b = k - a * N;  // y offset index
  const int h = pick(lv.h, li), w = pick(lv.w, li);
  float v = 0.f;
  if (h > 0 && w > 0) {
    const float scale = 1.f / (float)(1 << li);  // a power of two: exact
    const float cx = __ldg(coords + 2 * q) * scale;
    const float cy = __ldg(coords + 2 * q + 1) * scale;
    const float x0 = floorf(cx), y0 = floorf(cy);
    const float fx = cx - x0, fy = cy - y0;  // exact
    // clamped before the conversion, so a far-off centre reads nothing
    const int x = (int)fminf(fmaxf(x0, -(float)(R + 2)), (float)(w + R + 1)) + a - R;
    const int y = (int)fminf(fmaxf(y0, -(float)(R + 2)), (float)(h + R + 1)) + b - R;
    const TL* base = static_cast<const TL*>(pick(lv.ptr, li)) + q * (int64_t)h * w;
    const bool x_in = x >= 0 && x < w, x1_in = x + 1 >= 0 && x + 1 < w;
    const bool y_in = y >= 0 && y < h, y1_in = y + 1 >= 0 && y + 1 < h;
    const int64_t at = (int64_t)y * w + x;  // offset of the top-left corner
    const float v00 = (y_in && x_in) ? to_f(base[at]) : 0.f;
    const float v01 = (y_in && x1_in) ? to_f(base[at + 1]) : 0.f;
    const float v10 = (y1_in && x_in) ? to_f(base[at + w]) : 0.f;
    const float v11 = (y1_in && x1_in) ? to_f(base[at + w + 1]) : 0.f;
    // along x first, then y: the order of the hat-weight form's two products
    const float top = (1.f - fx) * v00 + fx * v01;
    const float bot = (1.f - fx) * v10 + fx * v11;
    v = (1.f - fy) * top + fy * bot;
  }
  out[q * channels + ch] = from_f<TO>(v);
}

template <int R, typename TL, typename TO>
void launch_corr(const float* coords, const CorrLevels& lv, int levels, int queries, void* out, cudaStream_t s) {
  const int channels = levels * (2 * R + 1) * (2 * R + 1);
  const dim3 block(32, (channels + 31) / 32);
  corr_lookup_kernel<R, TL, TO><<<queries, block, 0, s>>>(coords, lv, levels, static_cast<TO*>(out));
}

template <int R>
void launch_corr_typed(const float* coords, const CorrLevels& lv, int levels, int queries, int level_bf16,
                       int out_bf16, void* out, cudaStream_t s) {
  if (level_bf16 && out_bf16)
    launch_corr<R, bf16, bf16>(coords, lv, levels, queries, out, s);
  else if (level_bf16)
    launch_corr<R, bf16, float>(coords, lv, levels, queries, out, s);
  else if (out_bf16)
    launch_corr<R, float, bf16>(coords, lv, levels, queries, out, s);
  else
    launch_corr<R, float, float>(coords, lv, levels, queries, out, s);
}

}  // namespace zt

// out (queries, levels*(2r+1)^2) = the windows of coords (queries, 2) f32
// (pixel x, y at level 0) on levels l0..l{levels-1}, each (queries, h_i, w_i)
// contiguous, bf16 if level_bf16 else f32 (the unused pointers may be null);
// out bf16 if out_bf16 else f32. radius 1-4, levels 1-4.
extern "C" int zt_corr_lookup(const void* coords, const void* l0, const void* l1, const void* l2, const void* l3,
                              int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3, int levels,
                              int radius, int queries, int level_bf16, int out_bf16, void* out, void* stream) {
  using namespace zt;
  if (levels < 1 || levels > kCorrMaxLevels || radius < 1 || radius > 4 || queries < 0)
    return (int)cudaErrorInvalidValue;
  if (queries == 0) return (int)cudaSuccess;
  const CorrLevels lv{{l0, l1, l2, l3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: launch_corr_typed<1>(c, lv, levels, queries, level_bf16, out_bf16, out, s); break;
    case 2: launch_corr_typed<2>(c, lv, levels, queries, level_bf16, out_bf16, out, s); break;
    case 3: launch_corr_typed<3>(c, lv, levels, queries, level_bf16, out_bf16, out, s); break;
    default: launch_corr_typed<4>(c, lv, levels, queries, level_bf16, out_bf16, out, s); break;
  }
  return cudaGetLastError();
}
