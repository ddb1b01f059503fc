// K2 (elementwise half): the gate arithmetic of the RAFT SepConvGRU.
//
// Together with the K1 convolutions (fused_conv.cu) this replaces the
// Pallas kernel zero_tig_tpu/models/raft/update_kernel.py::
// update_core_kernel (_kernel, _gru_dir). Per GRU direction the update core
// runs: zr = sigmoid(conv([net | x])) and q = tanh(conv([r*net | x])) as K1
// launches, and the two products below as launches of this file:
//   gru_reset:  rh   = r * net                   (stored as the conv operand)
//   gru_update: net' = (1 - z) * net + z * q     (f32, plus a bf16 copy)
// with z = zr[..., :hd] and r = zr[..., hd:]. Numerics follow the TPU
// kernel: gates, q and the blend in f32; rh and the carried net' rounded to
// bf16 only where the TPU kernel rounds them (fast mode).
//
// What bounds it on the H100: bytes. Each element is read and written once
// (a few MB per launch at the 45x80 RAFT grid); one thread per element with
// consecutive threads on consecutive addresses keeps every access
// coalesced. Fusing these products into the convolution epilogues, and the
// whole iteration into one persistent kernel, is later work (PERF.md).
#include <cstdint>

#include "zt_common.cuh"

namespace zt {

constexpr int kBlock = 256;

template <typename TN, typename TR>
__global__ void gru_reset_kernel(const float* __restrict__ zr, const TN* __restrict__ net,
                                 TR* __restrict__ rh, int64_t n, int hd) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n * hd) return;
  const int64_t p = i / hd;
  const int c = (int)(i - p * hd);
  const float r = zr[p * 2 * hd + hd + c];
  rh[i] = from_f<TR>(r * to_f(net[i]));
}

template <typename TN>
__global__ void gru_update_kernel(const float* __restrict__ zr, const float* __restrict__ q,
                                  const TN* __restrict__ net, float* __restrict__ out_f32,
                                  bf16* __restrict__ out_bf16, int64_t n, int hd) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n * hd) return;
  const int64_t p = i / hd;
  const int c = (int)(i - p * hd);
  const float z = zr[p * 2 * hd + c];
  const float v = (1.f - z) * to_f(net[i]) + z * q[i];
  if (out_f32) out_f32[i] = v;
  if (out_bf16) out_bf16[i] = __float2bfloat16(v);
}

inline dim3 grid_for(int64_t count) { return dim3((unsigned)((count + kBlock - 1) / kBlock)); }

}  // namespace zt

// rh = r * net. zr: (N, 2*hd) f32; net: (N, hd) bf16 if net_bf16 else f32;
// rh: (N, hd) bf16 if rh_bf16 else f32.
extern "C" int zt_gru_reset(const void* zr, const void* net, void* rh, int n, int hd,
                            int net_bf16, int rh_bf16, void* stream) {
  using namespace zt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t count = (int64_t)n * hd;
  const float* zrp = static_cast<const float*>(zr);
  if (net_bf16 && rh_bf16)
    gru_reset_kernel<bf16, bf16><<<grid_for(count), kBlock, 0, s>>>(
        zrp, static_cast<const bf16*>(net), static_cast<bf16*>(rh), n, hd);
  else if (net_bf16)
    gru_reset_kernel<bf16, float><<<grid_for(count), kBlock, 0, s>>>(
        zrp, static_cast<const bf16*>(net), static_cast<float*>(rh), n, hd);
  else if (rh_bf16)
    gru_reset_kernel<float, bf16><<<grid_for(count), kBlock, 0, s>>>(
        zrp, static_cast<const float*>(net), static_cast<bf16*>(rh), n, hd);
  else
    gru_reset_kernel<float, float><<<grid_for(count), kBlock, 0, s>>>(
        zrp, static_cast<const float*>(net), static_cast<float*>(rh), n, hd);
  return cudaGetLastError();
}

// net' = (1 - z) * net + z * q. zr: (N, 2*hd) f32; q: (N, hd) f32; net as in
// zt_gru_reset; out_f32 (f32) and out_bf16 (bf16) are each optional (null).
extern "C" int zt_gru_update(const void* zr, const void* q, const void* net, void* out_f32,
                             void* out_bf16, int n, int hd, int net_bf16, void* stream) {
  using namespace zt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t count = (int64_t)n * hd;
  const float* zrp = static_cast<const float*>(zr);
  const float* qp = static_cast<const float*>(q);
  float* of = static_cast<float*>(out_f32);
  bf16* ob = static_cast<bf16*>(out_bf16);
  if (net_bf16)
    gru_update_kernel<bf16><<<grid_for(count), kBlock, 0, s>>>(
        zrp, qp, static_cast<const bf16*>(net), of, ob, n, hd);
  else
    gru_update_kernel<float><<<grid_for(count), kBlock, 0, s>>>(
        zrp, qp, static_cast<const float*>(net), of, ob, n, hd);
  return cudaGetLastError();
}
