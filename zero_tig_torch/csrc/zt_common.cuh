// Shared helpers of the zero_tig_torch kernels: element-type conversions.
//
// Every kernel takes its operands as float (the "highest" precision mode) or
// __nv_bfloat16 (the "fast" mode) and does its arithmetic in float. A bf16
// value widens to float exactly, so a product of two bf16 operands summed in
// float is the "bf16 operands, f32 accumulation" contract of the JAX fast
// mode.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

}  // namespace zt
