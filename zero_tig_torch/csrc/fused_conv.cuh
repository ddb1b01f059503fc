// What the two K1 kernels share: the launch arguments, the activation and
// the anchor concat of the epilogue.
//
// K1 has two kernels that compute the same function (see fused_conv.cu for
// what that is): fused_conv_mma.cu on the bf16 tensor cores for bf16
// operands (fast mode), fused_conv.cu with f32 FMAs for f32 operands
// (highest mode, which must stay exact f32).
#pragma once

#include "zt_common.cuh"

namespace zt {

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kSigmoid = 3, kTanh = 4, kSigmoidClip = 5 };

template <typename T>
struct ConvArgs {
  const T* in[4];
  int cin_part[4];
  int nin;
  const T* w;  // (kh, kw, Cin, Cout); the tensor-core kernel: (kh*kw, CinP, CoutP)
  const float* scale;
  const float* shift;
  const T* res;  // (B, H, W, Cout) or null
  const T* anc[2];
  int anc_part[2];
  int nanc;
  void* out;
  int B, H, W, Cin, Cout, kh, kw, ph, pw, act;
  float lo, hi;
};

template <typename T>
__device__ __forceinline__ float fetch_anchor(const ConvArgs<T>& a, size_t pix, int c) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < a.nanc) {
      if (c < a.anc_part[j]) return to_f(a.anc[j][pix * a.anc_part[j] + c]);
      c -= a.anc_part[j];
    }
  }
  return 0.f;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kLeaky: return v >= 0.f ? v : 0.2f * v;
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    case kSigmoidClip: return fminf(fmaxf(1.f / (1.f + expf(-v)), 1e-4f), 1.f);
    default: return v;
  }
}

// acc -> the value K1 stores at (pix, oc): affine, activation, residual, or
// the clip(anchor - v) epilogue
template <typename T>
__device__ __forceinline__ float epilogue(const ConvArgs<T>& a, float acc, float scale, float shift,
                                          size_t pix, int oc) {
  float v = activate(acc * scale + shift, a.act);
  if (a.res) v += to_f(a.res[pix * a.Cout + oc]);
  if (a.nanc) v = fminf(fmaxf(fetch_anchor(a, pix, oc) - v, a.lo), a.hi);
  return v;
}

// K1's launch record, as ops/fused_conv.py::launch_k1 packs it: 8-byte
// slots, so that the host hands over one pointer instead of forty arguments.
// Addresses and integers are 64-bit integers, lo and hi doubles.
enum Slot {
  kIn0 = 0, kCin0 = 4, kNin = 8, kW, kScale, kShift, kRes, kAnc0, kAnc1, kAc0, kAc1, kNanc, kOut,
  kB, kH, kWidth, kCout, kKh, kKw, kPh, kPw, kAct, kLo, kHi,
  kCommonSlots,  // the tensor-core kernel's plan follows
  kOutF32 = kCommonSlots, kTile, kGridX, kKc, kVec0, kCinP = kVec0 + 4, kCoutP, kMmaSlots
};

template <typename T>
ConvArgs<T> make_args(const long long* s) {
  auto ptr = [&](int i) { return reinterpret_cast<const T*>(s[i]); };
  auto num = [&](int i) { return static_cast<int>(s[i]); };
  auto real = [&](int i) { return static_cast<float>(reinterpret_cast<const double*>(s)[i]); };
  ConvArgs<T> a;
  a.nin = num(kNin);
  a.Cin = 0;
  for (int j = 0; j < 4; ++j) {
    a.in[j] = ptr(kIn0 + j);
    a.cin_part[j] = j < a.nin ? num(kCin0 + j) : 0;
    a.Cin += a.cin_part[j];
  }
  a.w = ptr(kW);
  a.scale = reinterpret_cast<const float*>(s[kScale]);
  a.shift = reinterpret_cast<const float*>(s[kShift]);
  a.res = ptr(kRes);
  a.anc[0] = ptr(kAnc0);
  a.anc[1] = ptr(kAnc1);
  a.anc_part[0] = num(kAc0);
  a.anc_part[1] = num(kAc1);
  a.nanc = num(kNanc);
  a.out = reinterpret_cast<void*>(s[kOut]);
  a.B = num(kB); a.H = num(kH); a.W = num(kWidth); a.Cout = num(kCout);
  a.kh = num(kKh); a.kw = num(kKw); a.ph = num(kPh); a.pw = num(kPw); a.act = num(kAct);
  a.lo = real(kLo); a.hi = real(kHi);
  return a;
}

}  // namespace zt
