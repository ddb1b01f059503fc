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
// written to memory: each input part is copied into the staged tile at its
// own offset in the concat.
//
// This file is K1 for f32 operands (the "highest" precision mode). Every
// product and every sum is an f32 FMA on the CUDA cores: no TF32 and no
// split into TF32 terms, because highest mode's contract is f32 arithmetic.
// bf16 operands (the "fast" mode) never come here: fused_conv_mma.cu
// computes the same function for them on the bf16 tensor cores, and
// ops/fused_conv.py::k1_plan sends each launch to one of the two by its
// operand type alone, and picks this kernel's tiles and grid.
//
// What bounds it on the H100: the f32 FMA rate, 67 TFLOP/s on the 132 SMs
// (128 FMAs a clock per SM), for the RAFT layers (0.3-3.5 GFLOP
// on 0.5-4 MB at 45x80) and the wide 1080p layers; bytes at 3.35 TB/s for
// the 1080p layers with 3-channel inputs or outputs. At the RAFT grids, too
// few pixel tiles to fill the card as well. The design, an implicit GEMM
// (M = output pixels of a tile, N = output channels, K = taps x Cin) on the
// CUDA cores:
//  - register blocking: a thread keeps 8 pixels along a row x 8 output
//    channels, 64 f32 accumulators. Its input row (8 + kw - 1 pixels, 4
//    channels each) is read as 16-byte loads once per (tap row, 4 channels)
//    and reused across the kw taps in registers, a sliding window; its 8
//    weights of a (tap, channel) are two 16-byte loads. A 3x3 conv does 768
//    FMAs per 34 such loads (22 per load), a 1x1 conv 256 per 16.
//  - the lanes of a quarter warp hold consecutive channel groups of one
//    pixel group: their input loads are one broadcast and their weight loads
//    read consecutive 16-byte words (a thread's 8 channels are two groups of
//    4, half the block's channels apart).
//  - staging: the input tile with its halo (tile rows + kh - 1 rows of 16 +
//    kw - 1 columns) for a chunk of kc input channels, pixel-major with a
//    pixel stride of an odd number of 16-byte words, and the chunk's weight
//    slab [tap][kc][block channels], go to shared memory with cp.async into
//    two buffers, so that the copies of the next chunk run under the FMAs of
//    this one (a third buffer measured no faster). cp.async zero-fills pixels outside
//    the image and weight rows and columns past Cin and Cout.
//  - each input part is copied at its own offset in the concat in the widest
//    unit (16, 8 or 4 bytes) that its channels, its offset and its pointer
//    allow (k1_plan's vec): no per-element walk over the parts.
//  - at the RAFT grids (30 tiles of 8 x 16 at 45x80) a block splits each
//    chunk's channels over k-groups of threads, and k1_plan narrows the
//    block's channels where that fills the last wave of blocks better. The
//    k-groups' partial sums are added in shared memory in a fixed order
//    (group 0, then 1, 2, ...), so two launches on the same inputs give the
//    same bits: nothing is atomic.
//  - the weights arrive prepared once as [tap][Cin][CoutP], Cout padded to
//    4 (ops/fused_conv.py::pack_weights_f32), so every weight row is whole
//    16-byte words.
// Where it stands (PERF.md): a 3x3 layer at 1080p reaches about half the
// f32 peak with the SM clock at its maximum. Taking the loop's shared-memory
// loads out of it did not make it faster: the FFMA stream itself sets the
// pace, and in it most FFMAs read two registers of one bank, which the
// register allocator decides.
#include <cstdint>

#include "fused_conv.cuh"

namespace zt {

constexpr int kPX = 8;   // output pixels of a thread, consecutive along a row
constexpr int kCO = 8;   // output channels of a thread: two groups of 4
constexpr int kTC = 16;  // tile columns: two pixel groups
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStages = 2;  // chunk buffers: one computed, one being copied

struct FmaPlan {
  int tr;      // tile rows
  int cg;      // channel groups: 8 * cg output channels per block
  int kg;      // k-groups: slices of each chunk's channels
  int kc;      // input channels per staged chunk, a multiple of 4
  int vec[4];  // elements per copy of each input part: 4, 2 or 1
  int CoutP;   // Cout of the prepared weights, a multiple of 4
  int resident;  // blocks of kMaxThreads threads an SM must hold: 1 or 2
};

// floats between two staged pixels: kc rounded so that it is an odd number
// of 16-byte words, which puts 8 consecutive pixels on disjoint banks
__host__ __device__ inline int px_stride(int kc) { return (kc / 4) % 2 == 0 ? kc + 4 : kc; }

// Shared memory of one block, in floats, as ops/fused_conv.py::_fma_smem
// counts it: the two chunk buffers, or the k-groups' partial sums or the
// output tile where one of those is larger, then the halo pixels' indices.
struct Geometry {
  int cols, npix, ps, x_floats, stage_floats, region;
};
__host__ __device__ inline Geometry geometry(const FmaPlan& p, int Cin, int kh, int kw) {
  Geometry g;
  g.cols = kTC + kw - 1;
  g.npix = (p.tr + kh - 1) * g.cols;
  g.ps = px_stride(p.kc);
  g.x_floats = g.npix * g.ps;
  g.stage_floats = g.x_floats + kh * kw * p.kc * 8 * p.cg;
  const int nchunks = (Cin + p.kc - 1) / p.kc;
  const int staged = (nchunks < kStages ? nchunks : kStages) * g.stage_floats;
  const int partials = (p.kg - 1) * 2 * p.tr * p.cg * kCO * kPX;
  const int tile = p.tr * kTC * (8 * p.cg + 4);
  g.region = staged > partials ? staged : partials;
  if (tile > g.region) g.region = tile;
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// one asynchronous copy of BYTES (16, 8 or 4) to shared memory; src_bytes 0
// fills the destination with zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  const size_t g = __cvta_generic_to_global(src);
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(g), "r"(src_bytes));
  } else if (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(g), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(g), "r"(src_bytes));
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Block: a tile of tr rows x 16 columns of image b, 8 * cg output channels
// from n0. Threads: kg k-groups of 2 * tr * cg threads; within a group a
// thread's index is (pixel group, channel group), channel group fastest.
// RESIDENT: the blocks of 256 threads an SM must hold. 1 lets the compiler
// use about 170 registers a thread; 2 caps it at 128, which the 64-channel
// 1080p layers run faster with (k1_plan's choice).
template <int KW, int RESIDENT>
__global__ void __launch_bounds__(kMaxThreads, RESIDENT) fused_conv_kernel(const ConvArgs<float> a, const FmaPlan p) {
  extern __shared__ __align__(16) float smem[];
  const int kh = a.kh;
  const int taps = kh * KW;
  const Geometry g = geometry(p, a.Cin, kh, KW);
  const int bn = 8 * p.cg, half = 4 * p.cg;
  const int group = 2 * p.tr * p.cg;
  const int nth = group * p.kg;
  const int nchunks = (a.Cin + p.kc - 1) / p.kc;
  const int tiles_x = (a.W + kTC - 1) / kTC;
  const int ntile_n = (a.Cout + bn - 1) / bn;
  const int b = blockIdx.y / ntile_n;
  const int n0 = (blockIdx.y - b * ntile_n) * bn;
  const int y0 = (blockIdx.x / tiles_x) * p.tr;
  const int x0 = (blockIdx.x % tiles_x) * kTC;
  int* s_pix = reinterpret_cast<int*>(smem + g.region);

  const int tid = threadIdx.x;
  const int kgi = tid / group;
  const int rem = tid - kgi * group;
  const int pg = rem / p.cg;
  const int cg = rem - pg * p.cg;
  const int pr = pg >> 1;          // tile row of the thread's pixels
  const int pc = (pg & 1) * kPX;   // their first tile column

  // where each halo pixel lies in the image, once: the copies of every chunk
  // read it instead of dividing and comparing again
  for (int i = tid; i < g.npix; i += nth) {
    const int r = i / g.cols, c = i - r * g.cols;
    const int gy = y0 + r - a.ph, gx = x0 + c - a.pw;
    s_pix[i] = gy < 0 || gy >= a.H || gx < 0 || gx >= a.W ? -1 : (b * a.H + gy) * a.W + gx;
  }
  __syncthreads();

  // stage chunk `chunk`: its input channels (each part at its offset in the
  // concat, zeros past Cin) and its weight slab
  auto load_chunk = [&](int chunk) {
    float* sx = smem + (chunk % kStages) * g.stage_floats;
    float* sw = sx + g.x_floats;
    const int c0 = chunk * p.kc;
    int off = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < a.nin) {
        const int cj = a.cin_part[j];
        const int lo = max(c0, off), hi = min(c0 + p.kc, off + cj);
        if (lo < hi) {
          const int v = p.vec[j];
          const int units = (hi - lo) / v;
          const float* base = a.in[j] + (lo - off);
          const int n = g.npix * units;
#pragma unroll 1
          for (int i = tid; i < n; i += nth) {
            const int px = i / units, u = i - px * units;
            const int gp = s_pix[px];
            const float* src = gp < 0 ? a.in[j] : base + (size_t)gp * cj + u * v;
            const uint32_t dst = smem_u32(sx + px * g.ps + (lo - c0) + u * v);
            const int bytes = gp < 0 ? 0 : 4 * v;
            if (v == 4) cp_async<16>(dst, src, bytes);
            else if (v == 2) cp_async<8>(dst, src, bytes);
            else cp_async<4>(dst, src, bytes);
          }
        }
        off += cj;
      }
    }
    if (c0 + p.kc > a.Cin) {  // the chunk's channels past Cin: zeros
      const int lo = max(a.Cin - c0, 0), wz = p.kc - lo;
      for (int i = tid; i < g.npix * wz; i += nth) {
        const int px = i / wz;
        sx[px * g.ps + lo + (i - px * wz)] = 0.f;
      }
    }
    // the weight slab: taps x kc rows of bn / 4 16-byte words
    const int upr = 2 * p.cg;
    const int n = taps * p.kc * upr;
#pragma unroll 1
    for (int i = tid; i < n; i += nth) {
      const int row = i / upr, u = i - row * upr;
      const int tap = row / p.kc, c = c0 + row - tap * p.kc, o = n0 + u * 4;
      const bool ok = c < a.Cin && o < p.CoutP;
      const float* src = ok ? a.w + ((size_t)tap * a.Cin + c) * p.CoutP + o : a.w;
      cp_async<16>(smem_u32(sw + row * bn + u * 4), src, ok ? 16 : 0);
    }
  };

  float acc[kPX][kCO];
#pragma unroll
  for (int q = 0; q < kPX; ++q)
#pragma unroll
    for (int o = 0; o < kCO; ++o) acc[q][o] = 0.f;

  // chunk c is computed while chunk c+1 is on its way
  load_chunk(0);
  asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll 1
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // chunk is staged, and every thread is done with chunk-1
    if (chunk + 1 < nchunks) {
      load_chunk(chunk + 1);
      asm volatile("cp.async.commit_group;\n" ::);
    }

    const float* sx = smem + (chunk % kStages) * g.stage_floats + (pr * g.cols + pc) * g.ps;
    const float* sw = smem + (chunk % kStages) * g.stage_floats + g.x_floats + cg * 4;
#pragma unroll 1
    for (int ky = 0; ky < kh; ++ky) {
#pragma unroll 1
      for (int c4 = kgi; c4 < p.kc / 4; c4 += p.kg) {
        // the thread's input row for 4 channels, with the kw - 1 halo pixels
        float4 xv[kPX + KW - 1];
        const float* xr = sx + ky * g.cols * g.ps + c4 * 4;
#pragma unroll
        for (int j = 0; j < kPX + KW - 1; ++j) xv[j] = *reinterpret_cast<const float4*>(xr + j * g.ps);
#pragma unroll
        for (int kx = 0; kx < KW; ++kx) {
          const float* wr = sw + ((ky * KW + kx) * p.kc + c4 * 4) * bn;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 wa = *reinterpret_cast<const float4*>(wr + cc * bn);
            const float4 wb = *reinterpret_cast<const float4*>(wr + cc * bn + half);
#pragma unroll
            for (int q = 0; q < kPX; ++q) {
              const float xs = lane(xv[q + kx], cc);
              acc[q][0] = fmaf(xs, wa.x, acc[q][0]);
              acc[q][1] = fmaf(xs, wa.y, acc[q][1]);
              acc[q][2] = fmaf(xs, wa.z, acc[q][2]);
              acc[q][3] = fmaf(xs, wa.w, acc[q][3]);
              acc[q][4] = fmaf(xs, wb.x, acc[q][4]);
              acc[q][5] = fmaf(xs, wb.y, acc[q][5]);
              acc[q][6] = fmaf(xs, wb.z, acc[q][6]);
              acc[q][7] = fmaf(xs, wb.w, acc[q][7]);
            }
          }
        }
      }
    }
  }

  if (p.kg > 1) {
    // the k-groups' partial sums, added to group 0's in group order
    __syncthreads();  // every buffer has been read
    float* part = smem;
    if (kgi > 0) {
#pragma unroll
      for (int i = 0; i < kPX * kCO; ++i) part[((kgi - 1) * kPX * kCO + i) * group + rem] = acc[i / kCO][i % kCO];
    }
    __syncthreads();
    if (kgi == 0) {
      for (int k = 1; k < p.kg; ++k) {
#pragma unroll
        for (int i = 0; i < kPX * kCO; ++i) acc[i / kCO][i % kCO] += part[((k - 1) * kPX * kCO + i) * group + rem];
      }
    }
  }
  float* out = reinterpret_cast<float*>(a.out);
  if (a.Cout % 4 != 0 || a.nanc) {
    // a Cout that is no multiple of 4, or the anchor epilogue: the tile's
    // sums go through shared memory (rows of bn + 4 floats) and are written
    // channel fastest, so that neighbouring threads store neighbouring
    // addresses
    __syncthreads();  // every buffer and partial sum has been read
    const int ts = bn + 4;
    if (kgi == 0) {
#pragma unroll
      for (int q = 0; q < kPX; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(smem + (pr * kTC + pc + q) * ts + h * half + cg * 4) =
              make_float4(acc[q][h * 4], acc[q][h * 4 + 1], acc[q][h * 4 + 2], acc[q][h * 4 + 3]);
    }
    __syncthreads();
    const int nvalid = min(bn, a.Cout - n0);
    const int n = p.tr * kTC * nvalid;
    for (int i = tid; i < n; i += nth) {
      const int px = i / nvalid, c = i - px * nvalid;
      const int y = y0 + px / kTC, x = x0 + px % kTC;
      if (y >= a.H || x >= a.W) continue;
      const size_t pix = ((size_t)b * a.H + y) * a.W + x;
      out[pix * a.Cout + n0 + c] = epilogue(a, smem[px * ts + c], a.scale[n0 + c], a.shift[n0 + c], pix, n0 + c);
    }
    return;
  }
  // otherwise each thread stores its own sums, 4 channels per 16-byte store
  if (kgi != 0) return;
  const int y = y0 + pr;
  if (y >= a.H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int oc = n0 + h * half + cg * 4;
    if (oc >= a.Cout) continue;
    const float4 sc = make_float4(a.scale[oc], a.scale[oc + 1], a.scale[oc + 2], a.scale[oc + 3]);
    const float4 sh = make_float4(a.shift[oc], a.shift[oc + 1], a.shift[oc + 2], a.shift[oc + 3]);
#pragma unroll
    for (int q = 0; q < kPX; ++q) {
      const int x = x0 + pc + q;
      if (x >= a.W) break;
      const size_t pix = ((size_t)b * a.H + y) * a.W + x;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a.res) r = *reinterpret_cast<const float4*>(a.res + pix * a.Cout + oc);
      float4 v;
      v.x = activate(acc[q][h * 4 + 0] * sc.x + sh.x, a.act) + r.x;
      v.y = activate(acc[q][h * 4 + 1] * sc.y + sh.y, a.act) + r.y;
      v.z = activate(acc[q][h * 4 + 2] * sc.z + sh.z, a.act) + r.z;
      v.w = activate(acc[q][h * 4 + 3] * sc.w + sh.w, a.act) + r.w;
      *reinterpret_cast<float4*>(out + pix * a.Cout + oc) = v;
    }
  }
}

template <int KW, int RESIDENT>
cudaError_t launch_fma(const ConvArgs<float>& a, const FmaPlan& p, cudaStream_t stream) {
  const Geometry g = geometry(p, a.Cin, a.kh, KW);
  const size_t smem = (size_t)(g.region + g.npix) * sizeof(float);
  const int threads = 2 * p.tr * p.cg * p.kg;
  if (smem > kMaxSmem || threads > kMaxThreads) return cudaErrorInvalidValue;
  auto kernel = fused_conv_kernel<KW, RESIDENT>;
  static size_t granted = 48 * 1024;  // dynamic shared memory this instance may use
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  const dim3 grid(((a.W + kTC - 1) / kTC) * ((a.H + p.tr - 1) / p.tr), a.B * ((a.Cout + 8 * p.cg - 1) / (8 * p.cg)));
  kernel<<<grid, threads, smem, stream>>>(a, p);
  return cudaGetLastError();
}

}  // namespace zt

// C entry point, bound with ctypes: the launch record of fused_conv.cuh
// (kFmaSlots slots) and the stream. Every address is a device pointer of a
// contiguous f32 tensor: the inputs, residual and anchors, the prepared
// weights (kh*kw, Cin, CoutP), scale/shift and the output. The tile rows,
// channel groups, k-groups, chunk, copy widths and resident blocks come from
// k1_plan.
// Returns cudaErrorInvalidValue for a plan the kernel cannot take, else
// cudaGetLastError() after the launch.
extern "C" int zt_fused_conv(const long long* record, void* stream) {
  using namespace zt;
  auto num = [&](int i) { return static_cast<int>(record[i]); };
  const ConvArgs<float> a = make_args<float>(record);
  FmaPlan p{num(kFTr), num(kFCg), num(kFKg), num(kFKc),
            {num(kFVec0), num(kFVec0 + 1), num(kFVec0 + 2), num(kFVec0 + 3)}, num(kFCoutP), num(kFResident)};
  if (p.tr < 1 || p.cg < 1 || p.cg > 8 || p.kg < 1 || p.kc < 4 || p.kc % 4 != 0 || p.kg > p.kc / 4 ||
      p.CoutP % 4 != 0 || p.CoutP < a.Cout)
    return cudaErrorInvalidValue;
  for (int j = 0; j < a.nin; ++j) {
    const int v = p.vec[j];
    if ((v != 1 && v != 2 && v != 4) || a.cin_part[j] % v != 0) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.kw * 10 + p.resident) {
    case 11: return launch_fma<1, 1>(a, p, s);
    case 31: return launch_fma<3, 1>(a, p, s);
    case 51: return launch_fma<5, 1>(a, p, s);
    case 12: return launch_fma<1, 2>(a, p, s);
    case 32: return launch_fma<3, 2>(a, p, s);
    default: return cudaErrorInvalidValue;  // the 1x5 taps keep every register (1 resident block)
  }
}
