// K1 on the bf16 tensor cores: the same function as fused_conv.cu (its
// header says what K1 computes), for bf16 operands, as an implicit GEMM.
//
// Replaces, for the "fast" precision mode, the Pallas kernels
//   zero_tig_tpu/ops/pack_conv.py: conv3x3_packed (:214),
//     conv3x3_packed_multi (:394), residual1x1_packed (:546),
//     residual1x1_packed_multi (:491),
//   zero_tig_tpu/ops/pallas_conv.py: conv3x3_bf16 (:125),
// and every convolution of zero_tig_tpu/models/raft/update_kernel.py:
// update_core_kernel (:248), which on the TPU was one pallas_call per
// iteration with every intermediate in VMEM; here each conv is one launch.
// f32 operands (the "highest" mode) never come here: they stay on the f32
// FMA kernel of fused_conv.cu, because TF32 products would break that mode's
// f32 parity with the reference. ops/fused_conv.py::k1_plan picks the kernel
// by the operand type alone, and the tile shape below by the layer's shape;
// nothing falls back from one kernel to the other.
//
// The GEMM: M = output pixels, N = output channels, K = taps x Cin,
//   acc[p, o] = sum_{tap, c} x[p + tap - pad, c] * w[tap, c, o]
// as mma.sync.m16n8k16 (bf16 x bf16 -> f32; each product is exact in f32, so
// only the order of the f32 sum differs from the FMA kernel and the twin).
//
// What bounds it on the H100. By the roofline the 1080p layers (3-64
// channels, 130-270 MB per launch for 0.1-0.15 TFLOP) sit at the ridge, bytes
// by a small margin, and the 45x80 RAFT layers are bound by operations
// (0.3-3.5 GFLOP on 0.5-4 MB). What the kernel meets first is the shared
// memory pipe: mma.sync takes both operands from registers, so every warp
// reads its A and B fragments with ldmatrix for each k-step (3 ldmatrix.x4
// per 4 mma in a 32 x 16 warp tile, 4 per 8 in a 32 x 32 one), and the
// cp.async copies of the next chunks queue behind those reads. On the small
// grid the time of a launch is that of one block's walk through its chunks
// (the 1x5 GRU conv takes 40 us with 240 blocks for its 256 output channels
// and 34 us with 120 blocks for 128); larger warp tiles in fewer warps did
// not help there (too few warps are left to hide the ldmatrix latency). wgmma, which reads B from
// shared memory once per warpgroup, is what would lift this bound. The design:
//  - a block computes a tile of TR image rows x 16 columns for BN output
//    channels (all of Cout where Cout <= 64), so the input halo tile is
//    staged once per block and not once per 8 channels. The 16 consecutive
//    pixels of a tile row are the 16 rows of an A fragment, and tap (ky, kx)
//    is the same staged tile read at pixel offset (ky, kx): no im2col copy.
//  - the halo tile is staged in bf16, pixel-major [pixel][kc] for a chunk of
//    kc = 16..64 input channels, with a pixel stride of 2*kc + 16 bytes (an
//    odd number of 16-byte units), so the 8 rows of an ldmatrix 8x8 fall on
//    distinct banks. Pixels outside the image and the channels that pad Cin
//    to 16 are zero when staged; the inner loop never branches on them. Where
//    each halo pixel lies in the image is worked out once per tile, into a
//    table in shared memory that the copies of every chunk read.
//  - the weights arrive packed as [tap][CinP][CoutP] (Cin padded to 16, Cout
//    to 8, zeros in the padding; ops/fused_conv.py::pack_weights). A chunk's
//    slab [tap][kc][BN] is staged beside the input chunk, rows padded by 16
//    bytes against bank conflicts, and read as B fragments by ldmatrix.trans.
//  - global -> shared by cp.async over a ring of 3 stages, one
//    __syncthreads per chunk, so the loads of chunks c+1 and c+2 overlap the
//    mma of chunk c. The copy width is chosen per input part (16, 8 or 4
//    bytes, or a scalar 2-byte load) from what the part's channel count and
//    offset in the concat allow, so the concat of ragged parts
//    ([128,128,126,2], [6,3,3], 324 channels) never has to be written to
//    memory. The copy loops are rolled, with the width a run-time switch and
//    one call site: unrolled per width they tripled the library's build
//    time and ran no faster.
//  - the fragments of k-step s+1 are loaded into a second set of registers
//    before the mma of step s start.
//  - the epilogue goes through shared memory (see the kernel): f32
//    fragments to a tile, then a rolled loop with 16-byte residual loads and
//    output stores where Cout allows, else element by element, coalesced.
//  - tile shapes (template instances, chosen by k1_plan): 8 rows x 16 px x
//    64 channels for full-resolution layers; 8 x 16 x 8 for their 3- and
//    6-channel heads; 4 x 16 x 64 or 32 for small grids (32 where 64 would
//    leave SMs without a block); 4 x 16 x 8 for the 2-channel flow head.
#include <cstdint>

#include "fused_conv.cuh"

namespace zt {

constexpr int kStages = 3;  // ring of chunk buffers in shared memory
constexpr int kTC = 16;     // tile columns: the rows of one A fragment
constexpr int kMaxSmem = 227 * 1024;

struct MmaPlan {
  int kc;      // input channels per chunk, a multiple of 16
  int vec[4];  // elements per copy of each input part: 8, 4, 2 or 1
  int CinP, CoutP;
};

__host__ __device__ inline int a_stride(int kc) { return kc * 2 + 16; }
template <int BN>
__host__ __device__ constexpr int b_stride() {
  return BN * 2 + ((BN / 8) % 2 == 0 ? 16 : 0);
}

constexpr int kER = 4;  // tile rows of one epilogue round
// bytes between two pixels of the epilogue's f32 tile in shared memory: 32
// bytes mod 128, so that the 4 pixels x 4 lanes x 8 bytes of half a warp's
// fragment store spread over all banks
template <int BN>
__host__ __device__ constexpr int acc_stride() {
  return BN * 4 + 32;
}
__host__ __device__ inline int a_region(int a_bytes, int out_bytes, int nchunks) {
  return nchunks == 1 && out_bytes > a_bytes ? out_bytes : a_bytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Geometry of the tile a block has staged.
struct Tile {
  int cols, npix, as;  // halo columns, halo pixels, pixel stride in bytes
  int b, y0, x0;       // image, first output row and column
  const int* pix;      // shared memory: each halo pixel's index in the image, -1 outside
};

// Stage `units` copies of v channels (8, 4, 2 or 1) per halo pixel from one
// input part: local channels [first, first + units*v) to byte offset dst_off
// of each staged pixel. Neighbouring lanes take neighbouring units. The loop
// is kept rolled and the copy width a run-time switch: the kernel's code
// must stay small, and this runs once per chunk.
template <int NTH>
__device__ __forceinline__ void stage_part(const Tile& t, const bf16* base, int cj, int first,
                                           int units, int v, unsigned char* sA, int dst_off, int tid) {
  // i / units == umulhi(i, m) for i < 2^16, units >= 2
  const unsigned m = 0xFFFFFFFFu / (unsigned)units + 1u;
  const int n = t.npix * units;
#pragma unroll 1
  for (int i = tid; i < n; i += NTH) {
    const int px = units == 1 ? i : (int)__umulhi((unsigned)i, m);
    const int u = i - px * units;
    const int gp = t.pix[px];
    const bf16* src = gp < 0 ? nullptr : base + (size_t)gp * cj + first + u * v;
    unsigned char* dst = sA + px * t.as + dst_off + u * v * 2;
    if (v == 8) cp_async<16>(smem_u32(dst), src ? src : base, src ? 16 : 0);
    else if (v == 4) cp_async<8>(smem_u32(dst), src ? src : base, src ? 8 : 0);
    else if (v == 2) cp_async<4>(smem_u32(dst), src ? src : base, src ? 4 : 0);
    else *reinterpret_cast<bf16*>(dst) = src ? *src : __float2bfloat16(0.f);
  }
}

// blocks of a tile shape that the registers of one SM must admit (what
// ops/fused_conv.py::K1_TILES counts on when it sizes a walk)
constexpr int min_blocks(int threads, int mt, int nt) { return threads >= 256 ? 2 : mt * nt >= 2 ? 5 : 8; }

template <typename TO, int TR, int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32, min_blocks(WM * WN * 32, MT, NT))
fused_conv_mma_kernel(const ConvArgs<bf16> a, const MmaPlan p) {
  static_assert(WM * MT == TR, "a warp row covers MT tile rows");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load in pairs of n-tiles");
  constexpr int BN = WN * NT * 8;
  constexpr int NTH = WM * WN * 32;
  constexpr int BS = b_stride<BN>();
  constexpr int UPR = BN / 8;  // 16-byte units per staged weight row
  constexpr int AS = acc_stride<BN>();
  static_assert(TR % kER == 0 && (kER % MT == 0), "an epilogue round takes whole warp rows");
  extern __shared__ __align__(16) unsigned char smem[];

  const int taps = a.kh * a.kw;
  Tile t;
  t.cols = kTC + a.kw - 1;
  t.npix = (TR + a.kh - 1) * t.cols;
  t.as = a_stride(p.kc);
  const int nchunks = (p.CinP + p.kc - 1) / p.kc;
  const int nstages = min(nchunks, kStages);
  // with one chunk the weights stay while the epilogue's tile takes the
  // input's place, so the input's region is as large as the larger of the two
  const int a_bytes = a_region(t.npix * t.as, kER * kTC * AS, nchunks);
  const int stage_bytes = a_bytes + taps * p.kc * BS;
  // this block's scale and shift, behind the stages: read by the epilogue,
  // after the main loop's barriers
  float* s_affine = reinterpret_cast<float*>(smem + max(nstages * stage_bytes, kER * kTC * AS));
  int* s_pix = reinterpret_cast<int*>(s_affine + 2 * BN);  // the tile's halo pixels, see Tile
  t.pix = s_pix;
  const unsigned magic = 65536u / t.cols + 1;  // px / cols == (px * magic) >> 16 for every halo pixel
  const int ntile_n = (p.CoutP + BN - 1) / BN;
  t.b = blockIdx.y / ntile_n;
  const int n0 = (blockIdx.y % ntile_n) * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) / WN;
  const int wn = (tid >> 5) % WN;

  // stage chunk `chunk` of the current tile: its input channels and, with
  // with_b, its weight slab
  auto load_chunk = [&](int chunk, bool with_b) {
    unsigned char* sA = smem + (chunk % nstages) * stage_bytes;
    unsigned char* sB = sA + a_bytes;
    const int c0 = chunk * p.kc;
    const int kce = min(p.kc, p.CinP - c0);
    int off = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < a.nin) {
        const int cj = a.cin_part[j];
        const int lo = max(c0, off), hi = min(c0 + kce, off + cj);
        if (lo < hi) {
          const int v = p.vec[j];
          stage_part<NTH>(t, a.in[j], cj, lo - off, (hi - lo) >> (31 - __clz(v)), v, sA, (lo - c0) * 2, tid);
        }
        off += cj;
      }
    }
    if (c0 + kce > a.Cin) {  // the channels that pad Cin to 16: zeros
      const int lo = max(c0, a.Cin) - c0;
      for (int px = tid; px < t.npix; px += NTH)
        for (int c = lo; c < kce; ++c)
          *reinterpret_cast<bf16*>(sA + px * t.as + c * 2) = __float2bfloat16(0.f);
    }
    if (with_b) {
      // the slab is taps x kce rows of UPR 16-byte units: a thread keeps its
      // unit and walks down the rows, over the taps
      constexpr int RSTEP = NTH / UPR;
      const int u = tid % UPR;
      if (n0 + u * 8 < p.CoutP) {
        const bf16* src = a.w + (size_t)c0 * p.CoutP + n0 + u * 8;
        const uint32_t dst = smem_u32(sB) + u * 16;
        int k = tid / UPR, tap = 0;
        while (k >= kce) k -= kce, ++tap;
#pragma unroll 1
        while (tap < taps) {
          cp_async<16>(dst + (tap * p.kc + k) * BS, src + (size_t)(tap * p.CinP + k) * p.CoutP, 16);
          k += RSTEP;
          while (k >= kce) k -= kce, ++tap;
        }
      }
    }
  };

  for (int i = tid; i < BN; i += NTH) {
    const bool ok = n0 + i < a.Cout;
    s_affine[i] = ok ? a.scale[n0 + i] : 0.f;
    s_affine[BN + i] = ok ? a.shift[n0 + i] : 0.f;
  }
  // n-tile pairs of this warp that hold real output channels
  const int warp_n0 = n0 + wn * NT * 8;
  const int npairs = NT == 1 ? 1 : min(NT / 2, (p.CoutP - warp_n0 + 15) / 16);
  // lane's row within an ldmatrix x4: matrix lane/8, row lane%8
  const int frag_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int frag_hi = lane >> 4;
  const int a_lane = ((wm * MT) * t.cols + frag_row) * t.as + frag_hi * 16;
  const int b_lane = frag_row * BS + wn * NT * 16 + (NT == 1 ? 0 : frag_hi * 16);
  const int tiles_x = (a.W + kTC - 1) / kTC;
  const int ntiles = tiles_x * ((a.H + TR - 1) / TR);
  TO* out = reinterpret_cast<TO*>(a.out);

  // A block walks over spatial tiles blockIdx.x, + gridDim.x, ... With one
  // chunk (the whole K in one stage) the weight slab is staged once and
  // stays for every tile of the walk.
  bool first_tile = true;
  for (int st = blockIdx.x; st < ntiles; st += gridDim.x) {
    const int tyi = st / tiles_x;
    t.y0 = tyi * TR;
    t.x0 = (st - tyi * tiles_x) * kTC;
    const bool with_b = first_tile || nchunks > 1;
    first_tile = false;
    // where each halo pixel lies in the image, once per tile: the copies of
    // every chunk read it instead of dividing and comparing again
    for (int px = tid; px < t.npix; px += NTH) {
      const int r = (px * magic) >> 16, c = px - r * t.cols;
      const int gy = t.y0 + r - a.ph, gx = t.x0 + c - a.pw;
      s_pix[px] = gy < 0 || gy >= a.H || gx < 0 || gx >= a.W ? -1 : (t.b * a.H + gy) * a.W + gx;
    }
    __syncthreads();

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    // chunk c is computed while chunks c+1 and c+2 are on their way: the
    // first kStages-1 rounds only start loads (one call site for the loader,
    // which keeps the code small)
#pragma unroll 1
    for (int chunk = 1 - kStages; chunk < nchunks; ++chunk) {
      if (chunk >= 0) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
        __syncthreads();  // chunk is staged, and every warp is done with chunk-1
      }
      if (chunk + kStages - 1 < nchunks) load_chunk(chunk + kStages - 1, with_b);
      asm volatile("cp.async.commit_group;\n" ::);
      if (chunk < 0) continue;

      const uint32_t sA = smem_u32(smem + (chunk % nstages) * stage_bytes);
      const uint32_t sB = sA + a_bytes;
      const int ksteps = min(p.kc, p.CinP - chunk * p.kc) / 16;
      // one flat loop over (tap, 16 channels) with the fragment addresses
      // advanced by additions: a tap moves the A tile by one pixel (or, at
      // the end of a tap row, to the next halo row), the B slab by kc rows.
      // The fragments of step s+1 are loaded before the mma of step s.
      uint32_t a_ptr = sA + a_lane, b_ptr = sB + b_lane;
      const int a_next_tap = t.as - (ksteps - 1) * 32, a_next_row = (t.cols - a.kw) * t.as;
      const int b_next_tap = (p.kc - (ksteps - 1) * 16) * BS;
      int ks = 0, kx = 0;
      constexpr int NP = NT == 1 ? 1 : NT / 2;
      auto load_frags = [&](uint32_t (&af)[MT][4], uint32_t (&bf)[NP][4]) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], a_ptr + mt * t.cols * t.as);
        if constexpr (NT == 1) {
          ldmatrix_x2_trans(bf[0], b_ptr);
        } else {
#pragma unroll
          for (int np = 0; np < NP; ++np)
            if (np < npairs) ldmatrix_x4_trans(bf[np], b_ptr + np * 32);
        }
        if (++ks < ksteps) {
          a_ptr += 32;
          b_ptr += 16 * BS;
        } else {
          ks = 0;
          a_ptr += a_next_tap;
          b_ptr += b_next_tap;
          if (++kx == a.kw) {
            kx = 0;
            a_ptr += a_next_row;
          }
        }
      };
      auto multiply = [&](const uint32_t (&af)[MT][4], const uint32_t (&bf)[NP][4]) {
        if constexpr (NT == 1) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][0], af[mt], bf[0][0], bf[0][1]);
        } else {
#pragma unroll
          for (int np = 0; np < NP; ++np) {
            if (np < npairs) {
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(acc[mt][2 * np], af[mt], bf[np][0], bf[np][1]);
                mma_bf16(acc[mt][2 * np + 1], af[mt], bf[np][2], bf[np][3]);
              }
            }
          }
        }
      };
      uint32_t af0[MT][4], af1[MT][4], bf0[NP][4], bf1[NP][4];
      int left = taps * ksteps;
      load_frags(af0, bf0);
#pragma unroll 1
      for (; left >= 2; left -= 2) {
        load_frags(af1, bf1);
        multiply(af0, bf0);
        if (left > 2) load_frags(af0, bf0);
        multiply(af1, bf1);
      }
      if (left == 1) multiply(af0, bf0);
    }

    for (int r = 0; r < TR / kER; ++r) {
      __syncthreads();  // the staged chunk, or the last round, has been read
      if ((wm * MT) / kER == r) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int pxl = (wm * MT + mt - r * kER) * kTC + (lane >> 2) + half * 8;
              *reinterpret_cast<float2*>(smem + pxl * AS + ((wn * NT + nt) * 8 + 2 * (lane & 3)) * 4) =
                  make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
            }
          }
        }
      }
      __syncthreads();
      const int nvalid = min(BN, a.Cout - n0);
      constexpr int VEC = 16 / (int)sizeof(TO);  // channels of one 16-byte store
      if (a.Cout % VEC == 0) {
        const int segs = nvalid / VEC;
        for (int i = tid; i < kER * kTC * segs; i += NTH) {
          const int pxl = i / segs, sg = i - pxl * segs;
          const int y = t.y0 + r * kER + pxl / kTC, x = t.x0 + pxl % kTC;
          if (y >= a.H || x >= a.W) continue;
          const size_t pix = ((size_t)t.b * a.H + y) * a.W + x;
          const int oc = n0 + sg * VEC;
          const float* sacc = reinterpret_cast<const float*>(smem + pxl * AS) + sg * VEC;
          alignas(16) bf16 res[VEC];
          if (a.res) {
            if constexpr (VEC == 8) *reinterpret_cast<uint4*>(res) = *reinterpret_cast<const uint4*>(a.res + pix * a.Cout + oc);
            else *reinterpret_cast<uint2*>(res) = *reinterpret_cast<const uint2*>(a.res + pix * a.Cout + oc);
          }
          alignas(16) TO o[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float v = activate(sacc[e] * s_affine[sg * VEC + e] + s_affine[BN + sg * VEC + e], a.act);
            if (a.res) v += to_f(res[e]);
            if (a.nanc) v = fminf(fmaxf(fetch_anchor(a, pix, oc + e) - v, a.lo), a.hi);
            o[e] = from_f<TO>(v);
          }
          *reinterpret_cast<uint4*>(out + pix * a.Cout + oc) = *reinterpret_cast<const uint4*>(o);
        }
      } else {
        for (int i = tid; i < kER * kTC * nvalid; i += NTH) {
          const int pxl = i / nvalid, c = i - pxl * nvalid;
          const int y = t.y0 + r * kER + pxl / kTC, x = t.x0 + pxl % kTC;
          if (y >= a.H || x >= a.W) continue;
          const size_t pix = ((size_t)t.b * a.H + y) * a.W + x;
          const float acc1 = reinterpret_cast<const float*>(smem + pxl * AS)[c];
          out[pix * a.Cout + n0 + c] = from_f<TO>(epilogue(a, acc1, s_affine[c], s_affine[BN + c], pix, n0 + c));
        }
      }
    }
    __syncthreads();  // the next tile's loads overwrite what was just read
  }
}

template <typename TO, int TR, int WM, int WN, int MT, int NT>
cudaError_t launch_mma(const ConvArgs<bf16>& a, const MmaPlan& p, int grid_x, cudaStream_t stream) {
  constexpr int BN = WN * NT * 8;
  const int npix = (TR + a.kh - 1) * (kTC + a.kw - 1);
  const int nchunks = (p.CinP + p.kc - 1) / p.kc;
  const int out_bytes = kER * kTC * acc_stride<BN>();
  size_t smem = (size_t)(nchunks < kStages ? nchunks : kStages) *
                (a_region(npix * a_stride(p.kc), out_bytes, nchunks) + a.kh * a.kw * p.kc * b_stride<BN>());
  if (smem < (size_t)out_bytes) smem = out_bytes;
  smem += 2 * BN * sizeof(float) + npix * sizeof(int);  // scale and shift, the halo pixels' indices
  if (smem > kMaxSmem || grid_x < 1) return cudaErrorInvalidValue;
  auto kernel = fused_conv_mma_kernel<TO, TR, WM, WN, MT, NT>;
  static size_t granted = 48 * 1024;  // dynamic shared memory this instance may use
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  const int ntile_n = (p.CoutP + BN - 1) / BN;
  kernel<<<dim3(grid_x, a.B * ntile_n), WM * WN * 32, smem, stream>>>(a, p);
  return cudaGetLastError();
}

// the tile shapes of ops/fused_conv.py::K1_TILES, by index
template <typename TO>
cudaError_t dispatch_tile(int tile, const ConvArgs<bf16>& a, const MmaPlan& p, int gx, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_mma<TO, 8, 4, 2, 2, 4>(a, p, gx, s);  // 8 rows x 64 channels, 8 warps
    case 1: return launch_mma<TO, 8, 4, 1, 2, 1>(a, p, gx, s);  // 8 rows x 8 channels, 4 warps
    case 2: return launch_mma<TO, 4, 2, 4, 2, 2>(a, p, gx, s);  // 4 rows x 64 channels, 8 warps
    case 3: return launch_mma<TO, 4, 4, 2, 1, 2>(a, p, gx, s);  // 4 rows x 32 channels, 8 warps
    case 4: return launch_mma<TO, 4, 4, 1, 1, 1>(a, p, gx, s);  // 4 rows x 8 channels, 4 warps
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace zt

// C entry point, bound with ctypes: the launch record of fused_conv.cuh
// (kMmaSlots slots) and the stream. Every address is a device pointer of a
// contiguous tensor: bf16 inputs, residual and anchors, the packed bf16
// weights (kh*kw, CinP, CoutP), f32 scale/shift; the output is f32 when the
// kOutF32 slot is not 0, else bf16. The tile, the blocks that walk over the
// spatial tiles, the chunk and the copy widths come from k1_plan. Returns
// cudaErrorInvalidValue for a plan the kernel cannot take, else
// cudaGetLastError() after the launch.
extern "C" int zt_fused_conv_mma(const long long* record, void* stream) {
  using namespace zt;
  auto num = [&](int i) { return static_cast<int>(record[i]); };
  const ConvArgs<bf16> a = make_args<bf16>(record);
  MmaPlan p{num(kKc), {num(kVec0), num(kVec0 + 1), num(kVec0 + 2), num(kVec0 + 3)}, num(kCinP), num(kCoutP)};
  if (p.kc < 16 || p.kc % 16 != 0 || p.CinP % 16 != 0 || p.CoutP % 8 != 0 || p.CinP < a.Cin || p.CoutP < a.Cout)
    return cudaErrorInvalidValue;
  for (int j = 0; j < a.nin; ++j) {
    const int v = p.vec[j];
    if ((v != 1 && v != 2 && v != 4 && v != 8) || a.cin_part[j] % v != 0) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return num(kOutF32) ? dispatch_tile<float>(num(kTile), a, p, num(kGridX), s)
                      : dispatch_tile<bf16>(num(kTile), a, p, num(kGridX), s);
}
