// K1f's 2x2 form (conv2x2_f32_kernel): the folded RRDBNet head's two
// space-to-depth convs in float32 (the parity mode), NHWC float32 in and
// out, float32 weights HWIO (2, 2, Cin, Cout), the float32 bias, the
// LeakyReLU, the frame mask (MASK) and the depth-to-space store (D2S) in
// the epilogue (flags as csrc/conv3x3.cu's: LRELU 1, MASK 4, D2S 8;
// ROUND_FIRST is moot in float32), all on the CUDA cores. It replaces no
// Pallas kernel: the JAX package's _head_forward (models/rrdbnet.py:586)
// runs these convs as XLA convs.
//
// What bounds it on an H100: its operations, 2 x 4 x Cin x Cout a pixel
// against 67 TFLOP/s of float32 outside the tensor cores (hr, 4 x 537^2 x
// 256 -> 256: 9.03 ms); the bytes are a few percent of that. The design
// is K1f's (csrc/conv3x3_f32.cu): a register-blocked implicit GEMM in
// which a thread owns a row segment of 8 consecutive output pixels x one
// 8-channel granule (64 accumulators), reads the segment's 9 input pixels
// of an input row once for both kx taps and 4 channels (9 LDS.128) and
// the weights as float4 broadcasts (16 LDS.128) for 512 FFMA; the next
// pass's patch (cp.async, zero-filled halo and edges) and weights (bulk
// copies) land in a two-stage ring on an mbarrier, one block barrier a
// pass. The earlier form ran that design's body with two taps, where hr ran
// at 44% of its bound, behind cuDNN: Cout 256 went as two channel groups
// on grid rows, each staging the patch again, with 256 threads a block (8
// warps an SM at 168 registers), and its 8-channel passes held only 2,048
// FFMA a thread between two block barriers. This form:
//  * takes Cout up to 256 in one channel group (32 granules), so the patch
//    is staged once for every output channel;
//  * sizes the block to 384 threads: 12 segments (6 output rows) x 32
//    granules at hr, more rows as Cout narrows (up to 32), so an SM runs
//    12 warps;
//  * passes of 16 input channels where Cout has 16 granules or more
//    (4,096 FFMA a thread between barriers), 8 where it is narrow (last,
//    256 -> 12, keeps the earlier geometry: 32 x 16 outputs, 128 threads).
// A tile of 2 output rows a thread (3 input rows for 4 row-taps, about 35
// FFMA a shared load) was left out: its 128 accumulators and 36 registers
// of input need about 190 registers, which caps an SM at 8 warps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TW = 16;                 // output columns a tile (2 segments)
constexpr int MAX_GRAN = 32;           // granules a block: 256 channels
constexpr int THREADS = 384;           // the most threads a block
constexpr int MAX_ROWS = 32;           // output rows a tile
constexpr int BARS = 128;              // bytes before the ring: 2 mbarriers
constexpr int PW = TW + 1;             // patch columns with the halo
constexpr int LRELU = 1, MASK = 4, D2S = 8;   // epilogue flags

// The patch row in floats: PW pixels of CC channels (CC / 4 16-byte units
// each) plus one unit, an odd number, so that the segments of a load fall
// in distinct bank groups.
template <int CC>
__host__ __device__ constexpr int prs() { return PW * CC + 4; }

struct Args {
  const float* x;
  const float* w;
  const float* bias;
  float* y;
  int H, W, Cin, Cout, flags;
  int Ho, Wo, pad, D;   // output size; the patch starts at -pad; Cout / 4
  int tiles_x;   // tiles along Wo
  int S, G;      // segments (2 a row) and granules a block
  int ws;        // floats between weight rows (Cout, or 8G)
  int stage;     // floats a ring stage: weights then patch
  int vec_x;     // patch by 16-byte cp.async (Cin % 4 == 0, aligned)
  int vec_w;     // weights by bulk copy (Cin, Cout % 4 == 0, aligned)
  int vec_y;     // y 16-byte aligned: 8 channels in one piece by float4
};

__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// One bulk copy completing on `bar`; the bytes are announced elsewhere.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// MASK: whether output channel co of pixel (oy, ox) lies inside the frame.
__device__ __forceinline__ bool kept(const Args& a, int oy, int ox, int co) {
  if (!(a.flags & MASK)) return true;
  const int g = co / a.D, oi = g >> 1, oj = g & 1;
  return !((oi == 0 && oy == 0) || (oi == 1 && oy == a.Ho - 1) ||
           (oj == 0 && ox == 0) || (oj == 1 && ox == a.Wo - 1));
}

// Where output channel co of pixel (oy, ox) of image n is stored.
__device__ __forceinline__ size_t out_index(const Args& a, int n, int oy,
                                            int ox, int co) {
  if (a.flags & D2S) {
    const int g = co / a.D, f = co - g * a.D;
    return (((size_t)n * 2 * a.Ho + 2 * oy + (g >> 1)) * 2 * a.Wo + 2 * ox +
            (g & 1)) * a.D + f;
  }
  return (((size_t)n * a.Ho + oy) * a.Wo + ox) * a.Cout + co;
}

template <int CC>
__global__ void __launch_bounds__(THREADS)
conv2x2_f32_kernel(const Args a) {
  static_assert(CC == 8 || CC == 16, "passes of 8 or 16 channels");
  constexpr int T = 4, PRS = prs<CC>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem + BARS);
  const uint32_t bar0 = nesr::smem_u32(smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int S = a.S, TH = S / 2, G = a.G;
  const int seg = tid % S, gran = tid / S;
  const int r = seg >> 1, half = seg & 1;
  const int n = blockIdx.z, co0 = blockIdx.y * G * 8;
  const int ty0 = (blockIdx.x / a.tiles_x) * TH;
  const int tx0 = (blockIdx.x % a.tiles_x) * TW;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout, pad = a.pad;
  const int wfloats = T * CC * a.ws;   // a stage's weights
  const int passes = (Cin + CC - 1) / CC;
  const float* xn = a.x + (size_t)n * H * W * Cin;
  // Cout columns this block's weight rows hold (one group: every column)
  const int ncols = min(8 * G, Cout - co0);
  const bool single = gridDim.y == 1;

  if (tid == 0) {
    nesr::mbar_init(reinterpret_cast<uint64_t*>(smem), nt + 1);
    nesr::mbar_init(reinterpret_cast<uint64_t*>(smem) + 1, nt + 1);
    nesr::mbar_init_fence();
  }
  __syncthreads();

  // Stages pass p into ring stage p % 2: every thread issues its share of
  // the patch (and, by 4-byte copies, of the weights) and arrives on the
  // stage's mbarrier when they land; thread 0 announces the bulk copies'
  // bytes (or arrives), warp 0 issues them.
  auto issue = [&](int p) {
    float* sw = ring + (p & 1) * a.stage;
    float* sx = sw + wfloats;
    const uint32_t bar = bar0 + 8 * (p & 1);
    const int c0 = p * CC, cc = min(CC, Cin - c0);
    if (a.vec_x) {
      constexpr int U = CC / 4, LU = CC == 16 ? 2 : 1;   // units a pixel
      for (int i = tid; i < (TH + 1) * PW * U; i += nt) {
        const int q = i & (U - 1), px = (i >> LU) % PW, py = (i >> LU) / PW;
        const int iy = ty0 - pad + py, ix = tx0 - pad + px;
        const int ci = c0 + 4 * q;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin;
        const float* src = ok ? xn + ((size_t)iy * W + ix) * Cin + ci : a.x;
        nesr::cp_async_zfill<16>(sx + py * PRS + px * CC + 4 * q, src,
                                 ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < (TH + 1) * PW * CC; i += nt) {
        const int ci = i % CC, px = (i / CC) % PW, py = i / (CC * PW);
        const int iy = ty0 - pad + py, ix = tx0 - pad + px;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < cc;
        const float* src =
            ok ? xn + ((size_t)iy * W + ix) * Cin + c0 + ci : a.x;
        nesr::cp_async_zfill<4>(sx + py * PRS + px * CC + ci, src,
                                ok ? 4 : 0);
      }
    }
    if (a.vec_w) {
      // One run a tap (one group), or one a (tap, channel) row.
      const int runs = single ? T : T * cc;
      const int bytes = (single ? cc * Cout : ncols) * 4;
      if (tid == 0) nesr::mbar_expect_tx(bar, (uint32_t)(runs * bytes));
      if (tid < 32) {
        for (int i = tid; i < runs; i += 32) {
          const int tap = single ? i : i / cc, ci = single ? 0 : i % cc;
          const float* src =
              a.w + ((size_t)tap * Cin + c0 + ci) * Cout + (single ? 0 : co0);
          bulk_copy(nesr::smem_u32(sw + (tap * CC + ci) * a.ws), src,
                    (uint32_t)bytes, bar);
        }
      }
    } else {
      for (int i = tid; i < T * CC * a.ws; i += nt) {
        const int co = i % a.ws, ci = (i / a.ws) % CC, tap = i / (a.ws * CC);
        const bool ok = ci < cc && co0 + co < Cout;
        const float* src =
            ok ? a.w + ((size_t)tap * Cin + c0 + ci) * Cout + co0 + co : a.w;
        nesr::cp_async_zfill<4>(sw + i, src, ok ? 4 : 0);
      }
      if (tid == 0) nesr::mbar_arrive(bar);
    }
    cp_async_arrive_noinc(bar);
  };

  float acc[8][8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[t][c] = 0.f;

  issue(0);
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    // Every thread is done with the other stage. Where the next pass is
    // staged into a stage read before, the reads are ordered before its
    // copies (the bulk copies are the async proxy's) by the proxy fence,
    // then the barrier, as the bf16 kernels' consumers release a stage.
    if (p > 0 && p + 1 < passes) nesr::fence_proxy_async();
    __syncthreads();
    if (p + 1 < passes) issue(p + 1);
    nesr::mbar_wait(bar0 + 8 * (p & 1), (p >> 1) & 1);
    const float* sw = ring + (p & 1) * a.stage + 8 * gran;
    const float* sx = ring + (p & 1) * a.stage + wfloats + r * PRS +
                      8 * half * CC;
    // Channel quads of this pass that hold real channels: with Cin % 4
    // != 0 the pass is zero-filled to CC, weights and patch alike.
    const int nq = (Cin & 3) ? CC / 4 : min(CC, Cin - p * CC) / 4;
    // Rolled over (quad, ky): the 512-FFMA body stays in the instruction
    // cache.
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
#pragma unroll 1
      for (int ky = 0; ky < 2; ++ky) {
        float4 in[9];
#pragma unroll
        for (int t = 0; t < 9; ++t)
          in[t] = *reinterpret_cast<const float4*>(sx + ky * PRS + t * CC +
                                                   4 * q);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
          for (int kx = 0; kx < 2; ++kx) {
            const float* wp = sw + ((ky * 2 + kx) * CC + 4 * q + ch) * a.ws;
            const float4 wa = *reinterpret_cast<const float4*>(wp);
            const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float v = comp(in[t + kx], ch);
              acc[t][0] = fmaf(v, wa.x, acc[t][0]);
              acc[t][1] = fmaf(v, wa.y, acc[t][1]);
              acc[t][2] = fmaf(v, wa.z, acc[t][2]);
              acc[t][3] = fmaf(v, wa.w, acc[t][3]);
              acc[t][4] = fmaf(v, wb.x, acc[t][4]);
              acc[t][5] = fmaf(v, wb.y, acc[t][5]);
              acc[t][6] = fmaf(v, wb.z, acc[t][6]);
              acc[t][7] = fmaf(v, wb.w, acc[t][7]);
            }
          }
        }
      }
    }
  }

  const int oy = ty0 + r, cb = co0 + 8 * gran;
  if (oy >= a.Ho || cb >= Cout) return;
  float bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    bv[c] = a.bias != nullptr && cb + c < Cout ? a.bias[cb + c] : 0.f;
  // 8 channels in one piece: one group of D % 8 == 0 channels under MASK
  // or D2S.
  const bool whole = !(a.flags & (MASK | D2S)) || a.D % 8 == 0;
  const bool vec_y = a.vec_y && (Cout & 3) == 0 && cb + 8 <= Cout && whole;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int ox = tx0 + 8 * half + t;
    if (ox >= a.Wo) break;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = acc[t][c] + bv[c];
      if (a.flags & LRELU) v[c] = nesr::lrelu(v[c]);
    }
    if (vec_y) {
      const bool in_frame = kept(a, oy, ox, cb);
      float* yp = a.y + out_index(a, n, oy, ox, cb);
      *reinterpret_cast<float4*>(yp) =
          in_frame ? make_float4(v[0], v[1], v[2], v[3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(yp + 4) =
          in_frame ? make_float4(v[4], v[5], v[6], v[7])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (cb + c < Cout)
          a.y[out_index(a, n, oy, ox, cb + c)] =
              kept(a, oy, ox, cb + c) ? v[c] : 0.f;
    }
  }
}

template <int CC>
int launch(Args a, int N, int groups, int rows, cudaStream_t stream) {
  // weights, then the patch; a stage is a whole number of 128 bytes
  a.stage = (4 * CC * a.ws + (rows + 1) * prs<CC>() + 31) / 32 * 32;
  const int smem = BARS + 2 * a.stage * 4;
  cudaError_t err = cudaFuncSetAttribute(
      conv2x2_f32_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (a.Ho + rows - 1) / rows;
  dim3 grid(a.tiles_x * tiles_y, groups, N);
  conv2x2_f32_kernel<CC><<<grid, a.S * a.G, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The 2x2 form at padding `pad` (0 or 1): x (N, H, W, Cin), w (2, 2, Cin,
// Cout), bias (Cout,) or null, y (N, H + 2 pad - 1, W + 2 pad - 1, Cout)
// or its depth-to-space form under D2S, all float32 and contiguous
// (kernels/conv3x3.py checks); a y that is not 16-byte aligned is
// stored a float at a time.
extern "C" int nesr_conv2x2_f32(const void* x, const void* w,
                                const void* bias, void* y, int N, int H,
                                int W, int Cin, int Cout, int pad, int flags,
                                void* stream) {
  if ((pad != 0 && pad != 1) || (flags & ~(LRELU | 2 | MASK | D2S)) ||
      ((flags & (MASK | D2S)) && Cout % 4))
    return (int)cudaErrorInvalidValue;
  const int gran = (Cout + 7) / 8;
  const int groups = (gran + MAX_GRAN - 1) / MAX_GRAN;
  Args a;
  a.x = (const float*)x;
  a.w = (const float*)w;
  a.bias = (const float*)bias;
  a.y = (float*)y;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.flags = flags;
  a.pad = pad;
  a.Ho = H + 2 * pad - 1;
  a.Wo = W + 2 * pad - 1;
  a.D = Cout / 4;
  if (a.Ho < 1 || a.Wo < 1) return (int)cudaErrorInvalidValue;
  a.G = (gran + groups - 1) / groups;
  // 384 threads (2 segments a row x G granules), at most MAX_ROWS rows
  const int rows = min(MAX_ROWS, max(1, THREADS / 2 / a.G));
  a.S = 2 * rows;
  a.tiles_x = (a.Wo + TW - 1) / TW;
  a.vec_x = Cin % 4 == 0 && ((uintptr_t)x & 15) == 0;
  a.vec_w = Cin % 4 == 0 && Cout % 4 == 0 && ((uintptr_t)w & 15) == 0;
  a.vec_y = ((uintptr_t)y & 15) == 0;
  a.ws = a.vec_w && groups == 1 ? Cout : 8 * a.G;
  cudaStream_t s = (cudaStream_t)stream;
  return a.G >= 16 ? launch<16>(a, N, groups, rows, s)
                   : launch<8>(a, N, groups, rows, s);
}
