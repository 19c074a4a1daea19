// K1f's head 3x3 form (conv3x3_head_f32_kernel): the folded RRDBNet
// head's two 3x3 convs in float32 (the parity mode), up1 (nf -> 4 nf,
// stored depth-to-space) and up2, NHWC float32 in and out, float32
// weights HWIO (3, 3, Cin, Cout), the float32 bias, the LeakyReLU and the
// depth-to-space store (D2S) in the epilogue (flags as csrc/conv3x3.cu's:
// LRELU 1, D2S 8; ROUND_FIRST 2 is moot in float32), all on the CUDA
// cores. It replaces no Pallas kernel: the JAX package's _head_forward
// (models/rrdbnet.py:586) runs these convs as XLA convs.
//
// What bounds it on an H100: its operations, 2 x 9 x Cin x Cout a pixel
// against 67 TFLOP/s of float32 outside the tensor cores (up1, 4 x 268^2 x
// 64 -> 256: 1.2646 ms; up2, 4 x 536^2: 5.0583 ms); the bytes are a few
// percent of that. The design is K1f's (csrc/conv3x3_f32.cu) as its 2x2
// form has it (csrc/conv2x2_f32.cu): a register-blocked implicit GEMM in
// which a thread owns a row segment of 8 consecutive output pixels x one
// 8-channel granule (64 accumulators), reads the segment's 10 input
// pixels of an input row once for the three kx taps and 4 channels (10
// LDS.128) and the weights as float4 broadcasts (24 LDS.128) for 768
// FFMA; each 8-channel pass's patch (cp.async, zero-filled halo and
// edges) and weights (bulk copies) land in a two-stage ring on an
// mbarrier, one block barrier a pass. The earlier form ran K1f's SAME-conv
// body, where Cout 256 is 32 granules, over its 24: it went as two channel
// groups on grid rows, each staging the patch and its weights again, with
// 256 threads a block (8 warps an SM at 168 registers), at 46-47% of its
// bound and behind cuDNN. This form:
//  * takes Cout up to 256 in one channel group (32 granules), so the patch
//    is staged once for every output channel (wider Cout: groups of at
//    most 32 granules on grid rows);
//  * sizes the block to 384 threads: 12 segments (6 output rows) x 32
//    granules at Cout 256, more rows as Cout narrows (up to 32), so an SM
//    runs 12 warps, as K1f's w0 (24 granules x 16 segments) does;
//  * keeps passes of 8 input channels: a stage holds 9 x 8 x Cout floats
//    of weights (73,728 bytes at 256) and an 8 x 148-float patch, two
//    stages 156,928 bytes, and a pass is 4,608 FFMA a thread between
//    barriers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CC = 8;                  // input channels a pass
constexpr int TW = 16;                 // output columns a tile (2 segments)
constexpr int MAX_GRAN = 32;           // granules a block: 256 channels
constexpr int THREADS = 384;           // the most threads a block
constexpr int MAX_ROWS = 32;           // output rows a tile
constexpr int BARS = 128;              // bytes before the ring: 2 mbarriers
constexpr int PW = TW + 2;             // patch columns with the halo
// The patch row in floats: PW pixels of CC channels (two 16-byte units
// each) plus one unit, an odd number, so that the segments of a load fall
// in distinct bank groups.
constexpr int PRS = PW * CC + 4;
constexpr int LRELU = 1, ROUND_FIRST = 2, D2S = 8;   // epilogue flags

struct Args {
  const float* x;
  const float* w;
  const float* bias;
  float* y;
  int H, W, Cin, Cout, flags, D;   // D = Cout / 4
  int tiles_x;   // tiles along W
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

// Where output channel co of pixel (oy, ox) of image n is stored.
__device__ __forceinline__ size_t out_index(const Args& a, int n, int oy,
                                            int ox, int co) {
  if (a.flags & D2S) {
    const int g = co / a.D, f = co - g * a.D;
    return (((size_t)n * 2 * a.H + 2 * oy + (g >> 1)) * 2 * a.W + 2 * ox +
            (g & 1)) * a.D + f;
  }
  return (((size_t)n * a.H + oy) * a.W + ox) * a.Cout + co;
}

__global__ void __launch_bounds__(THREADS)
conv3x3_head_f32_kernel(const Args a) {
  constexpr int T = 9;
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
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
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
      for (int i = tid; i < (TH + 2) * PW * 2; i += nt) {
        const int q = i & 1, px = (i >> 1) % PW, py = (i >> 1) / PW;
        const int iy = ty0 - 1 + py, ix = tx0 - 1 + px;
        const int ci = c0 + 4 * q;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin;
        const float* src = ok ? xn + ((size_t)iy * W + ix) * Cin + ci : a.x;
        nesr::cp_async_zfill<16>(sx + py * PRS + px * CC + 4 * q, src,
                                 ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < (TH + 2) * PW * CC; i += nt) {
        const int ci = i % CC, px = (i / CC) % PW, py = i / (CC * PW);
        const int iy = ty0 - 1 + py, ix = tx0 - 1 + px;
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
    // Rolled over (quad, ky): the 768-FFMA body stays in the instruction
    // cache.
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
        float4 in[10];
#pragma unroll
        for (int t = 0; t < 10; ++t)
          in[t] = *reinterpret_cast<const float4*>(sx + ky * PRS + t * CC +
                                                   4 * q);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* wp = sw + ((ky * 3 + kx) * CC + 4 * q + ch) * a.ws;
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
  if (oy >= H || cb >= Cout) return;
  float bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    bv[c] = a.bias != nullptr && cb + c < Cout ? a.bias[cb + c] : 0.f;
  // 8 channels in one piece: one group of D % 8 == 0 channels under D2S.
  const bool whole = !(a.flags & D2S) || a.D % 8 == 0;
  const bool vec_y = a.vec_y && (Cout & 3) == 0 && cb + 8 <= Cout && whole;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int ox = tx0 + 8 * half + t;
    if (ox >= W) break;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = acc[t][c] + bv[c];
      if (a.flags & LRELU) v[c] = nesr::lrelu(v[c]);
    }
    if (vec_y) {
      float* yp = a.y + out_index(a, n, oy, ox, cb);
      *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(yp + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (cb + c < Cout) a.y[out_index(a, n, oy, ox, cb + c)] = v[c];
    }
  }
}

}  // namespace

// x (N, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,) or null, y (N, H, W,
// Cout) or, under D2S, (N, 2H, 2W, Cout / 4), all float32 and contiguous
// (kernels/conv3x3.py checks); a y that is not 16-byte aligned is
// stored a float at a time. flags: LRELU 1, ROUND_FIRST 2 (moot), D2S 8
// (Cout % 4 == 0).
extern "C" int nesr_conv3x3_head_f32(const void* x, const void* w,
                                     const void* bias, void* y, int N, int H,
                                     int W, int Cin, int Cout, int flags,
                                     void* stream) {
  if ((flags & ~(LRELU | ROUND_FIRST | D2S)) || ((flags & D2S) && Cout % 4) ||
      N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1)
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
  a.D = Cout / 4;
  a.G = (gran + groups - 1) / groups;
  // 384 threads (2 segments a row x G granules), at most MAX_ROWS rows
  const int rows = min(MAX_ROWS, max(1, THREADS / 2 / a.G));
  a.S = 2 * rows;
  a.tiles_x = (W + TW - 1) / TW;
  a.vec_x = Cin % 4 == 0 && ((uintptr_t)x & 15) == 0;
  a.vec_w = Cin % 4 == 0 && Cout % 4 == 0 && ((uintptr_t)w & 15) == 0;
  a.vec_y = ((uintptr_t)y & 15) == 0;
  a.ws = a.vec_w && groups == 1 ? Cout : 8 * a.G;
  // weights, then the patch; a stage is a whole number of 128 bytes
  a.stage = (9 * CC * a.ws + (rows + 2) * PRS + 31) / 32 * 32;
  const int smem = BARS + 2 * a.stage * 4;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_head_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + rows - 1) / rows;
  dim3 grid(a.tiles_x * tiles_y, groups, N);
  conv3x3_head_f32_kernel<<<grid, a.S * a.G, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
