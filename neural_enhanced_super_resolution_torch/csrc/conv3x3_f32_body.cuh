// K1f's mainloop: the SAME 3x3 convolution on NHWC float32 on the CUDA
// cores, float32 weights HWIO (3, 3, Cin, Cout) (csrc/conv3x3_f32.cu: the
// conv with its bias and LeakyReLU in the epilogue). The float32 RDB step
// (csrc/rdb_f32.cu: a conv of the float32 RDB with its share of the
// dense-block assembly in the epilogue) runs the same mainloop on the same
// geometry, so every sum takes the same FMAs in the same order and its
// convs equal K1f's bit for bit.
//
// Design (what bounds it: the FFMA issue rate, see csrc/conv3x3_f32.cu):
//  * Register-blocked implicit GEMM. A block owns an output tile of 8R
//    rows x 16 columns and every output channel up to 192, in 8-channel
//    granules (Cout padded to 8, not more). A thread owns a row segment of
//    8 consecutive pixels x one granule: 64 accumulators. For each input
//    channel quad and ky it reads the segment's 10 input pixels once (10
//    LDS.128, 4 channels each) and uses them for all three kx taps and 4
//    channels; the weights come as float4 broadcasts (2 a tap and
//    channel): 34 LDS.128 for 768 FFMA. Cout above 192 runs its channel
//    groups on grid rows (each group stages the patch again).
//  * Threads: 16R segments (two a row) x G granules; R grows as G falls
//    below 8 (R = 8 / G), so a narrow conv still runs 80-128 threads.
//  * Asynchronous staging of the next pass. Input channels go in passes of
//    8. The patch of the next pass (the SAME halo, ragged edges and
//    channels past Cin zero-filled) comes by cp.async, 16 bytes (4
//    channels of a pixel) at a time, pixel-major with rows padded to an
//    odd number of 16-byte units, so the 16 segments of a load fall in
//    distinct bank groups. Its weights come by bulk copy: in HWIO the
//    slice [tap, c0:c0+8, :] is one contiguous run (a row of Cout values
//    per channel when Cout spans several groups). Both go into a two-stage
//    ring in dynamic shared memory and complete on the stage's mbarrier
//    (the cp.asyncs through cp.async.mbarrier.arrive), with one block
//    barrier a pass. A conv whose Cin or Cout is not a multiple of 4 (or
//    whose tensors are not 16-byte aligned) stages by 4-byte cp.async.
// The (quad, ky) loop is not unrolled: unrolled, the pass body was ~5000
// instructions and ran up to 1.6x slower.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CC = 8;                  // input channels a pass
constexpr int TW = 16;                 // output columns a tile (2 segments)
constexpr int MAX_GRAN = 24;           // granules a block: 192 channels
constexpr int MAX_THREADS = 16 * MAX_GRAN;
constexpr int BARS = 128;              // bytes before the ring: 2 mbarriers

// The 3 x 3 taps; patch columns with the halo, and the patch row in
// floats: two 16-byte units a pixel plus one, an odd number (37).
constexpr int KT = 3;
constexpr int PW = TW + KT - 1;
constexpr int PRS = PW * CC + 4;

// What the mainloop reads; each kernel's Args adds its epilogue's.
struct ConvF32Params {
  const float* x;
  const float* w;
  int H, W, Cin, Cout;
  int tiles_x;   // tiles along W
  int S, G;      // segments (16R) and granules a block
  int ws;        // floats between weight rows (Cout, or 8G)
  int stage;     // floats a ring stage: weights then patch
  int vec_x;     // patch by 16-byte cp.async (Cin % 4 == 0, aligned)
  int vec_w;     // weights by bulk copy (Cin, Cout % 4 == 0, aligned)
};

// The launch of a conv: grid (tiles, channel groups, N), threads S G and
// the dynamic shared memory of the two-stage ring.
struct ConvF32Launch {
  dim3 grid;
  int threads, smem;
};

// Fills the mainloop's geometry of an (N, H, W, Cin) -> Cout conv.
inline ConvF32Launch conv_f32_geometry(ConvF32Params& a, const void* x,
                                       const void* w, int N, int H, int W,
                                       int Cin, int Cout) {
  const int gran = (Cout + 7) / 8;
  const int groups = (gran + MAX_GRAN - 1) / MAX_GRAN;
  a.x = (const float*)x;
  a.w = (const float*)w;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.G = (gran + groups - 1) / groups;
  const int R = a.G >= 8 ? 1 : 8 / a.G;
  a.S = 16 * R;
  a.tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + 8 * R - 1) / (8 * R);
  a.vec_x = Cin % 4 == 0 && ((uintptr_t)x & 15) == 0;
  a.vec_w = Cin % 4 == 0 && Cout % 4 == 0 && ((uintptr_t)w & 15) == 0;
  a.ws = a.vec_w && groups == 1 ? Cout : 8 * a.G;
  // weights, then the patch; a stage is a whole number of 128 bytes
  a.stage = (KT * KT * CC * a.ws + (8 * R + KT - 1) * PRS + 31) /
            32 * 32;
  ConvF32Launch l;
  l.grid = dim3(a.tiles_x * tiles_y, groups, N);
  l.threads = a.S * a.G;
  l.smem = BARS + 2 * a.stage * 4;
  return l;
}

// A thread's share of the output: image n, the tile at (ty0, tx0), row r
// of it, segment half (columns 8 half .. 8 half + 7) and the granule of
// channels co0 + 8 gran ..
struct ConvF32Place {
  int n, co0, ty0, tx0, r, half, gran;
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

// The bias-free SAME 3x3 conv of the thread's 8 pixels x 8 channels (a
// (rows + 2) x 18 patch at offset -1) into acc[pixel][channel]; returns
// where they go.
__device__ __forceinline__ ConvF32Place conv_f32_mainloop(
    const ConvF32Params& a, float (&acc)[8][8]) {
  constexpr int T = KT * KT;
  const int pad = 1;
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
      for (int i = tid; i < (TH + KT - 1) * PW * 2; i += nt) {
        const int q = i & 1, px = (i >> 1) % PW, py = (i >> 1) / PW;
        const int iy = ty0 - pad + py, ix = tx0 - pad + px;
        const int ci = c0 + 4 * q;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin;
        const float* src = ok ? xn + ((size_t)iy * W + ix) * Cin + ci : a.x;
        nesr::cp_async_zfill<16>(sx + py * PRS + px * CC + 4 * q, src,
                                 ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < (TH + KT - 1) * PW * CC; i += nt) {
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
      for (int ky = 0; ky < KT; ++ky) {
        float4 in[8 + KT - 1];
#pragma unroll
        for (int t = 0; t < 8 + KT - 1; ++t)
          in[t] = *reinterpret_cast<const float4*>(sx + ky * PRS + t * CC +
                                                   4 * q);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
          for (int kx = 0; kx < KT; ++kx) {
            const float* wp = sw + ((ky * KT + kx) * CC + 4 * q + ch) * a.ws;
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
  return ConvF32Place{n, co0, ty0, tx0, r, half, gran};
}

}  // namespace
