// K1f: K1's float32 form. SAME 3x3 convolution, NHWC float32 in and out,
// float32 weights HWIO (3, 3, Cin, Cout), an optional float32 bias and an
// optional LeakyReLU(0.2) in the epilogue, all in float32 on the CUDA
// cores. ``precision: "float32"`` (the JAX package's parity mode) runs it
// wherever bf16 runs K1.
//
// Replaces the JAX package's conv Pallas kernels on float32 operands:
// kernels/conv3x3.py:conv3x3_lrelu keeps its operands' dtype, so in float32
// it computes this function (K1 takes the same kernels' bf16 form).
//
// What bounds it on an H100: its operations, 2 x 9 x Cin x Cout a pixel
// against 67 TFLOP/s of float32 outside the tensor cores; its bytes (the
// float32 activations in and out) are a few percent of that at the trunk's
// widths. The design is the plain one, right first:
//  * A block (8 warps) owns an 8 x 16-pixel output tile and 64 output
//    channels; warp w accumulates channels 8w..8w+7 of all 128 pixels, four
//    pixels a lane, 32 float32 accumulators a thread.
//  * Input channels go in passes of 16: the 10 x 18-pixel patch (SAME halo
//    and the ragged edge zero-filled) is stored channel-major, so the
//    lanes of a warp read neighbouring pixels of one channel; the pass's
//    weights are stored [channel][tap][64 outputs], so a warp reads its
//    eight outputs' weights as two broadcast float4 loads.
//  * Both fit the 48 KB of static shared memory; the epilogue adds the
//    bias, applies LeakyReLU and writes float32.
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8, TW = 16;          // output tile: 8 rows x 16 columns
constexpr int PH = TH + 2, PW = TW + 2;  // the patch with its 1-px halo
constexpr int CC = 16;                   // input channels a pass
constexpr int CO = 64;                   // output channels a block
constexpr int THREADS = 256;             // warp w: outputs 8w..8w+7
constexpr int PIX = TH * TW / 32;        // pixels a lane

__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int H, int W, int Cin, int Cout, int lrelu, int tiles_x) {
  __shared__ float s_in[CC][PH * PW];
  __shared__ __align__(16) float s_w[CC][9][CO];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z, co0 = blockIdx.y * CO;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const float* xn = x + (size_t)n * H * W * Cin;

  float acc[PIX][8];
#pragma unroll
  for (int j = 0; j < PIX; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    for (int i = tid; i < PH * PW * CC; i += THREADS) {
      const int ci = i % CC, p = i / CC;
      const int iy = ty0 - 1 + p / PW, ix = tx0 - 1 + p % PW;
      float v = 0.f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W && c0 + ci < Cin)
        v = xn[((size_t)iy * W + ix) * Cin + c0 + ci];
      s_in[ci][p] = v;
    }
    for (int i = tid; i < CC * 9 * CO; i += THREADS) {
      const int co = i % CO, tap = (i / CO) % 9, ci = i / (CO * 9);
      float v = 0.f;
      if (c0 + ci < Cin && co0 + co < Cout)
        v = w[((size_t)tap * Cin + c0 + ci) * Cout + co0 + co];
      s_w[ci][tap][co] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CC; ++ci) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4 wa =
            *reinterpret_cast<const float4*>(&s_w[ci][tap][warp * 8]);
        const float4 wb =
            *reinterpret_cast<const float4*>(&s_w[ci][tap][warp * 8 + 4]);
        const int ky = tap / 3, kx = tap % 3;
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          const int p = lane + 32 * j;
          const float v = s_in[ci][(p / TW + ky) * PW + p % TW + kx];
          acc[j][0] += v * wa.x;
          acc[j][1] += v * wa.y;
          acc[j][2] += v * wa.z;
          acc[j][3] += v * wa.w;
          acc[j][4] += v * wb.x;
          acc[j][5] += v * wb.y;
          acc[j][6] += v * wb.z;
          acc[j][7] += v * wb.w;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int p = lane + 32 * j;
    const int oy = ty0 + p / TW, ox = tx0 + p % TW;
    if (oy >= H || ox >= W) continue;
    float* yp = y + (((size_t)n * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int co = co0 + warp * 8 + c;
      if (co >= Cout) break;
      float v = acc[j][c] + (bias != nullptr ? bias[co] : 0.f);
      if (lrelu) v = v >= 0.f ? v : 0.2f * v;
      yp[co] = v;
    }
  }
}

}  // namespace

extern "C" int nesr_conv3x3_f32(const void* x, const void* w,
                                const void* bias, void* y, int N, int H,
                                int W, int Cin, int Cout, int lrelu,
                                void* stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, (Cout + CO - 1) / CO, N);
  conv3x3_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y, H, W,
      Cin, Cout, lrelu, tiles_x);
  return (int)cudaGetLastError();
}
