// K1: fused SAME 3x3 convolution, NHWC bf16 in, fp32 accumulate, bf16 out,
// with an optional fp32 bias and an optional LeakyReLU(0.2) in the epilogue.
//
// Replaces the three conv Pallas kernels of the JAX package:
//   kernels/conv3x3.py:_kernel      (conv3x3_lrelu, im2col GEMM K = 9*Cin)
//   kernels/conv3x3_v2.py:_kernel   (conv3x3_lrelu_v2, same math)
//   kernels/rdb_pallas.py:_conv_kernel (rows_s2d_conv3x3, bias-free, bf16
//                                    out; the fused RDB trunk's five convs)
// The rows-s2d layout and its 4/3 FLOP tax are TPU artifacts and are not
// ported: this kernel works on plain NHWC.
//
// What bounds it on an H100: the trunk convs (Cin 32/64, Cout 64..192) do
// 2*9*Cin FLOPs per output channel per pixel against 2*Cin bytes read, so
// with the 3x3 input reuse held in shared memory they sit above the bf16
// ridge (~295 FLOP/byte) and are tensor-core bound; with mma.sync the
// next limit is shared-memory bandwidth for the operand fetches. The design
// is an implicit GEMM: a block owns a 16x16-pixel output tile and 64 output
// channels, stages the input patch (1-px halo, 64 input channels per pass)
// and the three taps of one kernel row at a time in shared memory, every
// input byte read from device memory about once per block. Each of the
// eight warps owns two output rows (two 16-pixel M fragments) and all 64
// channels (eight n8 fragments), so one B fetch feeds two MMAs. Rows of
// both operands are padded by 16 bytes, which makes every ldmatrix phase
// bank-conflict free. SAME zero padding is done by bounds checks while the
// patch is staged, never by a padded copy. Any Cin and Cout work.
// Not yet: cp.async/TMA pipelining of the staging, and wgmma.
#include "common.cuh"

namespace {

constexpr int TH = 16;             // output rows per block, two per warp
constexpr int TW = 16;             // output cols per block = MMA M
constexpr int KC = 64;             // input channels per pass
constexpr int NC = 64;             // output channels per block
constexpr int NWARP = TH / 2;
constexpr int THREADS = NWARP * 32;
constexpr int PP = KC + 8;         // patch pixel pitch (elements)
constexpr int WP = NC + 8;         // weight row pitch (elements)
constexpr int PATCH_ELEMS = (TH + 2) * (TW + 2) * PP;
constexpr int W_ELEMS = 3 * KC * WP;   // the three taps of one kernel row
constexpr int SMEM_BYTES = (PATCH_ELEMS + W_ELEMS) * 2;

using nesr::bf16;

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ y,
               int H, int W, int Cin, int Cout, int lrelu, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* patch = reinterpret_cast<bf16*>(smem);
  bf16* wsm = patch + PATCH_ELEMS;

  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.x / tiles_x;
  const int n0 = blockIdx.y * NC;
  const int n = blockIdx.z;
  const int oy = ty * TH, ox = tx * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool w_vec = (Cout % 8) == 0;
  const bool x_vec = (Cin % 8) == 0;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    const int cc = min(KC, Cin - c0);
    const int kp = (cc + 15) / 16 * 16;
    __syncthreads();  // previous pass done with patch / wsm
    // Stage the input patch: (TH+2) x (TW+2) pixels x KC channels.
    for (int it = threadIdx.x; it < (TH + 2) * (TW + 2) * (KC / 8);
         it += THREADS) {
      const int g = it % (KC / 8);
      const int p = it / (KC / 8);
      const int py = p / (TW + 2), px = p % (TW + 2);
      const int gy = oy - 1 + py, gx = ox - 1 + px;
      bf16* dst = patch + p * PP + g * 8;
      const int valid = cc - g * 8;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && valid > 0) {
        const bf16* src =
            x + ((size_t)(n * H + gy) * W + gx) * Cin + c0 + g * 8;
        nesr::load8(dst, src, valid, x_vec);
      } else {
        nesr::zero8(dst);
      }
    }
    for (int ky = 0; ky < 3; ++ky) {
      if (ky > 0) __syncthreads();  // previous kernel row done with wsm
      // Stage the weights of taps (ky, 0..2): KC input x NC output channels.
      for (int it = threadIdx.x; it < 3 * KC * (NC / 8); it += THREADS) {
        const int j8 = (it % (NC / 8)) * 8;
        const int rest = it / (NC / 8);
        const int ci = rest % KC;
        const int kx = rest / KC;
        bf16* dst = wsm + (kx * KC + ci) * WP + j8;
        const int valid = Cout - (n0 + j8);
        if (ci < cc && valid > 0) {
          const bf16* src =
              w + ((size_t)(ky * 3 + kx) * Cin + c0 + ci) * Cout + n0 + j8;
          nesr::load8(dst, src, valid, w_vec);
        } else {
          nesr::zero8(dst);
        }
      }
      __syncthreads();
      for (int kx = 0; kx < 3; ++kx) {
        for (int k0 = 0; k0 < kp; k0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            nesr::ldsm_x4<false>(
                a[i], patch + ((2 * warp + i + ky) * (TW + 2) + kx) * PP + k0,
                PP);
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            if (n0 + nb * 16 < Cout) {
              uint32_t b[4];
              nesr::ldsm_x4<true>(b, wsm + (kx * KC + k0) * WP + nb * 16, WP);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                nesr::mma_bf16(acc[i][2 * nb], a[i], b[0], b[1]);
                nesr::mma_bf16(acc[i][2 * nb + 1], a[i], b[2], b[3]);
              }
            }
          }
        }
      }
    }
  }

  // Epilogue straight from the accumulators: pixel column g or g+8 of the
  // warp's row, channels 2t and 2t+1 of each n8 fragment.
  const int g = lane / 4, t = lane % 4;
  const bool pair_ok = (Cout % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = oy + 2 * warp + i;
    if (gy >= H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + j * 8 + 2 * t;
      if (co >= Cout) continue;
      const bool two = co + 1 < Cout;
      const float b0 = bias != nullptr ? bias[co] : 0.f;
      const float b1 = (bias != nullptr && two) ? bias[co + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = ox + g + 8 * h;
        if (gx >= W) continue;
        float v0 = acc[i][j][2 * h] + b0;
        float v1 = acc[i][j][2 * h + 1] + b1;
        if (lrelu) {
          v0 = nesr::lrelu(v0);
          v1 = nesr::lrelu(v1);
        }
        bf16* out = y + ((size_t)(n * H + gy) * W + gx) * Cout + co;
        if (two && pair_ok) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          out[0] = __float2bfloat16(v0);
          if (two) out[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace

extern "C" int nesr_conv3x3(const void* x, const void* w, const void* bias,
                            void* y, int N, int H, int W, int Cin, int Cout,
                            int lrelu, void* stream) {
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, (Cout + NC - 1) / NC, N);
  conv3x3_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)bias, (bf16*)y, H, W,
      Cin, Cout, lrelu, tiles_x);
  return (int)cudaGetLastError();
}
