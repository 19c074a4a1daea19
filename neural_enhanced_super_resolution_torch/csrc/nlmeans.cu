// NL-means denoising (cv2.fastNlMeansDenoising[Colored]) in one launch.
//
// Replaces no Pallas kernel: the JAX package computes NL-means in XLA
// (neural_enhanced_super_resolution_tpu/ops/nlmeans.py:109
// _nl_means_lab_joint and :80 _nl_means_f32, a lax.scan over the 21
// search rows). Its plain PyTorch form (kernels/nlmeans.py,
// nl_means_fields_plain) takes about 14 large ops a search row, 628
// launches a call, each streaming a (B, 21, C, H + 6, W + 6) float32 stack
// through HBM.
//
// What it computes, for a (B, H, W, C <= 4) float32 NHWC batch, per pixel
// p and each of the 441 offsets o of the 21x21 search window: the 7x7 box
// sum d_f of the squared differences E(p + t) - E(p + o + t) over the
// channels of each weight field f, dist = d_f / area_f, the weight
// w = exp(max(dist - 2 sigma^2, 0) * (-1 / h_f^2)), and per channel the
// sums num += w_f E(p + o), den_f += w_f; out = num / den. E reads the
// image with reflect-101 borders (numpy "reflect"), by the periodic index
// of ops/pad.py, so an image narrower than the 13-pixel reach reflects
// repeatedly. Two field layouts (template parameter MODE):
//   ONE: one field over all C channels, area 49 C, with the sigma clamp
//        (_nl_means_f32);
//   LAB: C = 3, L with h (area 49), (a, b) jointly with h_color (area 98),
//        no clamp (_nl_means_lab_joint).
// The weight keeps the plain version's operations in its order: the
// division by the area (correctly rounded, as the IEEE division; see
// div_area), the clamp, the product with -1/h^2 (float32, from
// the wrapper), expf; num adds the rounded product w * E (no FMA). For
// uint8-valued data every box sum is an integer below 2^24 (the largest,
// the (a, b) field's, 98 x 255^2), exact in float32 in any order, so the
// weights equal the plain version's up to expf's last bit; the offsets
// are added one at a time, row-major, as the JAX package adds them (the
// plain version sums a search row's 21 first).
//
// What bounds it on an H100: arithmetic. About 45 float32 operations a
// pixel and offset (the joint pass), 2.80 ms at 67 TFLOP/s on a 32 x 544^2
// tile chunk, against 0.07 ms of bytes (each input read once, each output
// written once); its two exps a pixel and offset take ~2.0 ms of the SFUs
// (16 a clock an SM).
//
// Design (a simple one): a block of four warps owns 26 output columns x 32
// output rows of one image, and first copies the reflected patch with its
// 13-pixel reach ((26 + 26) x (32 + 26) pixels, planar float32, 12 KB a
// channel) into shared memory; nothing else of the image is read. A lane
// owns one column, a warp 8 rows of it. For each offset, in order, a lane
// computes the squared differences of its column at the 14 rows its 8
// outputs' templates cover (its own 14 centre pixels stay in registers for
// the whole search; the shifted pixels come from shared memory, lanes on
// consecutive words), sums 7 of them down the column (once in full, then
// running: add the row entering, subtract the row leaving), and the
// 7-wide row sum takes four shuffles a field across the warp's lanes, so
// lanes 3..28 hold whole templates: 26 outputs a warp. Weights, num and
// den for the lane's 8 pixels stay in registers over all 441 offsets;
// each output is written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPL = 7;                   // template (patch) size
constexpr int SRCH = 21;                 // search window size
constexpr int TR = TPL / 2;              // 3
constexpr int SR = SRCH / 2;             // 10
constexpr int REACH = TR + SR;           // 13
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RH = 8;                    // output rows a warp
constexpr int DR = RH + 2 * TR;          // 14 rows of differences a lane
constexpr int TW = 32 - 2 * TR;          // 26 output columns a block
constexpr int TH = RH * WARPS;           // 32 output rows a block
constexpr int EXT_W = TW + 2 * REACH;    // 52
constexpr int EXT_H = TH + 2 * REACH;    // 58
constexpr unsigned FULL = 0xffffffffu;

enum { ONE = 0, LAB = 1 };

struct Params {
  const float* x;     // (B, H, W, C) float32
  float* out;         // (B, H, W, C) float32
  int H, W;
  float neg_inv0;     // -1 / h^2 of field 0
  float neg_inv1;     // -1 / h_color^2 of field 1 (LAB)
  float two_sigma2;   // 2 sigma^2 (ONE)
};

// numpy's "reflect" (BORDER_REFLECT_101) source index of i on an axis of
// n: periodic with period 2 (n - 1), as ops/pad.py:reflect_index.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

// d / a rounded to nearest, for d >= 0 and a the area (49 C or 98), with
// r = RN(1 / a): q = RN(d r) is within an ulp of d / a, the remainder
// d - q a is exact in float32 (an FMA), and q + (d - q a) r rounded is
// RN(d / a) (Markstein's theorem). It equals the IEEE division the plain
// version takes (checked for every integer d below 2^24 and a of 49, 98,
// 147 and 196), in three instructions without a branch.
__device__ __forceinline__ float div_area(float d, float a, float r) {
  const float q = __fmul_rn(d, r);
  return __fmaf_rn(__fmaf_rn(-q, a, d), r, q);
}

// The 7-wide sum centred on each lane, [l - 3, l + 3]: whole for lanes
// 3..28.
__device__ __forceinline__ float row_sum7(float v) {
  const float a = v + __shfl_down_sync(FULL, v, 1);         // [l, l + 1]
  const float b = a + __shfl_up_sync(FULL, a, 2);           // [l - 2, l + 1]
  return (b + __shfl_up_sync(FULL, v, 3))                   // + l - 3
         + __shfl_down_sync(FULL, a, 2);                    // + [l + 2, l + 3]
}

template <int MODE, int C>
__global__ void __launch_bounds__(THREADS)
nlmeans_kernel(const Params p) {
  constexpr int NF = MODE == LAB ? 2 : 1;     // weight fields
  extern __shared__ float tile[];             // [C][EXT_H][EXT_W]
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  // The reflected patch of the block's outputs with their reach.
  const float* src = p.x + (size_t)b * p.H * p.W * C;
  for (int i = threadIdx.x; i < EXT_H * EXT_W; i += THREADS) {
    const int ry = i / EXT_W, rx = i - ry * EXT_W;
    const int sy = reflect101(y0 - REACH + ry, p.H);
    const int sx = reflect101(x0 - REACH + rx, p.W);
    const float* px = src + ((size_t)sy * p.W + sx) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) tile[(c * EXT_H + ry) * EXT_W + rx] = px[c];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RH;     // the warp's first output row
  // Difference row i (0..13) is image row y0 + r0 - 3 + i, the lane's
  // column x0 - 3 + lane: in the patch, row r0 + SR + i, column lane + SR.
  float ctr[DR][C];
#pragma unroll
  for (int i = 0; i < DR; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
      ctr[i][c] = tile[(c * EXT_H + r0 + SR + i) * EXT_W + lane + SR];

  float num[RH][C], den[RH][NF];
#pragma unroll
  for (int r = 0; r < RH; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) num[r][c] = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) den[r][f] = 0.f;
  }
  constexpr float area0 = MODE == LAB ? TPL * TPL : TPL * TPL * C;
  constexpr float area1 = TPL * TPL * 2;
  constexpr float rcp0 = 1.f / area0, rcp1 = 1.f / area1;   // RN(1 / a)

  for (int dy = 0; dy < SRCH; ++dy) {
    for (int dx = 0; dx < SRCH; ++dx) {
      // Offset (dy - 10, dx - 10): the shifted pixel of difference row i
      // is patch row r0 + dy + i, column lane + dx.
      const float* sh = tile + (r0 + dy) * EXT_W + lane + dx;
      float d[NF][DR];
      float val[RH][C];   // the shifted pixels at the lane's outputs
#pragma unroll
      for (int i = 0; i < DR; ++i) {
        float s[C];
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = sh[(c * EXT_H + i) * EXT_W];
        if constexpr (MODE == LAB) {
          const float e0 = ctr[i][0] - s[0], e1 = ctr[i][1] - s[1],
                      e2 = ctr[i][2] - s[2];
          d[0][i] = e0 * e0;
          d[NF - 1][i] = e1 * e1 + e2 * e2;
        } else {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float e = ctr[i][c] - s[c];
            acc += e * e;
          }
          d[0][i] = acc;
        }
        if (i >= TR && i < TR + RH)
#pragma unroll
          for (int c = 0; c < C; ++c) val[i - TR][c] = s[c];
      }
      float col[NF];   // the 7-row column sums of the current output row
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        col[f] = d[f][0];
#pragma unroll
        for (int i = 1; i < TPL; ++i) col[f] += d[f][i];
      }
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        if (r > 0) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            col[f] = (col[f] + d[f][r + TPL - 1]) - d[f][r - 1];
        }
        float w[NF];
        {
          const float dist = div_area(row_sum7(col[0]), area0, rcp0);
          const float t =
              MODE == LAB ? dist : fmaxf(__fsub_rn(dist, p.two_sigma2), 0.f);
          w[0] = expf(__fmul_rn(t, p.neg_inv0));
        }
        if constexpr (MODE == LAB) {
          const float dist = div_area(row_sum7(col[NF - 1]), area1, rcp1);
          w[NF - 1] = expf(__fmul_rn(dist, p.neg_inv1));
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) den[r][f] = __fadd_rn(den[r][f], w[f]);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float wc = w[(MODE == LAB && c > 0) ? NF - 1 : 0];
          num[r][c] = __fadd_rn(num[r][c], __fmul_rn(wc, val[r][c]));
        }
      }
    }
  }

  const int ox = x0 + lane - TR;
  if (lane < TR || lane >= 32 - TR || ox >= p.W) return;
  float* dst = p.out + (size_t)b * p.H * p.W * C;
#pragma unroll
  for (int r = 0; r < RH; ++r) {
    const int oy = y0 + r0 + r;
    if (oy < p.H) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[((size_t)oy * p.W + ox) * C + c] = __fdiv_rn(
            num[r][c], den[r][(MODE == LAB && c > 0) ? NF - 1 : 0]);
    }
  }
}

template <int MODE, int C>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  const dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, B);
  const size_t smem = sizeof(float) * C * EXT_H * EXT_W;   // <= 48,256 B
  nlmeans_kernel<MODE, C><<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// NL-means of x (B, H, W, C) float32 NHWC into out (the same shape).
// mode 0: one field over the C (1..4) channels with h (neg_inv0 = -1/h^2)
// and the clamp at two_sigma2; mode 1: the Lab joint pass, C = 3, L with
// neg_inv0 and (a, b) with neg_inv1. 7x7 template, 21x21 search. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// layout it does not take (the wrapper refuses those first).
extern "C" int nesr_nl_means(const void* x, void* out, int B, int H, int W,
                             int C, int mode, float neg_inv0, float neg_inv1,
                             float two_sigma2, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (H + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(x), static_cast<float*>(out), H, W,
           neg_inv0, neg_inv1, two_sigma2};
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == LAB) {
    if (C != 3) return (int)cudaErrorInvalidValue;
    return (int)launch<LAB, 3>(p, B, s);
  }
  if (mode != ONE) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: return (int)launch<ONE, 1>(p, B, s);
    case 2: return (int)launch<ONE, 2>(p, B, s);
    case 3: return (int)launch<ONE, 3>(p, B, s);
    case 4: return (int)launch<ONE, 4>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
