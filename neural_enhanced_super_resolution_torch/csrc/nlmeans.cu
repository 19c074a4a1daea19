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
// channels of each weight field f, the weight w = exp(max(d_f / area_f -
// 2 sigma^2, 0) * (-1 / h_f^2)), and per channel the sums num += w_f E(p +
// o), den_f += w_f; out = num / den. E reads the image with reflect-101
// borders (numpy "reflect"), by the periodic index of ops/pad.py, so an
// image narrower than the 13-pixel reach reflects repeatedly. Two field
// layouts (template parameter MODE):
//   ONE: one field over all C channels, area 49 C, with the sigma clamp
//        (_nl_means_f32);
//   LAB: C = 3, L with h (area 49), (a, b) jointly with h_color (area 98),
//        no clamp (_nl_means_lab_joint).
// The weight folds the area division, -1/h^2 and log2(e) into one float32
// constant a field, k_f = RN(log2(e) (-1/h_f^2) / area_f) (the C entry
// computes it in double), and takes w = 2^(d_f k_f) by ex2.approx.ftz; in
// ONE the clamp is min(d k + b, 0) with b = RN(-2 sigma^2 area k) (an FMA).
// For uint8-valued data every box sum is an integer below 2^24 (the
// largest, the (a, b) field's, 98 x 255^2), exact in float32 in any order,
// so the exponent is within a few float32 roundings of the plain
// version's (tests/test_torch_nlmeans_kernel.py bounds it for every such
// integer); weights under 2^-126 flush to 0, beside a den of at least 1.
// num adds by FMA. The offsets are added one at a time, row-major, as the
// JAX package adds them (the plain version sums a search row's 21 first).
//
// What bounds it on an H100: arithmetic. About 45 float32 operations a
// pixel and offset (the joint pass), 2.80 ms at 67 TFLOP/s on a 32 x 544^2
// tile chunk, against 0.07 ms of bytes (each input read once, each output
// written once); its two exps a pixel and offset take ~2.0 ms of the SFUs
// (16 a clock an SM). What a design can do is issue few instructions a
// useful pixel and offset, and keep the shared-memory and shuffle pipe
// (32 lanes a clock an SM, a quarter of the issue rate) under them.
//
// Design: a block of four warps owns 58 output columns x 32 output rows of
// one image, and first copies the reflected patch with its 13-pixel reach
// ((64 + 20) x (32 + 26) pixels) into shared memory; nothing else of the
// image is read. A lane owns two adjacent columns (CPL), a warp 8 rows of
// them (RH). For each offset, in order, a lane computes the squared
// differences of its columns at the 14 rows its outputs' templates cover
// (its centre pixels stay in registers over the whole search; the shifted
// pixels come from shared memory, stored a float2 plane for channels 0-1
// and a float plane for channel 2, each with the even patch columns
// before the odd ones, so that a lane's two columns sit at consecutive
// words across the lanes at every offset: one LDS.64 and one LDS.32 a
// pixel, no bank conflict), sums 7 of them down each column (once in
// full, then running: add the row entering, subtract the row leaving),
// and the 7-wide row sums take four shuffles a field for the lane's two
// columns (s = c0 + c1; T = s(l - 1) + s(l) + s(l + 1); the even column
// adds c1(l - 2), the odd one c0(l + 2)), so 58 of a warp's 64 columns
// hold whole templates. Weights, num and den for the lane's 16 pixels
// stay in registers over all its offsets; each output is written once.
// A grid of few waves (a small image) splits the 21 search rows between
// the blocks of a thread-block cluster (choose_split): each sums its
// share of the offsets, and the first block adds the others' num and den
// from their shared memory (distributed shared memory), in block order,
// and writes the output.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TPL = 7;                   // template (patch) size
constexpr int SRCH = 21;                 // search window size
constexpr int TR = TPL / 2;              // 3
constexpr int SR = SRCH / 2;             // 10
constexpr int REACH = TR + SR;           // 13
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CPL = 2;                   // columns a lane
constexpr int RH = 8;                    // output rows a warp
constexpr bool CTR_REGS = true;          // centre pixels in registers
constexpr int DR = RH + 2 * TR;          // 14 rows of differences a lane
constexpr int WIN = 32 * CPL;            // 64 columns a warp's lanes own
constexpr int TW = WIN - 2 * TR;         // 58 output columns a block
constexpr int TH = RH * WARPS;           // 32 output rows a block
constexpr int EXT_W = WIN + 2 * SR;      // 84
constexpr int EXT_H = TH + 2 * REACH;    // 58
constexpr int PLANE = EXT_H * EXT_W;     // pixels of the patch
constexpr int HALF = EXT_W / CPL;        // patch columns of one residue
constexpr int MAX_SPLIT = 8;             // a portable cluster
constexpr unsigned FULL = 0xffffffffu;
static_assert(CPL == 2, "row_sums takes two columns a lane");
static_assert(EXT_W % CPL == 0, "the patch splits into whole residues");

enum { ONE = 0, LAB = 1 };

struct Params {
  const float* x;     // (B, H, W, C) float32
  float* out;         // (B, H, W, C) float32
  int H, W;
  int split;          // blocks of a cluster sharing one tile's offsets
  float k0;           // log2(e) * (-1 / h^2) / area of field 0
  float k1;           // the same of field 1 (LAB)
  float b0;           // ONE: -2 sigma^2 area k0, the clamp's offset
};

// numpy's "reflect" (BORDER_REFLECT_101) source index of i on an axis of
// n: periodic with period 2 (n - 1), as ops/pad.py:reflect_index.
__device__ __forceinline__ int reflect101(int i, int n) {
  if ((unsigned)i < (unsigned)n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

// Where patch column pc is stored: the columns of one residue mod CPL side
// by side, so lane l's column CPL l + j shifted by dx lies at (j + dx) %
// CPL * HALF + l + (j + dx) / CPL, consecutive across the lanes.
__device__ __forceinline__ int col_pos(int pc) {
  return (pc % CPL) * HALF + pc / CPL;
}

// A pixel's C channels at storage index `at`: channels 0-1 (and 2-3) from
// float2 planes, an odd last channel from a float plane.
template <int C>
__device__ __forceinline__ void load_px(const float* tile, int at,
                                        float (&v)[C]) {
  const float2* t2 = reinterpret_cast<const float2*>(tile);
#pragma unroll
  for (int q = 0; q < C / 2; ++q) {
    const float2 t = t2[q * PLANE + at];
    v[2 * q] = t.x;
    v[2 * q + 1] = t.y;
  }
  if constexpr (C % 2 == 1) v[C - 1] = tile[(C - 1) * PLANE + at];
}

template <int C>
__device__ __forceinline__ void store_px(float* tile, int at,
                                         const float (&v)[C]) {
  float2* t2 = reinterpret_cast<float2*>(tile);
#pragma unroll
  for (int q = 0; q < C / 2; ++q)
    t2[q * PLANE + at] = make_float2(v[2 * q], v[2 * q + 1]);
  if constexpr (C % 2 == 1) tile[(C - 1) * PLANE + at] = v[C - 1];
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The 7-wide sums of a row at the lane's two columns from their 7-row
// column sums v (four shuffles): whole where the template lies in the
// warp's window (columns 3 .. WIN - 4).
__device__ __forceinline__ void row_sums(const float (&v)[CPL],
                                         float (&out)[CPL]) {
  const float s = v[0] + v[1];
  const float t = (s + __shfl_up_sync(FULL, s, 1))
                  + __shfl_down_sync(FULL, s, 1);   // columns 2l-2 .. 2l+3
  out[0] = t + __shfl_up_sync(FULL, v[1], 2);       // + 2l - 3
  out[1] = t + __shfl_down_sync(FULL, v[0], 2);     // + 2l + 4
}

template <int MODE, int C>
__global__ void __launch_bounds__(THREADS)
nlmeans_kernel(const Params p) {
  constexpr int NF = MODE == LAB ? 2 : 1;     // weight fields
  // Four channels' centre pixels would not leave registers for the rest.
  constexpr bool ctr_regs = CTR_REGS && C <= 3;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int split = p.split;
  const int b = blockIdx.z / split, rank = blockIdx.z - b * split;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  // The reflected patch: patch row pr, column pc is image row y0 - 13 +
  // pr, column x0 - 13 + pc.
  const float* src = p.x + (size_t)b * p.H * p.W * C;
  for (int i = threadIdx.x; i < PLANE; i += THREADS) {
    const int pr = i / EXT_W, pc = i - pr * EXT_W;
    const int sy = reflect101(y0 - REACH + pr, p.H);
    const int sx = reflect101(x0 - REACH + pc, p.W);
    const float* px = src + ((size_t)sy * p.W + sx) * C;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(px + c);
    store_px<C>(tile, pr * EXT_W + col_pos(pc), v);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RH;     // the warp's first output row
  // Difference row i (0..13) is image row y0 + r0 - 3 + i; the lane's
  // column j is window column CPL lane + j, image column x0 - 3 + CPL lane
  // + j. Its centre pixel is patch row r0 + SR + i, column CPL lane + j +
  // SR; at offset (dy - 10, dx - 10) its shifted pixel is patch row r0 + dy
  // + i, column CPL lane + j + dx.
  float ctr[ctr_regs ? DR : 1][CPL][C];
  if constexpr (ctr_regs) {
#pragma unroll
    for (int i = 0; i < DR; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        load_px<C>(tile, (r0 + SR + i) * EXT_W + col_pos(CPL * lane + j + SR),
                   ctr[i][j]);
  }

  float num[RH][CPL][C], den[RH][CPL][NF];
#pragma unroll
  for (int r = 0; r < RH; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) num[r][j][c] = 0.f;
#pragma unroll
      for (int f = 0; f < NF; ++f) den[r][j][f] = 0.f;
    }

  // The block's share of the search rows.
  const int dy0 = SRCH * rank / split, dy1 = SRCH * (rank + 1) / split;
#pragma unroll 1
  for (int dy = dy0; dy < dy1; ++dy) {
    // Two offsets a trip: the second's loads and differences overlap the
    // first's sums (3.5% less time than one a trip on an H100 at the 32 x
    // 544^2 chunk; three a trip spill; tools/nlmeans_ablation.py).
#pragma unroll 2
    for (int dx = 0; dx < SRCH; ++dx) {
      int at[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        at[j] = (r0 + dy) * EXT_W + col_pos(CPL * lane + j + dx);
      float d[NF][DR][CPL];
      float val[RH][CPL][C];   // the shifted pixels at the lane's outputs
#pragma unroll
      for (int i = 0; i < DR; ++i) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float s[C], e[C];
          load_px<C>(tile, at[j] + i * EXT_W, s);
          if constexpr (ctr_regs) {
#pragma unroll
            for (int c = 0; c < C; ++c) e[c] = ctr[i][j][c] - s[c];
          } else {
            float q[C];
            load_px<C>(tile, (r0 + SR + i) * EXT_W
                                 + col_pos(CPL * lane + j + SR), q);
#pragma unroll
            for (int c = 0; c < C; ++c) e[c] = q[c] - s[c];
          }
          if constexpr (MODE == LAB) {
            d[0][i][j] = e[0] * e[0];
            d[NF - 1][i][j] = fmaf(e[2], e[2], e[1] * e[1]);
          } else {
            float acc = e[0] * e[0];
#pragma unroll
            for (int c = 1; c < C; ++c) acc = fmaf(e[c], e[c], acc);
            d[0][i][j] = acc;
          }
          if (i >= TR && i < TR + RH)
#pragma unroll
            for (int c = 0; c < C; ++c) val[i - TR][j][c] = s[c];
        }
      }
      float col[NF][CPL];   // the 7-row column sums of the current row
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          col[f][j] = d[f][0][j];
#pragma unroll
          for (int i = 1; i < TPL; ++i) col[f][j] += d[f][i][j];
        }
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        if (r > 0) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int j = 0; j < CPL; ++j)
              col[f][j] = (col[f][j] + d[f][r + TPL - 1][j]) - d[f][r - 1][j];
        }
        float w[NF][CPL];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          float sum[CPL];
          row_sums(col[f], sum);
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            w[f][j] = MODE == LAB
                          ? ex2(sum[j] * (f == 0 ? p.k0 : p.k1))
                          : ex2(fminf(fmaf(sum[j], p.k0, p.b0), 0.f));
        }
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
#pragma unroll
          for (int f = 0; f < NF; ++f) den[r][j][f] += w[f][j];
#pragma unroll
          for (int c = 0; c < C; ++c)
            num[r][j][c] = fmaf(w[(MODE == LAB && c > 0) ? NF - 1 : 0][j],
                                val[r][j][c], num[r][j][c]);
        }
      }
    }
  }

  if (split > 1) {
    // The cluster's blocks hold the same pixels' sums over their shares of
    // the offsets: the others leave theirs in shared memory (over the
    // patch), and block 0 adds them in block order.
    cg::cluster_group cluster = cg::this_cluster();
    float* part = tile;
    if (rank > 0) {
      __syncthreads();   // every warp is done with the patch
      int k = 0;
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            part[(k++) * THREADS + threadIdx.x] = num[r][j][c];
#pragma unroll
          for (int f = 0; f < NF; ++f)
            part[(k++) * THREADS + threadIdx.x] = den[r][j][f];
        }
    }
    cluster.sync();
    if (rank == 0) {
#pragma unroll 1
      for (int q = 1; q < split; ++q) {
        const float* rem = cluster.map_shared_rank(part, q);
        int k = 0;
#pragma unroll
        for (int r = 0; r < RH; ++r)
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              num[r][j][c] += rem[(k++) * THREADS + threadIdx.x];
#pragma unroll
            for (int f = 0; f < NF; ++f)
              den[r][j][f] += rem[(k++) * THREADS + threadIdx.x];
          }
      }
    }
    cluster.sync();   // the others' shared memory stays until it is read
    if (rank > 0) return;
  }

  float* dst = p.out + (size_t)b * p.H * p.W * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int wc = CPL * lane + j;
    const int ox = x0 - TR + wc;
    if (wc < TR || wc >= WIN - TR || ox >= p.W) continue;
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const int oy = y0 + r0 + r;
      if (oy < p.H) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          dst[((size_t)oy * p.W + ox) * C + c] = __fdiv_rn(
              num[r][j][c], den[r][j][(MODE == LAB && c > 0) ? NF - 1 : 0]);
      }
    }
  }
}

template <int MODE, int C>
constexpr int smem_bytes() {
  constexpr int NF = MODE == LAB ? 2 : 1;
  constexpr int patch = 4 * C * PLANE;
  constexpr int part = 4 * RH * CPL * (C + NF) * THREADS;
  return patch > part ? patch : part;
}

// Blocks of a cluster that split one tile's search rows, for a grid of
// `blocks` tiles on `slots` resident blocks: as many as fill the slots
// while the grid is under one wave, else one (a split adds a patch copy
// and the reduction to every tile: on an H100 at 4 x 544^2, 2.6 waves,
// a split of three was 9% slower than none; tools/nlmeans_ablation.py).
int choose_split(long long blocks, int slots, int B) {
  if (blocks >= slots) return 1;
  long long s = slots / blocks;
  if (s > MAX_SPLIT) s = MAX_SPLIT;
  while (s > 1 && (long long)B * s > 65535) --s;
  return (int)s;
}

template <int MODE, int C>
cudaError_t launch(Params p, int B, cudaStream_t s) {
  const auto kernel = nlmeans_kernel<MODE, C>;
  constexpr int smem = smem_bytes<MODE, C>();
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return err;
  const dim3 tiles((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, B);
  p.split = choose_split((long long)tiles.x * tiles.y * B,
                         sms * (per_sm > 0 ? per_sm : 1), B);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles.x, tiles.y, B * p.split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.split;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
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
  // log2(e) / area folded into -1/h^2 (double, rounded once to float32).
  const double log2e = 1.4426950408889634;
  const double area0 = mode == LAB ? TPL * TPL : TPL * TPL * C;
  const double area1 = TPL * TPL * 2;
  Params p{static_cast<const float*>(x), static_cast<float*>(out), H, W, 1,
           0.f, 0.f, 0.f};
  p.k0 = (float)((double)neg_inv0 * log2e / area0);
  p.k1 = (float)((double)neg_inv1 * log2e / area1);
  p.b0 = (float)(-(double)two_sigma2 * area0 * (double)p.k0);
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
