// The float32 RDB step (rdb_f32_step_kernel): one conv of the fused
// trunk's residual dense block in float32 (the parity mode) with its share
// of the dense-block assembly in the epilogue. Five launches (k = 0..4)
// make one RDB; each RRDB's residual folds into its third RDB's step 4.
//
// Replaces no Pallas kernel: the JAX package's _rdb_fused
// (models/rrdbnet.py:167) runs XLA's bias-free convs with their assembly;
// in bf16 the K1 step (csrc/rdb_bf16.cu) computes it, and this is its
// float32 form. It equals FusedRDB._composition (five K1f convs with the
// assembly in PyTorch between them) bit for bit: the conv is K1f's
// mainloop (csrc/conv3x3_f32_body.cuh) on K1f's geometry, so each sum
// takes the same FMAs in the same order, and the epilogue rounds where
// PyTorch's CUDA ops round.
//
// Layout: NHWC float32 activations, HWIO weights (3, 3, Cin, Cout) from
// models/rrdbnet.fuse_rdb (Cout 4g + nf, 3g + nf, 2g + nf, g + nf, nf).
// The slots are one (N, H, W, 4g + nf) buffer laid out as conv 0's
// output: conv k's channel j is slot channel k g + j. Step k's epilogue,
// per output channel j (c = the conv's value as K1f stores it without a
// bias, acc + 0, which turns -0 into +0):
//   k = 0:     j < g: x_1[j] = lrelu(c + b[j]);  j >= g: slots[j] = c
//   k = 1..3:  j < g: x_{k+1}[j] = lrelu((slots[kg + j] + c) + b[kg + j])
//              j >= g: slots[kg + j] += c (in place: each pixel and slot
//              channel is read and written by its own thread, no halo)
//   k = 4:     t = (slots[4g + j] + c) + b[4g + j], out = x + 0.2 t, and
//              with skip (the RRDB input) skip + 0.2 out.
// Each op rounds once (__fadd_rn / __fmul_rn: nvcc would contract
// x + 0.2 t into one FFMA where PyTorch rounds the product first).
// x_{k+1} goes to a buffer other than x_k, whose halo other blocks read.
// Channels, not granules, are routed between x_{k+1} and the slots: a
// granule straddles both where g % 8 != 0. With g and nf multiples of 4
// and 16-byte aligned tensors the epilogue moves float4s (a 4-channel
// quad never straddles), loading before it stores, else single floats.
// Three instantiations, one an epilogue form: step 0, steps 1..3, step 4.
//
// What bounds it on an H100: the conv's operations, 2 x 9 x Cin x Cout a
// pixel against 67 TFLOP/s of float32 outside the tensor cores (TF32 would
// change the result); at 4 x 268^2, 0.948 ms at step 0 down to 0.158 at
// step 4, 2.055 an RDB. The assembly's bytes (x_k, the slots read and
// written, x_{k+1} or x, skip and out) take at most ~0.13 ms a step at
// 3.35 TB/s. The design is K1f's, with the assembly where K1f writes its
// output: the composition's dozen elementwise passes and their HBM round
// trips are gone.
#include "conv3x3_f32_body.cuh"

namespace {

struct Args : ConvF32Params {
  const float* bias;   // (4g + nf,)
  float* slots;        // (N, H, W, 4g + nf)
  float* xn;           // x_{k+1} (N, H, W, g), steps 0..3
  const float* xres;   // x, the RDB input (N, H, W, nf), step 4
  const float* skip;   // the RRDB input, step 4, or null
  float* out;          // (N, H, W, nf), step 4
  int k, g, cs;        // the step, the growth, the slots' channels
  int vec;             // float4 epilogue accesses
};

// The epilogue's three forms, compile-time: step 0 (no slot sums to
// read), steps 1..3, step 4 (x, skip and out); the launch picks one.
constexpr int FIRST = 0, MID = 1, LAST = 2;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float& at(float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Conv channel co's value from c (K1f's stored value of the bias-free
// conv), the bias b and the old slot sum s; at step 4 x and skip too.
// Where it goes: out (step 4), x_{k+1} (co < g) or the slots.
template <int KIND>
__device__ __forceinline__ float assemble(const Args& a, int co, float c,
                                          float b, float s, float x,
                                          float skip) {
  if (KIND == LAST) {
    const float t = __fadd_rn(__fadd_rn(s, c), b);
    const float y = __fadd_rn(x, __fmul_rn(0.2f, t));
    return a.skip != nullptr ? __fadd_rn(skip, __fmul_rn(0.2f, y)) : y;
  }
  const float sum = KIND == FIRST ? c : __fadd_rn(s, c);
  return co < a.g ? nesr::lrelu(__fadd_rn(sum, b)) : sum;
}

template <int KIND>
__device__ __forceinline__ float* destination(const Args& a, size_t pix,
                                              int co) {
  if (KIND == LAST) return a.out + pix * a.Cout + co;
  return co < a.g ? a.xn + pix * a.g + co
                  : a.slots + pix * a.cs + a.k * a.g + co;
}

// The float4 path (g, nf multiples of 4: a 4-channel quad is all x_{k+1},
// all slots or all out) for pixels t0 .. t0 + PX - 1 of the thread's
// segment: every load first (the old slot sums, at step 4 x and skip),
// then every store. The compiler cannot tell the loads' addresses from the
// stores', so a load after a store would wait for it, one round trip to
// memory a pixel and quad (+0.23-0.27 ms at steps 1 and 2 on 4 x 268^2
// on an H100).
template <int KIND, int PX>
__device__ __forceinline__ void assemble_px(const Args& a,
                                            const ConvF32Place& p, int oy,
                                            int cb, const float (&acc)[8][8],
                                            const float (&bv)[8], int t0) {
  // the old slot sums, x and skip (zeros where a form reads none: dead)
  float4 in[PX][2][3];
  size_t pix[PX];
  bool ok[PX][2];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int ox = p.tx0 + 8 * p.half + t0 + i;
    pix[i] = ((size_t)p.n * a.H + oy) * a.W + ox;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = cb + 4 * h;
      ok[i][h] = ox < a.W && co < a.Cout;
#pragma unroll
      for (int l = 0; l < 3; ++l)
        in[i][h][l] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!ok[i][h] || KIND == FIRST) continue;
      in[i][h][0] = ld4(a.slots + pix[i] * a.cs + a.k * a.g + co);
      if (KIND == LAST) {
        const size_t o = pix[i] * a.Cout + co;
        in[i][h][1] = ld4(a.xres + o);
        if (a.skip != nullptr) in[i][h][2] = ld4(a.skip + o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PX; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[i][h]) continue;
      const int co = cb + 4 * h;
      float4 y;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        at(y, j) = assemble<KIND>(
            a, co, __fadd_rn(acc[t0 + i][4 * h + j], 0.f), bv[4 * h + j],
            at(in[i][h][0], j), at(in[i][h][1], j), at(in[i][h][2], j));
      *reinterpret_cast<float4*>(destination<KIND>(a, pix[i], co)) = y;
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(MAX_THREADS)
rdb_f32_step_kernel(const Args a) {
  float acc[8][8];
  const ConvF32Place p = conv_f32_mainloop(a, acc);
  const int H = a.H, W = a.W, Cout = a.Cout;
  const int oy = p.ty0 + p.r, cb = p.co0 + 8 * p.gran;
  if (oy >= H || cb >= Cout) return;
  // The bias of conv channel co is b[k g + co] (for the slot channels it
  // is not used; k g + co < 4g + nf for every co < Cout).
  float bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    bv[c] = cb + c < Cout ? a.bias[a.k * a.g + cb + c] : 0.f;
  if (a.vec) {
    // Four pixels' loads at a time (two at step 4, which loads three
    // tensors), beside the 64 accumulators, within 168 registers.
    constexpr int PX = KIND == LAST ? 2 : 4;
#pragma unroll
    for (int t0 = 0; t0 < 8; t0 += PX)
      assemble_px<KIND, PX>(a, p, oy, cb, acc, bv, t0);
    return;
  }
  // One float at a time (g or nf not a multiple of 4, or a tensor not
  // 16-byte aligned): each channel's loads, then its store.
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int ox = p.tx0 + 8 * p.half + t;
    if (ox >= W) break;
    const size_t pix = ((size_t)p.n * H + oy) * W + ox;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int co = cb + c;
      if (co >= Cout) break;
      const size_t o = pix * Cout + co;
      const float s =
          KIND == FIRST ? 0.f : a.slots[pix * a.cs + a.k * a.g + co];
      const float x = KIND == LAST ? a.xres[o] : 0.f;
      const float skip =
          KIND == LAST && a.skip != nullptr ? a.skip[o] : 0.f;
      *destination<KIND>(a, pix, co) = assemble<KIND>(
          a, co, __fadd_rn(acc[t][c], 0.f), bv[c], s, x, skip);
    }
  }
}

template <int KIND>
int launch_step(const Args& a, const ConvF32Launch& l, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rdb_f32_step_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.smem);
  if (err != cudaSuccess) return (int)err;
  rdb_f32_step_kernel<KIND>
      <<<l.grid, l.threads, l.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Step k (0..4) of the float32 RDB. src (N, H, W, Cin): x at step 0, else
// x_k; w (3, 3, Cin, Cout) HWIO, Cout = cs - k g; bias (cs,); slots (N, H,
// W, cs), cs = 4g + nf, updated in place; xn (N, H, W, g) x_{k+1} at steps
// 0..3 (null at 4); at step 4 x and out (N, H, W, nf) and skip (or null).
// All float32 and contiguous (kernels/conv3x3_rdb.py checks).
extern "C" int nesr_rdb_f32_step(const void* src, const void* w,
                                 const void* bias, void* slots, void* xn,
                                 const void* x, const void* skip, void* out,
                                 int N, int H, int W, int Cin, int Cout,
                                 int k, int g, int cs, void* stream) {
  const int nf = cs - 4 * g;
  if (k < 0 || k > 4 || g < 1 || nf < 1 || Cout != cs - k * g
      || Cin != (k == 0 ? nf : g) || (k < 4) != (xn != nullptr)
      || (k == 4) != (x != nullptr && out != nullptr)
      || (skip != nullptr && k != 4))
    return (int)cudaErrorInvalidValue;
  Args a;
  const ConvF32Launch l = conv_f32_geometry(a, src, w, N, H, W, Cin, Cout);
  a.bias = (const float*)bias;
  a.slots = (float*)slots;
  a.xn = (float*)xn;
  a.xres = (const float*)x;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.k = k;
  a.g = g;
  a.cs = cs;
  a.vec = g % 4 == 0 && nf % 4 == 0 && aligned16(slots)
          && (xn == nullptr || aligned16(xn))
          && (x == nullptr || aligned16(x))
          && (skip == nullptr || aligned16(skip))
          && (out == nullptr || aligned16(out));
  return k == 0 ? launch_step<FIRST>(a, l, stream)
         : k < 4 ? launch_step<MID>(a, l, stream)
                 : launch_step<LAST>(a, l, stream);
}
