// K1f: K1's float32 form. SAME 3x3 convolution, NHWC float32 in and out,
// float32 weights HWIO (3, 3, Cin, Cout), an optional float32 bias and an
// optional LeakyReLU(0.2) in the epilogue, all in float32 on the CUDA
// cores. ``precision: "float32"`` (the JAX package's parity mode) runs it
// wherever bf16 runs K1.
//
// Replaces the JAX package's conv Pallas kernels on float32 operands:
// kernels/conv3x3.py:106 conv3x3_lrelu keeps its operands' dtype, so in
// float32 it computes this function (K1 takes the same kernels' bf16 form).
//
// What bounds it on an H100: its operations, 2 x 9 x Cin x Cout a pixel
// against 67 TFLOP/s of float32 outside the tensor cores; its bytes (the
// float32 activations in and out) are a few percent of that at the trunk's
// widths. To near that rate the FFMAs must fill the issue slots, so loads
// and address arithmetic have to be rare, and no FMA should wait for a
// pass's data. The design (the mainloop in csrc/conv3x3_f32_body.cuh,
// which the float32 RDB step, csrc/rdb_f32.cu, shares):
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
//  * The epilogue adds the bias, applies LeakyReLU and writes float32.
// The (quad, ky) loop is not unrolled: unrolled, the pass body was ~5000
// instructions and ran up to 1.6x slower. What holds it back now
// (tools/f32_ablation.py, PERF.md): the FFMA issue rate itself, at 168
// registers and at most 12 warps an SM; the staging is 2-5% of the time
// at the trunk's and the 64->64 shapes.
// The folded RRDBNet head's forms have kernels of their own, on this
// design: the 3x3 form (csrc/conv3x3_head_f32.cu) and the 2x2 form
// (csrc/conv2x2_f32.cu).
#include "conv3x3_f32_body.cuh"

namespace {

constexpr int LRELU = 1;   // the epilogue flag

struct Args : ConvF32Params {
  const float* bias;
  float* y;
  int flags;
  int vec_y;   // y 16-byte aligned: a granule's 8 channels by two float4
};

__global__ void __launch_bounds__(MAX_THREADS)
conv3x3_f32_kernel(const Args a) {
  float acc[8][8];
  const ConvF32Place p = conv_f32_mainloop(a, acc);
  const int H = a.H, W = a.W, Cout = a.Cout, n = p.n;
  const int oy = p.ty0 + p.r, cb = p.co0 + 8 * p.gran;
  if (oy >= H || cb >= Cout) return;
  float bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    bv[c] = a.bias != nullptr && cb + c < Cout ? a.bias[cb + c] : 0.f;
  const bool vec_y = a.vec_y && (Cout & 3) == 0 && cb + 8 <= Cout;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int ox = p.tx0 + 8 * p.half + t;
    if (ox >= W) break;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = acc[t][c] + bv[c];
      if (a.flags & LRELU) v[c] = nesr::lrelu(v[c]);
    }
    float* yp = a.y + (((size_t)n * H + oy) * W + ox) * Cout + cb;
    if (vec_y) {
      *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(yp + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (cb + c < Cout) yp[c] = v[c];
    }
  }
}

int launch_f32(const void* x, const void* w, const void* bias, void* y,
               int N, int H, int W, int Cin, int Cout, int flags,
               void* stream) {
  if (flags & ~LRELU) return (int)cudaErrorInvalidValue;
  Args a;
  const ConvF32Launch l = conv_f32_geometry(a, x, w, N, H, W, Cin, Cout);
  a.bias = (const float*)bias;
  a.y = (float*)y;
  a.flags = flags;
  a.vec_y = ((uintptr_t)y & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.smem);
  if (err != cudaSuccess) return (int)err;
  conv3x3_f32_kernel<<<l.grid, l.threads, l.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,) or null, y (N, H, W,
// Cout), all float32 and contiguous (kernels/conv3x3.py checks); a y that
// is not 16-byte aligned is stored a float at a time; flags: LRELU 1.
extern "C" int nesr_conv3x3_f32(const void* x, const void* w,
                                const void* bias, void* y, int N, int H,
                                int W, int Cin, int Cout, int flags,
                                void* stream) {
  return launch_f32(x, w, bias, y, N, H, W, Cin, Cout, flags, stream);
}
