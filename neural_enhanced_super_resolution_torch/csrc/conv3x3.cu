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
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), on the path's
// 4 x 268 x 268 tile batch: trunk w0 (64->192) by its operations (64.3
// us); the Cin-32 trunk convs w1..w4 (->160/128/96/64) and conv_body by
// their bytes, mostly the bf16 output (33.0 down to 16.5 us); the head at
// 2x/4x and conv_last (64->3) by their bytes too. In practice each block
// spends about half its life loading its patch and storing its tile, the
// rest in MMAs that keep the tensor cores near full while two blocks share
// an SM (PERF.md, tools/k1_ablation.py).
//
// Design: K1's mainloop (csrc/conv3x3_body.cuh), an implicit GEMM on
// wgmma over 8 x 16-pixel tiles with every output channel in N tiles of at
// most 128, two blocks an SM. The epilogue adds the bias, applies
// LeakyReLU, rounds to bf16 once, stages the tile in its own shared buffer
// and writes it with 16-byte coalesced stores.
//
// The folded RRDBNet head's 3x3 form, which shares this kernel's tap MMAs
// and K order, is a persistent kernel of its own (csrc/conv3x3_head.cu),
// as are its 2x2 form (csrc/conv2x2.cu) and the K1 step (csrc/rdb_bf16.cu).
#include "conv3x3_body.cuh"

namespace {

// Epilogue flags (the C entry point's `flags`).
constexpr int LRELU = 1;

struct Params : ConvParams {
  const float* bias;   // may be null
  bf16* y;
  int Ho, Wo;          // output size (SAME: the input's)
  int flags;           // epilogue flags
  int vec_out;         // 16-byte output stores
};

// K1's epilogue (conv_body's Epi): the SAME 3x3 conv with bias and
// LeakyReLU.
struct K1Epi {
  using P = Params;

  static __device__ __forceinline__ int pad(const P&) { return 1; }

  // Bias, LeakyReLU, bf16 rounding (once).
  template <int N>
  static __device__ __forceinline__ void stage(const P& p, bf16* out,
                                               const float (&acc)[N / 2],
                                               int warp, int frow, int q,
                                               int co0) {
    const bool act = p.flags & LRELU;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int co = co0 + 8 * j + 2 * q;
      const float b0 = (p.bias != nullptr && co < p.Cout) ? p.bias[co] : 0.f;
      const float b1 =
          (p.bias != nullptr && co + 1 < p.Cout) ? p.bias[co + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (act) {
          v0 = nesr::lrelu(v0);
          v1 = nesr::lrelu(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + (warp * TW + frow + 8 * h) * (N + 8) + 8 * j + 2 * q) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }

  // The NHWC output: 16-byte row segments, or channel by channel when
  // Cout is not a multiple of 8.
  template <int N>
  static __device__ __forceinline__ void write(const P& p, const bf16* out,
                                               int n, int oy, int ox, int co0,
                                               int nvalid) {
    const int tid = threadIdx.x;
    bf16* y = p.y + (size_t)n * p.Ho * p.Wo * p.Cout + co0;
    if (p.vec_out) {
      const int nv = nvalid / 8;
      for (int it = tid; it < TH * TW * nv; it += THREADS) {
        const int v = it % nv, px = it / nv;
        const int gy = oy + px / TW, gx = ox + px % TW;
        if (gy < p.Ho && gx < p.Wo)
          *reinterpret_cast<uint4*>(y + ((size_t)gy * p.Wo + gx) * p.Cout +
                                    8 * v) =
              *reinterpret_cast<const uint4*>(out + px * (N + 8) + 8 * v);
      }
    } else {
      for (int it = tid; it < TH * TW * nvalid; it += THREADS) {
        const int v = it % nvalid, px = it / nvalid;
        const int gy = oy + px / TW, gx = ox + px % TW;
        if (gy < p.Ho && gx < p.Wo)
          y[((size_t)gy * p.Wo + gx) * p.Cout + v] = out[px * (N + 8) + v];
      }
    }
  }
};

template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const Params p) {
  conv_body<N, KS, 3, K1Epi>(p);
}

template <int N, int KS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  return launch_tiles(conv3x3_kernel<N, KS>, Smem<N, KS, 3>::BYTES, p, p.Ho,
                      batch, stream);
}

template <int N>
int launch_ks(const Params& p, int ks, int batch, cudaStream_t stream) {
  switch (ks) {
    case 1: return launch<N, 1>(p, batch, stream);
    case 2: return launch<N, 2>(p, batch, stream);
    default: return launch<N, 4>(p, batch, stream);
  }
}

Params make_params(const void* x, const void* wp, const void* bias, void* y,
                   int H, int W, int Cin, int Cout, int kc, int flags) {
  Params p;
  p.x = (const bf16*)x;
  p.wp = (const bf16*)wp;
  p.bias = (const float*)bias;
  p.y = (bf16*)y;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kp = round_up(Cin, kc);
  p.Ho = H;
  p.Wo = W;
  p.flags = flags;
  p.tiles_x = (p.Wo + TW - 1) / TW;
  p.vec = Cin % 8 == 0 ? 8 : Cin % 4 == 0 ? 4 : 1;
  p.vec_out = Cout % 8 == 0;
  return p;
}

}  // namespace

// SAME 3x3 conv. n_width: the tile width the weights were packed for (one
// of 8, 16, 32, 64, 80, 96, 128); Cout is ceil(Cout / n_width) such tiles.
// A pass is 16, 32 or 64 input channels as Cin is at most 16, at most 32
// or more; Cin is padded to a whole number of passes (kernels/conv3x3.py:
// tile_width, pass_width). flags: LRELU 1 (the folded head's epilogue
// flags take nesr_conv3x3_head, csrc/conv3x3_head.cu).
extern "C" int nesr_conv3x3(const void* x, const void* wp, const void* bias,
                            void* y, int N, int H, int W, int Cin, int Cout,
                            int n_width, int flags, void* stream) {
  if (flags & ~LRELU) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ks = Cin <= 16 ? 1 : Cin <= 32 ? 2 : 4;
  Params p = make_params(x, wp, bias, y, H, W, Cin, Cout, 16 * ks, flags);
  p.n_tiles = (Cout + n_width - 1) / n_width;
  switch (n_width) {
    case 8: return launch_ks<8>(p, ks, N, s);
    case 16: return launch_ks<16>(p, ks, N, s);
    case 32: return launch_ks<32>(p, ks, N, s);
    case 64: return launch_ks<64>(p, ks, N, s);
    case 80: return launch_ks<80>(p, ks, N, s);
    case 96: return launch_ks<96>(p, ks, N, s);
    case 128: return launch_ks<128>(p, ks, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
