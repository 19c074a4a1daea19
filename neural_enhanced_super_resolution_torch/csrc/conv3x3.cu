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
// The folded RRDBNet head's 3x3 form (conv3x3_head_kernel: up1 and up2,
// 64 -> 256; it replaces no Pallas kernel: the JAX package runs them as
// XLA convs in _head_forward, models/rrdbnet.py:586) is this implicit GEMM
// with passes of 64 input channels and N tiles of 16, 64 or 128
// (kernels/conv3x3.py: TILE_WIDTHS_2X2). The body takes the tap geometry
// as a template parameter (KT x KT taps, a (TH + KT - 1) x (TW + KT - 1)
// patch at offset -pad). The head's 2x2 form has its own kernel
// (csrc/conv2x2.cu). The head form's epilogue has three flags, which the
// SAME 3x3 kernel is compiled without:
//  * ROUND_FIRST: round acc + bias to bf16, then LeakyReLU on the bf16
//    value with 0.2 * y rounded to bf16 (the JAX package's _conv then
//    _lrelu, in PyTorch's op order);
//  * MASK: the frame border of a padding-1 2x2 output: in channel group
//    g = 2 oi + oj (Cout = 4 D), row 0 when oi = 0, row Ho-1 when oi = 1,
//    column 0 when oj = 0 and column Wo-1 when oj = 1 are stored as zeros;
//  * D2S: depth-to-space on the store: channel (2 oi + oj) D + f of pixel
//    (r, s) goes to pixel (2r + oi, 2s + oj), channel f of a (2Ho, 2Wo, D)
//    output; with D % 8 == 0 the 16-byte stores stay whole, otherwise the
//    scalar store path takes it.
#include "conv3x3_body.cuh"

namespace {

// Epilogue flags (the C entry points' `flags`).
constexpr int LRELU = 1, ROUND_FIRST = 2, MASK = 4, D2S = 8;

struct Params : ConvParams {
  const float* bias;   // may be null
  bf16* y;
  int Ho, Wo, pad;     // output size; the patch starts at -pad
  int flags, D;        // epilogue flags; D = Cout / 4 (MASK, D2S)
  int vec_out;         // 16-byte output stores
};

// MASK: whether output channel co of pixel (gy, gx) lies inside the frame.
__device__ __forceinline__ bool kept(const Params& p, int gy, int gx,
                                     int co) {
  if (!(p.flags & MASK)) return true;
  const int g = co / p.D, oi = g >> 1, oj = g & 1;
  return !((oi == 0 && gy == 0) || (oi == 1 && gy == p.Ho - 1) ||
           (oj == 0 && gx == 0) || (oj == 1 && gx == p.Wo - 1));
}

// Where output channel co of pixel (gy, gx) of image n is stored.
__device__ __forceinline__ size_t out_index(const Params& p, int n, int gy,
                                            int gx, int co) {
  if (p.flags & D2S) {
    const int g = co / p.D, f = co - g * p.D;
    return (((size_t)n * 2 * p.Ho + 2 * gy + (g >> 1)) * 2 * p.Wo + 2 * gx +
            (g & 1)) * p.D + f;
  }
  return (((size_t)n * p.Ho + gy) * p.Wo + gx) * p.Cout + co;
}

// K1's epilogue (conv_body's Epi). HEAD: the folded head's forms (padding,
// frame mask, depth-to-space, ROUND_FIRST); without it the SAME 3x3 conv
// with bias and LeakyReLU only, its epilogue free of their code.
template <bool HEAD>
struct K1Epi {
  using P = Params;

  static __device__ __forceinline__ int pad(const P& p) {
    return HEAD ? p.pad : 1;
  }

  // Bias, LeakyReLU, bf16 rounding (once, or before the LeakyReLU and
  // after it under ROUND_FIRST).
  template <int N>
  static __device__ __forceinline__ void stage(const P& p, bf16* out,
                                               const float (&acc)[N / 2],
                                               int warp, int frow, int q,
                                               int co0) {
    const bool act = p.flags & LRELU;
    const bool first = HEAD && (p.flags & ROUND_FIRST);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int co = co0 + 8 * j + 2 * q;
      const float b0 = (p.bias != nullptr && co < p.Cout) ? p.bias[co] : 0.f;
      const float b1 =
          (p.bias != nullptr && co + 1 < p.Cout) ? p.bias[co + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (first) {
          v0 = nesr::round_bf16(v0);
          v1 = nesr::round_bf16(v1);
        }
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

  // 16-byte stores (zeros outside the frame under MASK, to the
  // depth-to-space pixel under D2S).
  template <int N>
  static __device__ __forceinline__ void write(const P& p, const bf16* out,
                                               int n, int oy, int ox, int co0,
                                               int nvalid) {
    const int tid = threadIdx.x;
    if (!HEAD || !(p.flags & (MASK | D2S))) {
      // The NHWC output: 16-byte row segments, or channel by channel when
      // Cout is not a multiple of 8.
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
    } else if (p.vec_out) {
      const int nv = nvalid / 8;
      for (int it = tid; it < TH * TW * nv; it += THREADS) {
        const int v = it % nv, px = it / nv;
        const int gy = oy + px / TW, gx = ox + px % TW, co = co0 + 8 * v;
        if (gy < p.Ho && gx < p.Wo)
          *reinterpret_cast<uint4*>(p.y + out_index(p, n, gy, gx, co)) =
              kept(p, gy, gx, co)
                  ? *reinterpret_cast<const uint4*>(out + px * (N + 8) +
                                                    8 * v)
                  : make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int it = tid; it < TH * TW * nvalid; it += THREADS) {
        const int v = it % nvalid, px = it / nvalid;
        const int gy = oy + px / TW, gx = ox + px % TW, co = co0 + v;
        if (gy < p.Ho && gx < p.Wo)
          p.y[out_index(p, n, gy, gx, co)] =
              kept(p, gy, gx, co) ? out[px * (N + 8) + v]
                                  : __float2bfloat16(0.f);
      }
    }
  }
};

// The forms, by name: the SAME 3x3 conv; the folded head's 3x3 form
// (ROUND_FIRST, D2S).
template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const Params p) {
  conv_body<N, KS, 3, K1Epi<false>>(p);
}

template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_head_kernel(const Params p) {
  conv_body<N, KS, 3, K1Epi<true>>(p);
}

template <int N, int KS, bool HEAD>
int launch(const Params& p, int batch, cudaStream_t stream) {
  void (*kernel)(const Params);
  if constexpr (HEAD) {
    kernel = conv3x3_head_kernel<N, KS>;
  } else {
    kernel = conv3x3_kernel<N, KS>;
  }
  return launch_tiles(kernel, Smem<N, KS, 3>::BYTES, p, p.Ho, batch, stream);
}

template <int N>
int launch_ks(const Params& p, int ks, int batch, cudaStream_t stream) {
  switch (ks) {
    case 1: return launch<N, 1, false>(p, batch, stream);
    case 2: return launch<N, 2, false>(p, batch, stream);
    default: return launch<N, 4, false>(p, batch, stream);
  }
}

Params make_params(const void* x, const void* wp, const void* bias, void* y,
                   int H, int W, int Cin, int Cout, int kc, int taps,
                   int pad, int flags) {
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
  p.pad = pad;
  p.Ho = H + 2 * pad - (taps - 1);
  p.Wo = W + 2 * pad - (taps - 1);
  p.flags = flags;
  p.D = Cout / 4;
  p.tiles_x = (p.Wo + TW - 1) / TW;
  p.vec = Cin % 8 == 0 ? 8 : Cin % 4 == 0 ? 4 : 1;
  p.vec_out = Cout % 8 == 0 && (!(flags & (MASK | D2S)) || p.D % 8 == 0);
  return p;
}

bool bad_flags(int flags, int Cout) {
  return (flags & ~(LRELU | ROUND_FIRST | MASK | D2S)) ||
         ((flags & (MASK | D2S)) && Cout % 4);
}

// The folded head's 3x3 form: passes of 64 input channels, n_width one of
// 16, 64, 128 (kernels/conv3x3.py: pack_conv3x3_weights(head=True),
// tile_width_2x2).
int launch_head(const Params& p, int n_width, int batch, cudaStream_t s) {
  switch (n_width) {
    case 16: return launch<16, 4, true>(p, batch, s);
    case 64: return launch<64, 4, true>(p, batch, s);
    case 128: return launch<128, 4, true>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// SAME 3x3 conv. n_width: the tile width the weights were packed for (one
// of 8, 16, 32, 64, 80, 96, 128); Cout is ceil(Cout / n_width) such tiles.
// A pass is 16, 32 or 64 input channels as Cin is at most 16, at most 32
// or more; Cin is padded to a whole number of passes (kernels/conv3x3.py:
// tile_width, pass_width). flags: LRELU 1; with ROUND_FIRST 2 or D2S 8
// (Cout % 4 == 0; y is then (N, 2H, 2W, Cout / 4)) the folded head's 3x3
// form runs, with its passes and widths.
extern "C" int nesr_conv3x3(const void* x, const void* wp, const void* bias,
                            void* y, int N, int H, int W, int Cin, int Cout,
                            int n_width, int flags, void* stream) {
  if (bad_flags(flags, Cout) || (flags & MASK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (flags & ~LRELU) {
    Params p = make_params(x, wp, bias, y, H, W, Cin, Cout, 64, 3, 1, flags);
    p.n_tiles = (Cout + n_width - 1) / n_width;
    return launch_head(p, n_width, N, s);
  }
  const int ks = Cin <= 16 ? 1 : Cin <= 32 ? 2 : 4;
  Params p = make_params(x, wp, bias, y, H, W, Cin, Cout, 16 * ks, 3, 1,
                         flags);
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
