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
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// 9 taps x Cin. A block (two warpgroups, one 16-pixel output row a warp)
// owns an 8 x 16-pixel output tile and every output channel, walked in
// tiles of at most N = 128 (w0's 192 as 2 x 96): the input patch is staged
// once for all of them, the first tile's stores drain under the second
// tile's MMAs, and N/2 <= 64 accumulators let two blocks share an SM.
//  * The patch (10 x 18 pixels, 1-px SAME halo, 16/32/64 channels a pass
//    as Cin is <= 16, <= 32 or more, so a Cin-32 conv stages no zeros)
//    arrives by cp.async with zero-fill for the halo, the ragged edge and
//    the channels past Cin. Its pixel pitch is padded by 16 bytes, so each
//    8-row ldmatrix phase is conflict free. Each block also prefetches into
//    L2 the patch of the block one wave later, whose loads then skip HBM.
//  * The weights are packed once on the host (kernels/conv3x3.py,
//    pack_conv3x3_weights) into the exact shared-memory image of each
//    (N tile, pass, tap) slab, so one cp.async.bulk moves a slab, with no
//    index math, into a ring of 3-4 slots with full/empty mbarriers;
//    thread 0 refills a slot two taps after its last reader released it.
//  * Each warpgroup issues wgmma.mma_async m64nNk16 (N an immediate: the
//    kernel is templated on N and the pass width; Cout rounds up to the
//    next instantiation with zero weight columns): A, its four warps'
//    16-pixel output rows, from registers (ldmatrix of the patch, two sets
//    alternating by tap so tap t loads while tap t-1 multiplies), B from
//    the ring by descriptor. A slot goes back to the ring only after the
//    MMAs that read it have retired (wgmma.wait_group 1).
//  * The epilogue adds the bias, applies LeakyReLU, rounds to bf16 once,
//    stages the tile in its own shared buffer and writes it with 16-byte
//    coalesced stores.
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
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using nesr::bf16;

constexpr int TW = 16;   // output columns per tile = one warp's M rows

// Two warpgroups a block (4 warps each, one 16-pixel output row a warp:
// 8 x 16-pixel tiles), two blocks an SM (at most 128 registers a thread:
// N/2 <= 64 accumulators and two sets of A fragments).
constexpr int NWG = 2;
constexpr int WARPS = NWG * 4;
constexpr int THREADS = WARPS * 32;
constexpr int TH = WARPS;
constexpr int SM_SMEM = 233472;   // shared memory of an H100 SM (228 KB)

// Epilogue flags (the C entry points' `flags`).
constexpr int LRELU = 1, ROUND_FIRST = 2, MASK = 4, D2S = 8;

struct Params {
  const bf16* x;
  const bf16* wp;      // packed weights (pack_conv3x3_weights)
  const float* bias;   // may be null
  bf16* y;
  int H, W, Cin, Cout, kp;   // kp: Cin rounded up to the pass width
  int Ho, Wo, pad;           // output size; the patch starts at -pad
  int flags, D;              // epilogue flags; D = Cout / 4 (MASK, D2S)
  int tiles_x, vec;          // vec: channels a patch copy (8, 4 or 1)
  int vec_out;               // 16-byte output stores
  int n_tiles;               // Cout in N-wide tiles, walked in the block
  int wave;                  // blocks the card runs at once (2 an SM)
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared memory: [weight ring] [output tile] [patch] [full bars] [empty
// bars]. A pass is KS k-steps of 16 input channels (KC = 16 KS); the patch
// (TH + KT - 1 rows of TW + KT - 1 pixels for a KT x KT conv) has pixel
// pitch KC + 8 and the output row pitch N + 8, so each 8-row ldmatrix
// phase and each fragment store is conflict free. The ring has four
// slots, or three where four would keep two blocks off one SM.
template <int N, int KS, int KT>
struct Smem {
  static constexpr int KC = 16 * KS, PITCH = KC + 8, SLAB = KC * N;
  static constexpr int PW = TW + KT - 1;   // patch row, pixels
  static constexpr int OUT = TH * TW * (N + 8) * 2;
  static constexpr int PATCH = round_up((TH + KT - 1) * PW * PITCH * 2, 16);
  static constexpr int STAGES =
      2 * (4 * SLAB * 2 + OUT + PATCH + 64 + 1024) <= SM_SMEM ? 4 : 3;
  static constexpr int OUT_OFF = STAGES * SLAB * 2;
  static constexpr int PATCH_OFF = OUT_OFF + OUT;
  static constexpr int BAR_OFF = PATCH_OFF + PATCH;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  // two blocks an SM, each with 1 KB the hardware keeps
  static_assert(2 * (BYTES + 1024) <= SM_SMEM, "K1: two blocks an SM");
};

// Stage channels [c0, c0 + kc) of the (TH + KT - 1) x (TW + KT - 1) input
// patch at (oy - pad, ox - pad), VEC channels a copy, zero-filling
// out-of-image pixels and channels >= Cin.
template <int VEC, int KT>
__device__ void stage_patch(const Params& p, bf16* patch, int pitch, int n,
                            int oy, int ox, int c0, int kc, int pad) {
  constexpr int PW = TW + KT - 1;
  const int nv = kc / VEC;
  for (int it = threadIdx.x; it < (TH + KT - 1) * PW * nv; it += THREADS) {
    const int v = it % nv, px = it / nv;
    const int gy = oy - pad + px / PW, gx = ox - pad + px % PW;
    const int ch = c0 + v * VEC;
    const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && ch < p.Cin;
    const bf16* src =
        ok ? p.x + ((size_t)(n * p.H + gy) * p.W + gx) * p.Cin + ch : p.x;
    bf16* dst = patch + px * pitch + v * VEC;
    if constexpr (VEC == 1) {
      *dst = ok ? *src : __float2bfloat16(0.f);
    } else {
      nesr::cp_async_zfill<VEC * 2>(dst, src, ok ? VEC * 2 : 0);
    }
  }
}

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

// HEAD: the folded head's forms (padding, frame mask, depth-to-space,
// ROUND_FIRST); without it the SAME 3x3 conv with bias and LeakyReLU
// only, its epilogue free of their code.
template <int N, int KS, int KT, bool HEAD>
__device__ __forceinline__ void conv_body(const Params& p) {
  using S = Smem<N, KS, KT>;
  constexpr int STAGES = S::STAGES, T = KT * KT;
  const int pad = HEAD ? p.pad : 1;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* out = reinterpret_cast<bf16*>(smem + S::OUT_OFF);
  bf16* patch = reinterpret_cast<bf16*>(smem + S::PATCH_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = blockIdx.x % p.tiles_x, ty = blockIdx.x / p.tiles_x;
  const int n = blockIdx.z;
  const int oy = ty * TH, ox = tx * TW;
  const int npass = p.kp / S::KC;
  // Slabs g = (N tile, pass, tap), contiguous in that order in p.wp.
  const int total = p.n_tiles * T * npass;
  // Shared addresses: the ring, the barriers, and this lane's ldmatrix row
  // (patch pixel (warp, lane % 16), channel 8 (lane / 16)) at tap (0, 0).
  const uint32_t ring_s = nesr::smem_u32(smem);
  const uint32_t full_s = nesr::smem_u32(full), empty_s = full_s + 8 * STAGES;
  const uint32_t a_s = nesr::smem_u32(patch) +
      ((warp * S::PW + lane % 16) * S::PITCH + lane / 16 * 8) * 2;
  auto issue = [&](int g) {
    const int s = g % STAGES;
    nesr::bulk_load(ring_s + s * S::SLAB * 2, p.wp + (size_t)g * S::SLAB,
                    S::SLAB * 2, full_s + 8 * s);
  };
  // Warp `warp` is done with slab g (its MMAs retired): one arrival a warp.
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) nesr::mbar_arrive(empty_s + 8 * (g % STAGES));
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      nesr::mbar_init(&full[s], 1);
      nesr::mbar_init(&empty[s], WARPS);
    }
    nesr::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < STAGES && g < total; ++g) issue(g);
  // Warm L2 with the patch of the block one wave later (blocks start in
  // order of their index): one bulk prefetch a patch row, so that block's
  // cp.async finds its input in L2 instead of HBM.
  const int later = blockIdx.z * gridDim.x + blockIdx.x + p.wave;
  if (warp == 0 && lane < TH + KT - 1 && p.vec == 8 &&
      later < gridDim.x * gridDim.z) {
    const int lx = later % gridDim.x, ln = later / gridDim.x;
    const int gy = lx / p.tiles_x * TH - pad + lane;
    const int x0 = max(lx % p.tiles_x * TW - pad, 0);
    const int x1 = min(lx % p.tiles_x * TW + S::PW - pad, p.W);
    if (gy >= 0 && gy < p.H && x1 > x0)
      nesr::prefetch_l2(p.x + ((size_t)(ln * p.H + gy) * p.W + x0) * p.Cin,
                        (x1 - x0) * p.Cin * 2);
  }

  float acc[N / 2];
  // A fragments, double-buffered by tap parity: the MMAs of tap t-1 may
  // still read one set while tap t's ldmatrix fills the other.
  uint32_t a[2][KS][4];
  const int frow = lane / 4, q = lane % 4;   // accumulator row, column pair

  for (int nt = 0; nt < p.n_tiles; ++nt) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
    for (int c = 0; c < npass; ++c) {
      // The patch of a pass is staged once and serves every N tile when
      // there is one pass; with more, each pass is staged again.
      if (nt == 0 || npass > 1) {
        if (nt + c > 0) __syncthreads();   // every warp done reading it
        switch (p.vec) {
          case 8: stage_patch<8, KT>(p, patch, S::PITCH, n, oy, ox,
                                     c * S::KC, S::KC, pad);
                  break;
          case 4: stage_patch<4, KT>(p, patch, S::PITCH, n, oy, ox,
                                     c * S::KC, S::KC, pad);
                  break;
          default: stage_patch<1, KT>(p, patch, S::PITCH, n, oy, ox,
                                      c * S::KC, S::KC, pad);
        }
        nesr::cp_async_wait_all();
        __syncthreads();
      }
      const int g0 = (nt * npass + c) * T;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int g = g0 + t, s = g % STAGES;
        nesr::mbar_wait(full_s + 8 * s, (g / STAGES) & 1);
        __syncwarp();
        // A: this warp's 16 pixels (its output row, shifted by the tap) x
        // 16 channels a k-step; B: the slab's k-steps by descriptor
        // (K-major, no swizzle, core matrices 128 bytes apart along K, 256
        // along N).
        const int tap_off = ((t / KT) * S::PW + t % KT) * S::PITCH * 2;
        const uint32_t bs = ring_s + s * S::SLAB * 2;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          nesr::ldsm_x4_at(a[t & 1][kk], a_s + tap_off + kk * 32);
        nesr::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          nesr::wgmma_rs<N>(acc, a[t & 1][kk],
                            nesr::wgmma_desc(bs + kk * 32 * N, 128, 256));
        nesr::wgmma_commit();
        // Tap t-1's MMAs have retired once at most this tap's group is in
        // flight: its slot goes back to the ring.
        if (t > 0) {
          nesr::wgmma_wait<1>();
          release(g - 1);
        }
        // Refill the slot of slab g-2, which every warp released one tap
        // ago.
        if (tid == 0 && g >= 2 && g - 2 + STAGES < total) {
          nesr::mbar_wait(empty_s + 8 * ((g - 2) % STAGES),
                          ((g - 2) / STAGES) & 1);
          issue(g - 2 + STAGES);
        }
        __syncwarp();
      }
      nesr::wgmma_wait<0>();
      release(g0 + T - 1);
    }
#pragma unroll
    for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);

    // Epilogue of this N tile: bias, LeakyReLU, bf16 rounding (once, or
    // before the LeakyReLU and after it under ROUND_FIRST); the tile
    // through its own shared buffer, then 16-byte stores (zeros outside
    // the frame under MASK, to the depth-to-space pixel under D2S), which
    // drain under the next N tile's MMAs.
    __syncthreads();   // every warp done storing the last N tile
    const int co0 = nt * N;
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
    __syncthreads();
    const int nvalid = min(N, p.Cout - co0);
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
}

// The forms, by name: the SAME 3x3 conv; the folded head's 3x3 form
// (ROUND_FIRST, D2S).
template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const Params p) {
  conv_body<N, KS, 3, false>(p);
}

template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_head_kernel(const Params p) {
  conv_body<N, KS, 3, true>(p);
}

template <int N, int KS, int KT, bool HEAD>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<N, KS, KT>::BYTES;
  void (*kernel)(const Params);
  if constexpr (HEAD) {
    kernel = conv3x3_head_kernel<N, KS>;
  } else {
    kernel = conv3x3_kernel<N, KS>;
  }
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (p.Ho + TH - 1) / TH;
  dim3 grid(p.tiles_x * tiles_y, 1, batch);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Params q = p;
  q.wave = 2 * sms;
  kernel<<<grid, THREADS, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

template <int N>
int launch_ks(const Params& p, int ks, int batch, cudaStream_t stream) {
  switch (ks) {
    case 1: return launch<N, 1, 3, false>(p, batch, stream);
    case 2: return launch<N, 2, 3, false>(p, batch, stream);
    default: return launch<N, 4, 3, false>(p, batch, stream);
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
template <int KT>
int launch_head(const Params& p, int n_width, int batch, cudaStream_t s) {
  switch (n_width) {
    case 16: return launch<16, 4, KT, true>(p, batch, s);
    case 64: return launch<64, 4, KT, true>(p, batch, s);
    case 128: return launch<128, 4, KT, true>(p, batch, s);
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
    return launch_head<3>(p, n_width, N, s);
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
