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

struct Params {
  const bf16* x;
  const bf16* wp;      // packed weights (pack_conv3x3_weights)
  const float* bias;   // may be null
  bf16* y;
  int H, W, Cin, Cout, kp;   // kp: Cin rounded up to the pass width
  int lrelu, tiles_x, vec;   // vec: channels a patch copy (8, 4 or 1)
  int n_tiles;               // Cout in N-wide tiles, walked in the block
  int wave;                  // blocks the card runs at once (2 an SM)
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared memory: [weight ring] [output tile] [patch] [full bars] [empty
// bars]. A pass is KS k-steps of 16 input channels (KC = 16 KS); the patch
// pixel pitch is KC + 8 and the output row pitch N + 8, so each 8-row
// ldmatrix phase and each fragment store is conflict free. The ring has
// four slots, or three where four would keep two blocks off one SM.
template <int N, int KS>
struct Smem {
  static constexpr int KC = 16 * KS, PITCH = KC + 8, SLAB = KC * N;
  static constexpr int OUT = TH * TW * (N + 8) * 2;
  static constexpr int PATCH = round_up((TH + 2) * (TW + 2) * PITCH * 2, 16);
  static constexpr int STAGES =
      2 * (4 * SLAB * 2 + OUT + PATCH + 64 + 1024) <= SM_SMEM ? 4 : 3;
  static constexpr int OUT_OFF = STAGES * SLAB * 2;
  static constexpr int PATCH_OFF = OUT_OFF + OUT;
  static constexpr int BAR_OFF = PATCH_OFF + PATCH;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  // two blocks an SM, each with 1 KB the hardware keeps
  static_assert(2 * (BYTES + 1024) <= SM_SMEM, "K1: two blocks an SM");
};

// Stage channels [c0, c0 + kc) of the (TH+2) x (TW+2) input patch, VEC
// channels a copy, zero-filling out-of-image pixels and channels >= Cin.
template <int VEC>
__device__ void stage_patch(const Params& p, bf16* patch, int pitch, int n,
                            int oy, int ox, int c0, int kc) {
  const int nv = kc / VEC;
  for (int it = threadIdx.x; it < (TH + 2) * (TW + 2) * nv; it += THREADS) {
    const int v = it % nv, px = it / nv;
    const int gy = oy - 1 + px / (TW + 2), gx = ox - 1 + px % (TW + 2);
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

template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const Params p) {
  using S = Smem<N, KS>;
  constexpr int STAGES = S::STAGES;
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
  const int total = p.n_tiles * 9 * npass;
  // Shared addresses: the ring, the barriers, and this lane's ldmatrix row
  // (patch pixel (warp, lane % 16), channel 8 (lane / 16)) at tap (0, 0).
  const uint32_t ring_s = nesr::smem_u32(smem);
  const uint32_t full_s = nesr::smem_u32(full), empty_s = full_s + 8 * STAGES;
  const uint32_t a_s = nesr::smem_u32(patch) +
      ((warp * (TW + 2) + lane % 16) * S::PITCH + lane / 16 * 8) * 2;
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
  if (warp == 0 && lane < TH + 2 && p.vec == 8 &&
      later < gridDim.x * gridDim.z) {
    const int lx = later % gridDim.x, ln = later / gridDim.x;
    const int gy = lx / p.tiles_x * TH - 1 + lane;
    const int x0 = max(lx % p.tiles_x * TW - 1, 0);
    const int x1 = min(lx % p.tiles_x * TW + TW + 1, p.W);
    if (gy >= 0 && gy < p.H)
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
          case 8: stage_patch<8>(p, patch, S::PITCH, n, oy, ox, c * S::KC,
                                 S::KC);
                  break;
          case 4: stage_patch<4>(p, patch, S::PITCH, n, oy, ox, c * S::KC,
                                 S::KC);
                  break;
          default: stage_patch<1>(p, patch, S::PITCH, n, oy, ox, c * S::KC,
                                  S::KC);
        }
        nesr::cp_async_wait_all();
        __syncthreads();
      }
      const int g0 = (nt * npass + c) * 9;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int g = g0 + t, s = g % STAGES;
        nesr::mbar_wait(full_s + 8 * s, (g / STAGES) & 1);
        __syncwarp();
        // A: this warp's 16 pixels (its output row, shifted by the tap) x
        // 16 channels a k-step; B: the slab's k-steps by descriptor
        // (K-major, no swizzle, core matrices 128 bytes apart along K, 256
        // along N).
        const int tap_off = ((t / 3) * (TW + 2) + t % 3) * S::PITCH * 2;
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
      release(g0 + 8);
    }
#pragma unroll
    for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);

    // Epilogue of this N tile: bias, LeakyReLU, one bf16 rounding; the
    // tile through its own shared buffer, then 16-byte stores, which drain
    // under the next N tile's MMAs.
    __syncthreads();   // every warp done storing the last N tile
    const int co0 = nt * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int co = co0 + 8 * j + 2 * q;
      const float b0 = (p.bias != nullptr && co < p.Cout) ? p.bias[co] : 0.f;
      const float b1 =
          (p.bias != nullptr && co + 1 < p.Cout) ? p.bias[co + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (p.lrelu) {
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
    bf16* y = p.y + (size_t)n * p.H * p.W * p.Cout + co0;
    if (p.Cout % 8 == 0) {
      const int nv = nvalid / 8;
      for (int it = tid; it < TH * TW * nv; it += THREADS) {
        const int v = it % nv, px = it / nv;
        const int gy = oy + px / TW, gx = ox + px % TW;
        if (gy < p.H && gx < p.W)
          *reinterpret_cast<uint4*>(y + ((size_t)gy * p.W + gx) * p.Cout +
                                    8 * v) =
              *reinterpret_cast<const uint4*>(out + px * (N + 8) + 8 * v);
      }
    } else {
      for (int it = tid; it < TH * TW * nvalid; it += THREADS) {
        const int v = it % nvalid, px = it / nvalid;
        const int gy = oy + px / TW, gx = ox + px % TW;
        if (gy < p.H && gx < p.W)
          y[((size_t)gy * p.W + gx) * p.Cout + v] = out[px * (N + 8) + v];
      }
    }
  }
}

template <int N, int KS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<N, KS>::BYTES;
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<N, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (p.H + TH - 1) / TH;
  dim3 grid(p.tiles_x * tiles_y, 1, batch);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Params q = p;
  q.wave = 2 * sms;
  conv3x3_kernel<N, KS><<<grid, THREADS, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

template <int N>
int launch_ks(const Params& p, int ks, int batch, cudaStream_t stream) {
  switch (ks) {
    case 1: return launch<N, 1>(p, batch, stream);
    case 2: return launch<N, 2>(p, batch, stream);
    default: return launch<N, 4>(p, batch, stream);
  }
}

}  // namespace

// n_width: the tile width the weights were packed for (one of 8, 16, 32,
// 64, 80, 96, 128); Cout is ceil(Cout / n_width) such tiles. A pass is 16,
// 32 or 64 input channels as Cin is at most 16, at most 32 or more; Cin is
// padded to a whole number of passes (kernels/conv3x3.py: tile_width,
// pass_width).
extern "C" int nesr_conv3x3(const void* x, const void* wp, const void* bias,
                            void* y, int N, int H, int W, int Cin, int Cout,
                            int n_width, int lrelu, void* stream) {
  const int ks = Cin <= 16 ? 1 : Cin <= 32 ? 2 : 4;
  Params p;
  p.x = (const bf16*)x;
  p.wp = (const bf16*)wp;
  p.bias = (const float*)bias;
  p.y = (bf16*)y;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kp = round_up(Cin, 16 * ks);
  p.lrelu = lrelu;
  p.tiles_x = (W + TW - 1) / TW;
  p.vec = Cin % 8 == 0 ? 8 : Cin % 4 == 0 ? 4 : 1;
  p.n_tiles = (Cout + n_width - 1) / n_width;
  cudaStream_t s = (cudaStream_t)stream;
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
