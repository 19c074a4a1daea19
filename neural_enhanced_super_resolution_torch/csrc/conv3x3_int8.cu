// K4: SAME 3x3 convolution of int8 NHWC activations with int8 weights,
// int32 accumulation, and a per-output-channel dequantisation to bf16 in
// the epilogue: y = bf16(float(acc) * ((s_x / 127) * w_s[co])).
//
// Replaces conv_q of the JAX package's int8 trunk
// (neural_enhanced_super_resolution_tpu/models/rrdbnet.py:255,
// _rdb_fused_int8): XLA's lax.conv_general_dilated on int8 operands with
// preferred_element_type int32, not a Pallas kernel. The arithmetic is
// exact: |acc| <= 127 * 127 * 576 < 2^24, so the int32 -> float32
// conversion is exact too, and the epilogue is one IEEE division, two
// float32 multiplies and one round-to-nearest-even cast, in the JAX
// package's order; the kernel equals conv3x3_int8_plain bit for bit. The
// library is built without --use_fast_math.
//
// What bounds it on an H100 (1,979 TOP/s dense int8, 3.35 TB/s), on the
// path's 4 x 268 x 268 tile batch: every trunk conv by its bytes, mostly
// the bf16 output the dequantisation writes (w0 64->192 38 us, w1 32->160
// 30 us; the operations take 32 us at w0). Compared with K1 in bf16 the
// input is half the bytes and the MMAs half the time; the output is not.
//
// Design: K1's (csrc/conv3x3.cu) with the 8-bit wgmma. An implicit GEMM,
// M = output pixels, N = output channels, K = 9 taps x Cin; a block (two
// warpgroups, one 16-pixel output row a warp) owns an 8 x 16-pixel tile
// and every output channel, walked in N tiles of at most 128.
//  * The patch (10 x 18 pixels, 32 or 64 channels a pass as Cin is <= 32
//    or more) arrives by cp.async with zero-fill for the halo, the ragged
//    edge and the channels past Cin; its pixel pitch is padded by 16
//    bytes, so each 8-row ldmatrix phase is conflict free.
//  * The weights are packed once on the host
//    (kernels/conv3x3_int8.py:pack_conv3x3_int8_weights) into the
//    shared-memory image of each (N tile, pass, tap) slab: 8-bit wgmma
//    takes both operands K-major (no transpose), 32 channels a k-step, so
//    a k-step of B is N/8 x 2 core matrices of 8 rows x 16 bytes, the
//    byte layout of K1's bf16 k16 step. One cp.async.bulk a slab into a
//    ring of 3-4 slots with full/empty mbarriers.
//  * wgmma.mma_async m64nNk32.s32.s8.s8: A from registers (ldmatrix of the
//    patch: the k32 int8 fragment is byte for byte the bf16 k16 one), B
//    from the ring by descriptor, int32 accumulators in registers.
//  * The epilogue dequantises, rounds to bf16 once, stages the tile in
//    shared memory and writes it with 16-byte coalesced stores.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using nesr::bf16;

constexpr int TW = 16;   // output columns per tile = one warp's M rows
constexpr int NWG = 2;
constexpr int WARPS = NWG * 4;
constexpr int THREADS = WARPS * 32;
constexpr int TH = WARPS;
constexpr int SM_SMEM = 233472;   // shared memory of an H100 SM (228 KB)

struct Params {
  const int8_t* x;
  const int8_t* wp;     // packed weights (pack_conv3x3_int8_weights)
  const float* s_x;     // the activation's max |h|, one value
  const float* w_s;     // (Cout,) weight scales
  bf16* y;
  int H, W, Cin, Cout, kp;   // kp: Cin rounded up to the pass width
  int tiles_x, vec;          // vec: bytes a patch copy (16, 8, 4 or 1)
  int n_tiles;               // Cout in N-wide tiles, walked in the block
  int wave;                  // blocks the card runs at once (2 an SM)
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared memory: [weight ring] [output tile] [patch] [full bars] [empty
// bars]. A pass is KS k-steps of 32 input channels (KC = 32 KS bytes a
// pixel); the patch pixel pitch is KC + 16 bytes and the output row pitch
// N + 8 bf16, so each 8-row ldmatrix phase and each fragment store is
// conflict free.
template <int N, int KS>
struct Smem {
  static constexpr int KC = 32 * KS, PITCH = KC + 16, SLAB = KC * N;
  static constexpr int OUT = TH * TW * (N + 8) * 2;
  static constexpr int PATCH = round_up((TH + 2) * (TW + 2) * PITCH, 16);
  static constexpr int STAGES =
      2 * (4 * SLAB + OUT + PATCH + 64 + 1024) <= SM_SMEM ? 4 : 3;
  static constexpr int OUT_OFF = STAGES * SLAB;
  static constexpr int PATCH_OFF = OUT_OFF + OUT;
  static constexpr int BAR_OFF = PATCH_OFF + PATCH;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static_assert(2 * (BYTES + 1024) <= SM_SMEM, "K4: two blocks an SM");
};

// Stage channels [c0, c0 + kc) of the (TH+2) x (TW+2) input patch, VEC
// bytes a copy, zero-filling out-of-image pixels and channels >= Cin.
template <int VEC>
__device__ void stage_patch(const Params& p, int8_t* patch, int pitch,
                            int n, int oy, int ox, int c0, int kc) {
  const int nv = kc / VEC;
  for (int it = threadIdx.x; it < (TH + 2) * (TW + 2) * nv; it += THREADS) {
    const int v = it % nv, px = it / nv;
    const int gy = oy - 1 + px / (TW + 2), gx = ox - 1 + px % (TW + 2);
    const int ch = c0 + v * VEC;
    const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && ch < p.Cin;
    const int8_t* src =
        ok ? p.x + ((size_t)(n * p.H + gy) * p.W + gx) * p.Cin + ch : p.x;
    int8_t* dst = patch + px * pitch + v * VEC;
    if constexpr (VEC == 1) {
      *dst = ok ? *src : int8_t(0);
    } else {
      nesr::cp_async_zfill<VEC>(dst, src, ok ? VEC : 0);
    }
  }
}

template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_int8_kernel(const Params p) {
  using S = Smem<N, KS>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* out = reinterpret_cast<bf16*>(smem + S::OUT_OFF);
  int8_t* patch = reinterpret_cast<int8_t*>(smem + S::PATCH_OFF);
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
  // (patch pixel (warp, lane % 16), bytes 16 (lane / 16)) at tap (0, 0).
  const uint32_t ring_s = nesr::smem_u32(smem);
  const uint32_t full_s = nesr::smem_u32(full), empty_s = full_s + 8 * STAGES;
  const uint32_t a_s = nesr::smem_u32(patch) +
      (warp * (TW + 2) + lane % 16) * S::PITCH + lane / 16 * 16;
  auto issue = [&](int g) {
    const int s = g % STAGES;
    nesr::bulk_load(ring_s + s * S::SLAB, p.wp + (size_t)g * S::SLAB,
                    S::SLAB, full_s + 8 * s);
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
  // Warm L2 with the patch of the block one wave later, as K1 does.
  const int later = blockIdx.z * gridDim.x + blockIdx.x + p.wave;
  if (warp == 0 && lane < TH + 2 && p.vec == 16 &&
      later < gridDim.x * gridDim.z) {
    const int lx = later % gridDim.x, ln = later / gridDim.x;
    const int gy = lx / p.tiles_x * TH - 1 + lane;
    const int x0 = max(lx % p.tiles_x * TW - 1, 0);
    const int x1 = min(lx % p.tiles_x * TW + TW + 1, p.W);
    if (gy >= 0 && gy < p.H)
      nesr::prefetch_l2(p.x + ((size_t)(ln * p.H + gy) * p.W + x0) * p.Cin,
                        (x1 - x0) * p.Cin);
  }

  int acc[N / 2];
  // A fragments, double-buffered by tap parity: the MMAs of tap t-1 may
  // still read one set while tap t's ldmatrix fills the other.
  uint32_t a[2][KS][4];
  const int frow = lane / 4, q = lane % 4;   // accumulator row, column pair
  // The JAX package's scale order: (s_x / 127) first, IEEE division.
  const float sx = __fdiv_rn(*p.s_x, 127.0f);

  for (int nt = 0; nt < p.n_tiles; ++nt) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0;
    for (int c = 0; c < npass; ++c) {
      if (nt == 0 || npass > 1) {
        if (nt + c > 0) __syncthreads();   // every warp done reading it
        switch (p.vec) {
          case 16: stage_patch<16>(p, patch, S::PITCH, n, oy, ox, c * S::KC,
                                   S::KC);
                   break;
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
        // 32 channels a k-step; B: the slab's k-steps by descriptor
        // (K-major, no swizzle, core matrices 128 bytes apart along K, 256
        // along N).
        const int tap_off = ((t / 3) * (TW + 2) + t % 3) * S::PITCH;
        const uint32_t bs = ring_s + s * S::SLAB;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          nesr::ldsm_x4_at(a[t & 1][kk], a_s + tap_off + kk * 32);
        nesr::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          nesr::wgmma_rs_s8<N>(acc, a[t & 1][kk],
                               nesr::wgmma_desc(bs + kk * 32 * N, 128, 256));
        nesr::wgmma_commit();
        if (t > 0) {
          nesr::wgmma_wait<1>();
          release(g - 1);
        }
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

    // Epilogue of this N tile: float(acc) * ((s_x / 127) * w_s[co]), one
    // bf16 rounding; the tile through its own shared buffer, then 16-byte
    // stores, which drain under the next N tile's MMAs.
    __syncthreads();   // every warp done storing the last N tile
    const int co0 = nt * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int co = co0 + 8 * j + 2 * q;
      const float s0 = co < p.Cout ? __fmul_rn(sx, p.w_s[co]) : 0.f;
      const float s1 = co + 1 < p.Cout ? __fmul_rn(sx, p.w_s[co + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0);
        const float v1 =
            __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1);
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
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_int8_kernel<N, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  conv3x3_int8_kernel<N, KS><<<grid, THREADS, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

template <int N>
int launch_ks(const Params& p, int ks, int batch, cudaStream_t stream) {
  return ks == 1 ? launch<N, 1>(p, batch, stream)
                 : launch<N, 2>(p, batch, stream);
}

}  // namespace

// n_width: the tile width the weights were packed for (one of 8, 16, 32,
// 64, 80, 96, 128); Cout is ceil(Cout / n_width) such tiles. A pass is 32
// or 64 input channels as Cin is at most 32 or more; Cin is padded to a
// whole number of passes (kernels/conv3x3_int8.py: pass_width_int8).
extern "C" int nesr_conv3x3_int8(const void* x, const void* wp,
                                 const void* s_x, const void* w_s, void* y,
                                 int N, int H, int W, int Cin, int Cout,
                                 int n_width, void* stream) {
  const int ks = Cin <= 32 ? 1 : 2;
  Params p;
  p.x = (const int8_t*)x;
  p.wp = (const int8_t*)wp;
  p.s_x = (const float*)s_x;
  p.w_s = (const float*)w_s;
  p.y = (bf16*)y;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kp = round_up(Cin, 32 * ks);
  p.tiles_x = (W + TW - 1) / TW;
  p.vec = Cin % 16 == 0 ? 16 : Cin % 8 == 0 ? 8 : Cin % 4 == 0 ? 4 : 1;
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
