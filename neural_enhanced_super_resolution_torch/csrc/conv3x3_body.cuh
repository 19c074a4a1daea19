// K1's mainloop: a KT x KT convolution on NHWC bf16 as an implicit GEMM
// on wgmma with fp32 sums (csrc/conv3x3.cu: the SAME 3x3 conv; the
// epilogue a compile-time parameter). Its pieces are shared with two
// persistent kernels of their own, the K1 step (csrc/rdb_bf16.cu: a conv
// of the bf16 RDB with its share of the dense-block assembly) and the
// folded head's 3x3 form (csrc/conv3x3_head.cu): the patch staging
// (stage_pass), a lane's ldmatrix row (lane_a_addr) and a tap's wgmma
// issue (mma_tap), so all sum in the same K order (pass, tap, k16) over
// the same N tiles and their convs equal K1's bit for bit.
//
// Design: M = output pixels, N = output channels, K = KT^2 taps x Cin. A
// block (two warpgroups, one 16-pixel output row a warp) owns an 8 x
// 16-pixel output tile and every output channel, walked in tiles of at
// most N = 128 (w0's 192 as 2 x 96): the input patch is staged once for
// all of them, the first tile's stores drain under the second tile's
// MMAs, and N/2 <= 64 accumulators let two blocks share an SM.
//  * The patch ((TH + KT - 1) x (TW + KT - 1) pixels at offset -pad, 16/32/
//    64 channels a pass as Cin is <= 16, <= 32 or more, so a Cin-32 conv
//    stages no zeros) arrives by cp.async with zero-fill for the halo, the
//    ragged edge and the channels past Cin. Its pixel pitch is padded by 16
//    bytes, so each 8-row ldmatrix phase is conflict free. Each block also
//    prefetches into L2 the patch of the block one wave later, whose loads
//    then skip HBM.
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
//  * The epilogue (Epi) stages the tile's fragments in the block's own
//    shared buffer and writes it with 16-byte coalesced stores.
#pragma once

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

// What the mainloop reads; each kernel's Params adds its epilogue's.
struct ConvParams {
  const bf16* x;       // (N, H, W, Cin) input
  const bf16* wp;      // packed weights (pack_conv3x3_weights)
  int H, W, Cin, Cout, kp;   // kp: Cin rounded up to the pass width
  int tiles_x, vec;          // vec: channels a patch copy (8, 4 or 1)
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
// phase and each fragment access is conflict free. The ring has four
// slots, or three where four would keep two blocks off one SM.
// The patch of a pass: KS k-steps of 16 input channels (KC = 16 KS) at
// pixel pitch KC + 8, rows of TW + KT - 1 pixels.
template <int KS, int KT>
struct PatchGeom {
  static constexpr int KC = 16 * KS, PITCH = KC + 8;
  static constexpr int PW = TW + KT - 1;   // patch row, pixels
};

template <int N, int KS, int KT>
struct Smem {
  using G = PatchGeom<KS, KT>;
  static constexpr int KC = G::KC, PITCH = G::PITCH, PW = G::PW;
  static constexpr int SLAB = KC * N;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's committed cp.async groups
// (the newest ones) are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// Stage channels [c0, c0 + kc) of the ROWS x (TW + KT - 1) input patch
// at (oy - pad, ox - pad), VEC channels a copy, zero-filling out-of-image
// pixels and channels >= Cin; threads first, first + stride, ... share
// the copies (cp.async, or plain stores when VEC is 1).
template <int VEC, int KT, int ROWS>
__device__ void stage_patch(const ConvParams& p, bf16* patch, int pitch,
                            int n, int oy, int ox, int c0, int kc, int pad,
                            int first, int stride) {
  constexpr int PW = TW + KT - 1;
  const int nv = kc / VEC;
  for (int it = first; it < ROWS * PW * nv; it += stride) {
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

// Pass c of a patch of ROWS rows (K1: its tile's TH + KT - 1), the copies
// shared by threads first, first + stride, ...; the caller commits them.
template <int KS, int KT, int ROWS>
__device__ __forceinline__ void stage_pass(const ConvParams& p, bf16* patch,
                                           int n, int oy, int ox, int c,
                                           int pad, int first, int stride) {
  constexpr int KC = 16 * KS;
  switch (p.vec) {
    case 8: stage_patch<8, KT, ROWS>(p, patch, KC + 8, n, oy, ox, c * KC,
                                     KC, pad, first, stride);
            break;
    case 4: stage_patch<4, KT, ROWS>(p, patch, KC + 8, n, oy, ox, c * KC,
                                     KC, pad, first, stride);
            break;
    default: stage_patch<1, KT, ROWS>(p, patch, KC + 8, n, oy, ox, c * KC,
                                      KC, pad, first, stride);
  }
}

// This lane's ldmatrix row address at tap (0, 0) for a warp whose 16
// output pixels are patch row `row`: patch pixel (row, lane % 16),
// channels 8 (lane / 16) on.
template <int KS, int KT>
__device__ __forceinline__ uint32_t lane_a_addr(uint32_t patch_s, int row,
                                                int lane) {
  using G = PatchGeom<KS, KT>;
  return patch_s + ((row * G::PW + lane % 16) * G::PITCH + lane / 16 * 8) * 2;
}

// Tap t of a warpgroup's conv: A, this warp's 16 pixels (its output row,
// shifted by the tap) x 16 channels a k-step, by ldmatrix into `a`; B,
// the slab's k-steps at shared address bs by descriptor (K-major, no
// swizzle, core matrices 128 bytes apart along K, 256 along N); the KS
// MMAs committed as one group.
template <int N, int KS, int KT>
__device__ __forceinline__ void mma_tap(float (&acc)[N / 2],
                                        uint32_t (&a)[KS][4], uint32_t a_s,
                                        int t, uint32_t bs) {
  using G = PatchGeom<KS, KT>;
  const int tap_off = ((t / KT) * G::PW + t % KT) * G::PITCH * 2;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    nesr::ldsm_x4_at(a[kk], a_s + tap_off + kk * 32);
  nesr::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    nesr::wgmma_rs<N>(acc, a[kk], nesr::wgmma_desc(bs + kk * 32 * N, 128,
                                                   256));
  nesr::wgmma_commit();
}

// The conv of one block's tile. Epi, a struct of static device functions
// on its Params (a ConvParams), is the epilogue:
//   pad(p)                  the patch's offset (1: SAME);
//   stage<N>(p, tile, acc, warp, frow, q, co0)
//                           this thread's fp32 sums into the staging tile;
//   write<N>(p, tile, n, oy, ox, co0, nvalid)
//                           the staging tile out, after a barrier.
template <int N, int KS, int KT, class Epi>
__device__ __forceinline__ void conv_body(const typename Epi::P& p) {
  using S = Smem<N, KS, KT>;
  constexpr int STAGES = S::STAGES, T = KT * KT;
  const int pad = Epi::pad(p);
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem + S::OUT_OFF);
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
  const uint32_t a_s =
      lane_a_addr<KS, KT>(nesr::smem_u32(patch), warp, lane);
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
    // The patch of a pass is staged once and serves every N tile when
    // there is one pass; with more, each pass is staged again.
    const bool restage = nt == 0 || npass > 1;
    if (restage) {
      if (nt > 0) __syncthreads();   // every warp done reading the patch
      stage_pass<KS, KT, TH + KT - 1>(p, patch, n, oy, ox, 0, pad, tid,
                                      THREADS);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
    for (int c = 0; c < npass; ++c) {
      if (c > 0) {
        __syncthreads();   // every warp done reading the last pass
        stage_pass<KS, KT, TH + KT - 1>(p, patch, n, oy, ox, c, pad, tid,
                                        THREADS);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const int g0 = (nt * npass + c) * T;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int g = g0 + t, s = g % STAGES;
        nesr::mbar_wait(full_s + 8 * s, (g / STAGES) & 1);
        __syncwarp();
        mma_tap<N, KS, KT>(acc, a[t & 1], a_s, t, ring_s + s * S::SLAB * 2);
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

    // Epilogue of this N tile: the fragments into the staging tile (every
    // warp done storing the last N tile), then 16-byte stores, which drain
    // under the next N tile's MMAs.
    __syncthreads();
    const int co0 = nt * N;
    Epi::template stage<N>(p, tile, acc, warp, frow, q, co0);
    __syncthreads();
    Epi::template write<N>(p, tile, n, oy, ox, co0, min(N, p.Cout - co0));
  }
}

// Launch `kernel` over the (rows x p.tiles_x) output tiles of `batch`
// images with `smem` bytes of dynamic shared memory, two blocks an SM.
template <class P>
int launch_tiles(void (*kernel)(const P), int smem, P p, int rows,
                 int batch, cudaStream_t stream) {
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.tiles_x * ((rows + TH - 1) / TH), 1, batch);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  p.wave = 2 * sms;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
