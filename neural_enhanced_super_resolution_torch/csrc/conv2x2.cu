// K1's 2x2 form (conv2x2_kernel): the folded RRDBNet head's two
// space-to-depth convs, conv_hr and conv_last folded into 2x2 convs over
// 4 x 64 channels, NHWC bf16 in, fp32 accumulate, bf16 out, with the fp32
// bias, the JAX package's rounding (ROUND_FIRST: bf16 before the
// LeakyReLU, 0.2 y rounded again), the frame mask (MASK) and the
// depth-to-space store (D2S) in the epilogue, as csrc/conv3x3.cu's head
// forms define them. It replaces no Pallas kernel: the JAX package runs
// these convs as XLA convs in _head_forward (models/rrdbnet.py:586).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), on the path's
// 4 x 268^2 tiles: hr (4 x 536^2 x 256 -> 256 at padding 1) by its 605
// GFLOP (0.611 ms); last (4 x 537^2 x 256 -> 12 VALID) by its bytes, the
// 590 MB hr output it reads (0.185 ms). The earlier form ran K1's SAME-conv
// body with two taps, and a block of 8 x 16 outputs restaged its patch,
// synchronously, for each of 8 (N tile, pass) pairs: staging it once took
// hr from 2.09 to 1.65 ms and last from 0.565 to 0.340, while hr without
// its MMAs still took 1.93 (tools/head_ablation.py, PERF.md). This form:
//  * The patch of a 64-channel pass is one TMA box of the NHWC input, 9 x
//    17 pixels at (oy - pad, ox - pad), swizzled over 128 bytes (a pixel's
//    64 channels are one 128-byte row); the tensor map's zero fill past
//    every edge is the padding-1 halo, the ragged edge and the channels
//    past Cin. Two passes are in flight, each box on its own full and
//    empty barrier, staged once for every output channel of the block.
//  * The weights, packed as (pass, tap) slabs of 64 x N (pack_conv2x2_
//    weights, the wgmma B image), come by bulk copy through a ring of
//    full/empty barriers. Thread 0 refills a slot two slabs after every
//    warp released it and loads each box a pass ahead, so the K walk (4
//    taps x Cin) runs with no block barrier.
//  * A block is two warpgroups, one 16-pixel output row a warp (8 x 16
//    outputs), and one N tile (m64nNk16; N 128 at hr, Cout 256 as two
//    tiles that are neighbours in the grid, so the second reads the patch
//    from L2; N 16 at last). A, each warp's 16 pixels shifted by the tap,
//    comes from the swizzled box by ldmatrix, double-buffered by k-step;
//    B from the ring by descriptor (K-major, no swizzle: core matrices 128
//    bytes apart along K, 256 along N). A pass's 16 k-steps are unrolled
//    and its MMAs retire at its end: with a wgmma in flight across a
//    runtime loop's back edge, ptxas serialized them all.
//  * Two blocks an SM at hr (104 KB: two boxes, four 16 KB slabs), three
//    at last (74 KB: all 16 slabs of 2 KB stay in the ring), so one
//    block's loads and epilogue overlap another's MMAs: hr's global stores
//    alone were a quarter of its time on one block an SM of 16 x 16
//    pixels, which halves the weight traffic (1.36-1.45 ms; two blocks of
//    8 x 16 pixels: 1.21-1.24).
//  * The epilogue (bias, ROUND_FIRST, LeakyReLU, the frame mask, d2s)
//    stages the tile over the boxes, then stores it with 16-byte coalesced
//    stores (channel by channel where a channel group of the depth-to-space
//    store is not a multiple of 8, as at last).
// Tried and dropped (PERF.md), each slower at hr: multicasting the
// weight slabs to a cluster of two blocks, a producer warp beside 16
// consumer warps (95 registers a thread, spills), a persistent walk over
// tiles storing the epilogue from registers, and TMA stores of the tile.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using nesr::bf16;

constexpr int WARPS = 8, THREADS = WARPS * 32;   // two warpgroups
constexpr int TH = WARPS, TW = 16;   // output tile: a row a warp
constexpr int PH = TH + 1, PW = TW + 1;   // the patch box
constexpr int KC = 64;                    // input channels a pass (a box)
constexpr int BOX = PH * PW * KC * 2;     // a box's bytes
constexpr int BOX_SLOT = (BOX + 1023) / 1024 * 1024;
constexpr int PSLOTS = 2;                 // passes in flight
constexpr int LRELU = 1, ROUND_FIRST = 2, MASK = 4, D2S = 8;

// Per width N: the ring (STAGES slabs of 64 x N) and the blocks an SM.
// Shared memory: [PSLOTS boxes] [ring] [full, empty, box full, box empty
// barriers]; the output tile is staged over the boxes.
template <int N>
struct Cfg {
  static constexpr int SLAB = KC * N * 2;
  static constexpr int STAGES = N == 16 ? 16 : 4;
  static constexpr int BLOCKS = N == 16 ? 3 : 2;
  static constexpr int RING_OFF = PSLOTS * BOX_SLOT;
  static constexpr int BAR_OFF = RING_OFF + STAGES * SLAB;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 2 * PSLOTS) * 8;
  static_assert(TH * TW * (N + 8) * 2 <= RING_OFF, "output tile");
  static_assert(BLOCKS * (BYTES + 1024) <= 233472, "blocks an SM");
};

struct Params {
  const bf16* wp;      // pack_conv2x2_weights
  const float* bias;   // may be null
  bf16* y;
  int N, H, W, Cin, Cout, Ho, Wo, pad;
  int flags, D;        // epilogue flags; D = Cout / 4 (MASK, D2S)
  int tiles_x, tiles;  // output tiles along Wo, and in all images
  int n_tiles;         // N tiles of Cout
  int npass;           // 64-channel passes (Cin / 64, rounded up)
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

// The loads and the MMAs, named so that tools/head_ablation.py can take
// each one out.
#define W2_LOAD_BOX(c)                                                      \
  nesr::mbar_expect_tx(pfull_s + 8 * ((c) % PSLOTS), BOX);                  \
  nesr::tma_load_4d(patch_s + (c) % PSLOTS * BOX_SLOT, &map, (c) * KC,      \
                    ox - pad, oy - pad, n, pfull_s + 8 * ((c) % PSLOTS))
#define W2_SKIP_BOX(c) nesr::mbar_arrive(pfull_s + 8 * ((c) % PSLOTS))
#define W2_LOAD_SLAB(g)                                                     \
  nesr::bulk_load(ring_s + (g) % C::STAGES * C::SLAB,                       \
                  wp + (size_t)(g) * KC * N, C::SLAB,                       \
                  full_s + 8 * ((g) % C::STAGES))
#define W2_SKIP_SLAB(g) nesr::mbar_arrive(full_s + 8 * ((g) % C::STAGES))
#define W2_MMA                                                              \
  nesr::wgmma_rs<N>(acc, a[kk & 1],                                         \
                    nesr::wgmma_desc(bs + kk * 32 * N, 128, 256))

template <int N>
__global__ void __launch_bounds__(THREADS, Cfg<N>::BLOCKS)
conv2x2_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  using C = Cfg<N>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t patch_s = nesr::smem_u32(smem);
  const uint32_t ring_s = patch_s + C::RING_OFF;
  const uint32_t full_s = patch_s + C::BAR_OFF;
  const uint32_t empty_s = full_s + 8 * C::STAGES;
  const uint32_t pfull_s = empty_s + 8 * C::STAGES;
  const uint32_t pempty_s = pfull_s + 8 * PSLOTS;

  // The block's N tile and output tile: the N tiles of an output tile are
  // neighbours in the grid, so all but the first read the patch from L2.
  const int nt = blockIdx.x % p.n_tiles, t = blockIdx.x / p.n_tiles;
  const int per_image = p.tiles / p.N;
  const int n = t / per_image, tt = t % per_image;
  const int oy = tt / p.tiles_x * TH, ox = tt % p.tiles_x * TW;
  const int pad = p.pad;
  const int total = p.npass * 4;   // slabs of this N tile
  const bf16* wp = p.wp + (size_t)nt * total * KC * N;

  if (tid == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
    for (int s = 0; s < C::STAGES; ++s) {
      nesr::mbar_init(bars + s, 1);
      nesr::mbar_init(bars + C::STAGES + s, WARPS);
    }
    for (int s = 0; s < PSLOTS; ++s) {
      nesr::mbar_init(bars + 2 * C::STAGES + s, 1);
      nesr::mbar_init(bars + 2 * C::STAGES + PSLOTS + s, WARPS);
    }
    nesr::mbar_init_fence();
  }
  __syncthreads();
  // Thread 0 loads: the first boxes and slabs now, then each box a pass
  // ahead and each slab once every warp released the one STAGES earlier.
  if (tid == 0) {
    for (int c = 0; c < p.npass && c < PSLOTS; ++c) {
      W2_LOAD_BOX(c);
    }
    for (int g = 0; g < total && g < C::STAGES; ++g) {
      W2_LOAD_SLAB(g);
    }
  }

  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  // A fragments, double-buffered by k-step: k-step k loads while k-1
  // multiplies.
  uint32_t a[2][4];
  // Warp `warp` is done with slab g (its MMAs retired): its slot, and
  // after a pass's last tap its box, go back.
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) {
      nesr::mbar_arrive(empty_s + 8 * (g % C::STAGES));
      if (g % 4 == 3) nesr::mbar_arrive(pempty_s + 8 * (g / 4 % PSLOTS));
    }
  };
  // A pass's 16 k-steps are unrolled and its MMAs retire at its end, so no
  // wgmma is in flight across the loop's back edge (ptxas serializes
  // wgmma whose input registers are written inside such a span).
  for (int c = 0; c < p.npass; ++c) {
    nesr::mbar_wait(pfull_s + 8 * (c % PSLOTS), (c / PSLOTS) & 1);
    const uint32_t box = patch_s + c % PSLOTS * BOX_SLOT;
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int g = 4 * c + tap, s = g % C::STAGES;
      nesr::mbar_wait(full_s + 8 * s, (g / C::STAGES) & 1);
      // This lane's A row: box pixel (warp + ky, lane % 16 + kx); the
      // box's 16-byte chunks are swizzled by the pixel's index mod 8.
      const int px = (warp + tap / 2) * PW + tap % 2 + lane % 16;
      const uint32_t row = box + px * 128;
      const uint32_t bs = ring_s + s * C::SLAB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        nesr::ldsm_x4_at(a[kk & 1],
                         row + (((2 * kk + lane / 16) ^ (px & 7)) << 4));
        nesr::wgmma_fence();
        W2_MMA;
        nesr::wgmma_commit();
        // The previous k-step's MMA has retired once at most this one's
        // is in flight: its A set is free, and at kk 0 so is slab g-1.
        nesr::wgmma_wait<1>();
        if (kk == 0 && tap > 0) release(g - 1);
      }
      if (tid == 0) {
        // slab g-2+STAGES into the slot every warp released with slab g-2
        if (g >= 2 && g - 2 + C::STAGES < total) {
          nesr::mbar_wait(empty_s + 8 * ((g - 2) % C::STAGES),
                          ((g - 2) / C::STAGES) & 1);
          W2_LOAD_SLAB(g - 2 + C::STAGES);
        }
        // pass c-1+PSLOTS's box into the slot pass c-1 left
        if (tap == 0 && c >= 1 && c - 1 + PSLOTS < p.npass) {
          nesr::mbar_wait(pempty_s + 8 * ((c - 1) % PSLOTS),
                          ((c - 1) / PSLOTS) & 1);
          W2_LOAD_BOX(c - 1 + PSLOTS);
        }
      }
    }
    nesr::wgmma_wait<0>();
    release(4 * c + 3);
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);

  // Epilogue: bias, ROUND_FIRST, LeakyReLU, bf16; the tile staged over the
  // boxes (every warp is done reading them), then stored with the frame
  // mask and the depth-to-space map.
  __syncthreads();
  bf16* out = reinterpret_cast<bf16*>(smem);
  const int co0 = nt * N;
  const bool act = p.flags & LRELU, first = p.flags & ROUND_FIRST;
  const int frow = lane / 4, q = lane % 4;
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
  if (p.vec_out) {
    const int nv = nvalid / 8;
    for (int it = tid; it < TH * TW * nv; it += THREADS) {
      const int v = it % nv, px = it / nv;
      const int gy = oy + px / TW, gx = ox + px % TW, co = co0 + 8 * v;
      if (gy < p.Ho && gx < p.Wo)
        *reinterpret_cast<uint4*>(p.y + out_index(p, n, gy, gx, co)) =
            kept(p, gy, gx, co)
                ? *reinterpret_cast<const uint4*>(out + px * (N + 8) + 8 * v)
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

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so the library links against the CUDA runtime alone.
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* q = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &q,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      q = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(q);
  }();
  return fn;
}

template <int N>
int launch(const CUtensorMap& map, const Params& p, cudaStream_t stream) {
  using C = Cfg<N>;
  const auto kernel = conv2x2_kernel<N>;
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.tiles * p.n_tiles, THREADS, C::BYTES, stream>>>(map, p);
  return (int)cudaGetLastError();
}

// The patch boxes' tensor map over the NHWC bf16 input (Cin, W, H, N):
// boxes of (64 channels, 17 pixels, 9 rows, 1 image), swizzled over 128
// bytes, zeros past every edge.
int make_map(CUtensorMap* map, const void* x, int Cin, int W, int H,
             int N) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W,
                              (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2,
                                 (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[4] = {KC, PW, PH, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

}  // namespace

// 2x2 conv at padding `pad` (0 or 1): x (N, H, W, Cin) bf16 with Cin % 8
// == 0 and x 16-byte aligned (the tensor map's strides and base), wp the
// packed weights (pack_conv2x2_weights: N tiles of n_width, one of 16, 64,
// 128), y (N, H + 2 pad - 1, W + 2 pad - 1, Cout) or its depth-to-space
// form under D2S; flags as csrc/conv3x3.cu's (LRELU 1, ROUND_FIRST 2, MASK
// 4, D2S 8; MASK and D2S need Cout % 4 == 0).
extern "C" int nesr_conv2x2(const void* x, const void* wp, const void* bias,
                            void* y, int N, int H, int W, int Cin, int Cout,
                            int n_width, int pad, int flags, void* stream) {
  if ((flags & ~(LRELU | ROUND_FIRST | MASK | D2S)) ||
      ((flags & (MASK | D2S)) && Cout % 4) || (pad != 0 && pad != 1) ||
      Cin % 8 || ((uintptr_t)x & 15))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.wp = (const bf16*)wp;
  p.bias = (const float*)bias;
  p.y = (bf16*)y;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.pad = pad;
  p.Ho = H + 2 * pad - 1;
  p.Wo = W + 2 * pad - 1;
  if (p.Ho < 1 || p.Wo < 1) return (int)cudaErrorInvalidValue;
  p.flags = flags;
  p.D = Cout / 4;
  p.tiles_x = (p.Wo + TW - 1) / TW;
  p.tiles = N * p.tiles_x * ((p.Ho + TH - 1) / TH);
  p.n_tiles = (Cout + n_width - 1) / n_width;
  p.npass = (Cin + KC - 1) / KC;
  p.vec_out = Cout % 8 == 0 && (!(flags & (MASK | D2S)) || p.D % 8 == 0);
  CUtensorMap map;
  const int err = make_map(&map, x, Cin, W, H, N);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_width) {
    case 16: return launch<16>(map, p, s);
    case 64: return launch<64>(map, p, s);
    case 128: return launch<128>(map, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
