// K1's head 3x3 form (conv3x3_head_kernel): the folded RRDBNet head's two
// 3x3 convs, up1 (nf -> 4 nf, stored depth-to-space) and up2 (nf -> 4 nf
// at twice the size), NHWC bf16 in, fp32 accumulate, bf16 out, with the
// fp32 bias, the JAX package's rounding (ROUND_FIRST: bf16(acc + b), then
// the LeakyReLU with 0.2 y rounded again) and the depth-to-space store
// (D2S: channel (2 oi + oj) D + f of pixel (r, s) to pixel (2r + oi, 2s +
// oj), channel f) in the epilogue. It replaces no Pallas kernel: the JAX
// package runs these convs as XLA convs in _head_forward
// (models/rrdbnet.py:586).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), on the path's
// 4 x 268^2 tiles: its operations, up1 (4 x 268^2 x 64 -> 256) 0.0857 ms
// and up2 (4 x 536^2) 0.3427 ms; its bytes are half of that, mostly the
// output (up2 writes 588 MB: 0.176 ms). The earlier form ran K1's SAME
// conv body (csrc/conv3x3_body.cuh) with the head's epilogue, 8 x 16
// pixels a block and two blocks an SM, at 29-32% of its bound: every
// block streamed both N tiles' 295 KB of weight slabs from L2 (2.69 GB a
// launch at up2) and ran its phases one after another (the patch staged
// synchronously, the second N tile's stores under none of its MMAs).
// This form:
//  * is persistent, one block an SM, and warp-specialised, 288 threads:
//    two consumer warpgroups and a producer warp. The blocks are split
//    between the N tiles (Cout 256: two of 128) and each keeps its N
//    tile's weights resident, 9 x 64 x 128 bf16 (147,456 bytes), loaded
//    once by bulk copies; x is then read once an N tile.
//  * Consumer c of block b walks 4 x 16-pixel tiles 2 (b' + i per_nt) + c
//    (b' the block's index among its N tile's), one m64 row block, one
//    16-pixel row a warp; the two take turns at the tensor cores (a pair
//    of named barriers), so one's epilogue and stores run under the
//    other's MMAs.
//  * The producer warp's lane 0 loads each tile's patch, a pass of 64
//    input channels at a time, as one TMA box of a 4-d map over the NHWC
//    input (72 channels x 18 x 6 at (oy - 1, ox - 1): the map's zero fill
//    is the SAME halo, the ragged edge and the channels past Cin, and the
//    box lands at K1's pixel pitch of 72), into a ring of three slots in
//    the consumers' order of use, on full/empty mbarriers.
//  * The MMAs are K1's (conv3x3_body.cuh: lane_a_addr, mma_tap), in K1's
//    K order (pass, tap, k16) and N tiles: the form equals K1's SAME conv
//    with the bias, then LeakyReLU in bf16, then depth-to-space, bit for
//    bit. The nine taps are unrolled and a pass's MMAs retire at its end,
//    so no wgmma is in flight across a runtime loop's back edge.
//  * The epilogue rounds the sums into the consumer's staging tile: 64
//    pixels x 64 channels a half, 128-byte rows swizzled as the TMA
//    map's 128-byte swizzle has them, so its stores are conflict free. One
//    thread then stores each half as one box of a tensor map over y: (Cout,
//    Wo, Ho, N) boxes of 64 x 16 x 4, or under D2S (2D, Wo, 2, Ho, N) boxes
//    of 64 x 16 x 1 x 4 (a half of an N tile is one oi row pair of output
//    pixels 2s, 2s + 1: 2D contiguous channels). The map clips the ragged
//    edge. Shapes without such a box (D % 32, Cout % 8 or N < 64) store
//    from the staging tile by 16-byte or scalar stores.
// N tiles of 8, 16, 64 or 128 (kernels/conv3x3.py: head_tile_width; the
// passes times N at most 128, so the weights fit: Cin up to 64 takes N
// 128, up to 128 N 64, up to 512 N 16, up to 1024 N 8).
// Shared memory (kernels/conv3x3.py: head_plan computes the same): [two
// staging tiles][the N tile's weights][three patch slots][barriers][bias].
#include <cuda.h>
#include <cudaTypedefs.h>

#include "conv3x3_body.cuh"

namespace {

constexpr int HTH = 4;                   // a tile: HTH x TW pixels
constexpr int HPX = HTH * TW;            // 64: one m64 row block
constexpr int HKC = 64;                  // input channels a pass
constexpr int HPITCH = HKC + 8;          // the patch's pixel pitch
constexpr int HPROWS = HTH + 2, HPCOLS = TW + 2;   // the patch: 6 x 18
constexpr int BOX_BYTES = HPROWS * HPCOLS * HPITCH * 2;
constexpr int SLOT = (BOX_BYTES + 127) / 128 * 128;
constexpr int SLOTS = 3;                 // patch slots, in order of use
constexpr int HEAD_THREADS = 2 * 128 + 32;
constexpr int MAX_SMEM = 232448;         // a block's dynamic shared memory
// Named barriers: 1 + c consumer c's own; HORD0 / HORD1 consumer 0 / 1
// may start its MMAs.
constexpr int HORD0 = 3, HORD1 = 4;
constexpr int HLRELU = 1, HROUND_FIRST = 2, HD2S = 8;   // flags

struct Params {
  const bf16* wp;      // pack_conv3x3_weights(w, head=True)
  const float* bias;   // may be null
  bf16* y;
  int H, W, Cin, Cout;     // Cin a multiple of 8 (the tensor map)
  int flags, D;            // LRELU, ROUND_FIRST, D2S; D = Cout / 4
  int tiles_x, tiles_y, tiles;   // 4 x 16 tiles along W, H, in all
  int n_tiles, npass;      // N tiles of Cout; 64-channel passes
  int per_nt;              // blocks an N tile (the grid: per_nt n_tiles)
  int tma_out, vec_out;    // stores by TMA boxes; else 16-byte stores
  int stg, w_off, p_off, bar_off, bias_off;   // shared-memory layout
};

struct Maps {
  CUtensorMap x;       // the patch boxes: 72 channels x 18 x 6
  CUtensorMap y;       // the output boxes (tma_out)
};

struct Layout {
  int stg, w_off, p_off, bar_off, bias_off, total;
};

// The layout of an N-wide launch with `npass` passes (head_plan in
// kernels/conv3x3.py computes the same).
Layout layout(int n, int npass) {
  Layout l;
  l.stg = round_up(HPX * n * 2, 1024);
  l.w_off = 2 * l.stg;
  l.p_off = round_up(l.w_off + npass * 9 * HKC * n * 2, 128);
  l.bar_off = l.p_off + SLOTS * SLOT;
  l.bias_off = l.bar_off + 8 * (2 * SLOTS + 1);
  l.total = l.bias_off + 4 * n;
  return l;
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// One bulk copy onto `bar`, whose bytes an earlier expect_tx announced.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One box of shared memory to a tensor map's tile, tracked by this
// thread's bulk groups.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store_5d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3,
                                             int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5, %6}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(c4) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Tiles of consumer c of a block that is the bb-th of its N tile's.
__device__ __forceinline__ int tile_count(const Params& p, int bb, int c) {
  const int first = 2 * bb + c, stride = 2 * p.per_nt;
  return first < p.tiles ? (p.tiles - first + stride - 1) / stride : 0;
}

// Image and origin of tile t (row-major in each image).
__device__ __forceinline__ void origin(const Params& p, int t, int& n,
                                       int& oy, int& ox) {
  const int per_img = p.tiles_x * p.tiles_y;
  n = t / per_img;
  const int r = t % per_img;
  oy = r / p.tiles_x * HTH;
  ox = r % p.tiles_x * TW;
}

// Byte offset of (pixel px, channel co) in an N-wide staging tile: for N
// >= 64, halves of 64 channels, each 64 pixel rows of 128 bytes whose
// 16-byte chunks are swizzled by the row (the TMA map's 128-byte
// swizzle); narrower, plain rows of N channels.
template <int N>
__device__ __forceinline__ int stg_at(int px, int co) {
  if constexpr (N >= 64) {
    return (co >> 6) * (HPX * 128) + px * 128 +
           ((((co >> 3) & 7) ^ (px & 7)) << 4) + (co & 7) * 2;
  } else {
    return (px * N + co) * 2;
  }
}

// Where output channel co of pixel (gy, gx) of image n is stored.
__device__ __forceinline__ size_t out_index(const Params& p, int n, int gy,
                                            int gx, int co) {
  if (p.flags & HD2S) {
    const int g = co / p.D, f = co - g * p.D;
    return (((size_t)n * 2 * p.H + 2 * gy + (g >> 1)) * 2 * p.W + 2 * gx +
            (g & 1)) * p.D + f;
  }
  return (((size_t)n * p.H + gy) * p.W + gx) * p.Cout + co;
}

// The loads and the MMAs, named so that tools/head_ablation.py can take
// each one out.
#define H3_LOAD_BOX(s, pc)                                                  \
  nesr::mbar_expect_tx(full_s + 8 * (s), BOX_BYTES);                        \
  nesr::tma_load_4d(p_s + (s) * SLOT, &m.x, (pc) * HKC, ox - 1, oy - 1, n,  \
                    full_s + 8 * (s))
#define H3_LOAD_WEIGHTS                                                     \
  for (int j = 0; j < p.npass * 9; ++j)                                     \
    bulk_copy(w_s + j * SLAB * 2, w + (size_t)j * SLAB, SLAB * 2, wfull_s)
#define H3_MMA_TAP(t)                                                       \
  mma_tap<N, 4, 3>(acc, a[(t) & 1], a_s, t, b0 + (t) * SLAB * 2)

// The producer warp's lane 0: the N tile's weights once, then each
// consumer's tiles in the block's order, a pass's box a slot.
template <int N>
__device__ void produce(const Params& p, const Maps& m, int nt, int bb,
                        uint32_t w_s, uint32_t p_s, uint32_t full_s,
                        uint32_t empty_s, uint32_t wfull_s) {
  constexpr int SLAB = HKC * N;   // elements a (pass, tap) slab
  const bf16* w = p.wp + (size_t)nt * p.npass * 9 * SLAB;
  nesr::mbar_expect_tx(wfull_s, p.npass * 9 * SLAB * 2);
  H3_LOAD_WEIGHTS;
  const int it[2] = {tile_count(p, bb, 0), tile_count(p, bb, 1)};
  int k = 0;
#pragma unroll 1
  for (int i = 0; i < it[0]; ++i) {
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
      if (i >= it[c]) continue;
      int n, oy, ox;
      origin(p, 2 * (bb + i * p.per_nt) + c, n, oy, ox);
#pragma unroll 1
      for (int pc = 0; pc < p.npass; ++pc, ++k) {
        const int s = k % SLOTS, u = k / SLOTS;
        if (u > 0) nesr::mbar_wait(empty_s + 8 * s, (u - 1) & 1);
        H3_LOAD_BOX(s, pc);
      }
    }
  }
}

// Bias, ROUND_FIRST, LeakyReLU of the sums into the staging tile (bf16).
template <int N>
__device__ __forceinline__ void stage_tile(const Params& p,
                                           unsigned char* stg,
                                           const float* sbias,
                                           const float (&acc)[N / 2],
                                           int warp, int lane) {
  const bool act = p.flags & HLRELU, first = p.flags & HROUND_FIRST;
  const int frow = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int co = 8 * j + 2 * q;
    const float b0 = sbias[co], b1 = sbias[co + 1];
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
          stg + stg_at<N>(warp * TW + frow + 8 * h, co)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The staging tile of output channels [c0, c0 + N) out, by TMA boxes from
// thread ct 0 or by every thread's 16-byte or scalar stores.
template <int N>
__device__ __forceinline__ void store_tile(const Params& p, const Maps& m,
                                           const unsigned char* stg, int n,
                                           int oy, int ox, int c0, int ct) {
  if (p.tma_out) {
    if (ct == 0) {
      const uint32_t s = nesr::smem_u32(stg);
      for (int h = 0; h < N / 64 && c0 + 64 * h < p.Cout; ++h) {
        const int cg = c0 + 64 * h;
        if (p.flags & HD2S) {
          const int oi = cg / (2 * p.D);
          tma_store_5d(&m.y, s + h * HPX * 128, cg - oi * 2 * p.D, ox, oi,
                       oy, n);
        } else {
          tma_store_4d(&m.y, s + h * HPX * 128, cg, ox, oy, n);
        }
      }
      bulk_commit();
    }
    return;
  }
  const int nvalid = min(N, p.Cout - c0);
  if (p.vec_out) {
    const int nv = nvalid / 8;
#pragma unroll 1
    for (int it = ct; it < HPX * nv; it += 128) {
      const int v = it % nv, px = it / nv;
      const int gy = oy + px / TW, gx = ox + px % TW;
      if (gy < p.H && gx < p.W)
        *reinterpret_cast<uint4*>(p.y + out_index(p, n, gy, gx, c0 + 8 * v)) =
            *reinterpret_cast<const uint4*>(stg + stg_at<N>(px, 8 * v));
    }
  } else {
#pragma unroll 1
    for (int it = ct; it < HPX * nvalid; it += 128) {
      const int v = it % nvalid, px = it / nvalid;
      const int gy = oy + px / TW, gx = ox + px % TW;
      if (gy < p.H && gx < p.W)
        p.y[out_index(p, n, gy, gx, c0 + v)] =
            *reinterpret_cast<const bf16*>(stg + stg_at<N>(px, v));
    }
  }
}

// Consumer c: its tiles, each the N tile's MMAs over every pass (K1's tap
// MMAs on the resident weights) in its turn at the tensor cores, then the
// epilogue while the partner computes.
template <int N>
__device__ void consume(const Params& p, const Maps& m, unsigned char* smem,
                        int c, int nt, int bb, uint32_t full_s,
                        uint32_t empty_s, uint32_t wfull_s) {
  constexpr int SLAB = HKC * N;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int ct = threadIdx.x % 128;
  const int it0 = tile_count(p, bb, 0), it1 = tile_count(p, bb, 1);
  const int iters = c ? it1 : it0;
  const int c0 = nt * N;
  unsigned char* stg = smem + c * p.stg;
  const float* sbias = reinterpret_cast<const float*>(smem + p.bias_off);
  const uint32_t w_s = nesr::smem_u32(smem) + p.w_off;
  const uint32_t p_s = nesr::smem_u32(smem) + p.p_off;
  float acc[N / 2];
  // A fragments, double-buffered by tap parity (as K1's).
  uint32_t a[2][4][4];
  nesr::mbar_wait(wfull_s, 0);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    int n, oy, ox;
    origin(p, 2 * (bb + i * p.per_nt) + c, n, oy, ox);
    // My turn at the tensor cores: consumer 0 after consumer 1's last
    // phase, consumer 1 after consumer 0's of this round.
    if (c == 1 || i > 0) named_sync(c ? HORD1 : HORD0, 256);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int pc = 0; pc < p.npass; ++pc) {
      const int k = (2 * i + c) * p.npass + pc, s = k % SLOTS;
      nesr::mbar_wait(full_s + 8 * s, (k / SLOTS) & 1);
      const uint32_t a_s = lane_a_addr<4, 3>(p_s + s * SLOT, warp, lane);
      const uint32_t b0 = w_s + pc * 9 * SLAB * 2;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        H3_MMA_TAP(t);
        if (t > 0) nesr::wgmma_wait<1>();
      }
      nesr::wgmma_wait<0>();
      // The slot back to the producer: one arrival a warp.
      __syncwarp();
      if (lane == 0) nesr::mbar_arrive(empty_s + 8 * s);
    }
#pragma unroll
    for (int j = 0; j < N / 2; ++j) nesr::reg_fence(acc[j]);
    // The partner's turn, if it has another tile.
    if (c ? it0 > i + 1 : it1 > i) named_arrive(c ? HORD0 : HORD1, 256);
    // The epilogue: the last tile's boxes done reading the staging tile,
    // the sums into it, then its stores.
    if (ct == 0) bulk_wait_read();
    named_sync(1 + c, 128);
    stage_tile<N>(p, stg, sbias, acc, warp, lane);
    if (p.tma_out) nesr::fence_proxy_async();
    named_sync(1 + c, 128);
    store_tile<N>(p, m, stg, n, oy, ox, c0, ct);
  }
  if (ct == 0) bulk_wait();   // every box written before the block exits
}

template <int N>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
conv3x3_head_kernel(const __grid_constant__ Maps m, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int nt = blockIdx.x % p.n_tiles, bb = blockIdx.x / p.n_tiles;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  const uint32_t full_s = nesr::smem_u32(bars);
  const uint32_t empty_s = full_s + 8 * SLOTS, wfull_s = empty_s + 8 * SLOTS;
  // The N tile's biases (zero past Cout or without a bias).
  float* sbias = reinterpret_cast<float*>(smem + p.bias_off);
  for (int j = tid; j < N; j += HEAD_THREADS) {
    const int co = nt * N + j;
    sbias[j] = p.bias != nullptr && co < p.Cout ? p.bias[co] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      nesr::mbar_init(&bars[s], 1);          // the producer's lane 0
      nesr::mbar_init(&bars[SLOTS + s], 4);  // a consumer's warps
    }
    nesr::mbar_init(&bars[2 * SLOTS], 1);
    nesr::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 8) {
    if (tid % 32 == 0)
      produce<N>(p, m, nt, bb, nesr::smem_u32(smem) + p.w_off,
                 nesr::smem_u32(smem) + p.p_off, full_s, empty_s, wfull_s);
  } else {
    consume<N>(p, m, smem, warp / 4, nt, bb, full_s, empty_s, wfull_s);
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

// A bf16 tensor map of `rank` dims (inner first, byte strides of dims 1
// on) with boxes `box`; zeros read past every edge, nothing written past
// one.
int make_map(CUtensorMap* map, const void* t, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(t), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// The patch boxes' map over x (Cin, W, H, N), and under tma_out the
// output boxes' over y: (Cout, Wo, Ho, N), or under D2S the pair view of
// the (N, 2H, 2W, D) output, (2D, W, 2, H, N).
int make_maps(Maps& m, const void* x, const void* y, const Params& p,
              int N) {
  const cuuint64_t xd[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W,
                            (cuuint64_t)p.H, (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)p.Cin * 2,
                            (cuuint64_t)p.W * p.Cin * 2,
                            (cuuint64_t)p.H * p.W * p.Cin * 2};
  const cuuint32_t xb[4] = {HPITCH, HPCOLS, HPROWS, 1};
  int err = make_map(&m.x, x, 4, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err || !p.tma_out) return err;
  if (p.flags & HD2S) {
    const cuuint64_t row = (cuuint64_t)p.W * 2 * p.D * 2;   // bytes
    const cuuint64_t yd[5] = {(cuuint64_t)2 * p.D, (cuuint64_t)p.W, 2,
                              (cuuint64_t)p.H, (cuuint64_t)N};
    const cuuint64_t ys[4] = {(cuuint64_t)2 * p.D * 2, row, 2 * row,
                              2 * row * p.H};
    const cuuint32_t yb[5] = {64, TW, 1, HTH, 1};
    return make_map(&m.y, y, 5, yd, ys, yb, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const cuuint64_t yd[4] = {(cuuint64_t)p.Cout, (cuuint64_t)p.W,
                            (cuuint64_t)p.H, (cuuint64_t)N};
  const cuuint64_t ys[3] = {(cuuint64_t)p.Cout * 2,
                            (cuuint64_t)p.W * p.Cout * 2,
                            (cuuint64_t)p.H * p.W * p.Cout * 2};
  const cuuint32_t yb[4] = {64, TW, HTH, 1};
  return make_map(&m.y, y, 4, yd, ys, yb, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int N>
int launch(const Maps& m, const Params& p, int grid, int smem,
           cudaStream_t stream) {
  // Set per call: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_head_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  conv3x3_head_kernel<N><<<grid, HEAD_THREADS, smem, stream>>>(m, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The head 3x3 form: x (N, H, W, Cin) bf16 with Cin % 8 == 0 and x
// 16-byte aligned (the tensor map), wp = pack_conv3x3_weights(w,
// head=True) in N tiles of n_width (8, 16, 64 or 128; the 64-channel
// passes times n_width at most 128), bias (Cout,) fp32 or null, y (N, H,
// W, Cout) or under D2S (N, 2H, 2W, Cout / 4), 16-byte aligned; flags
// LRELU 1, ROUND_FIRST 2, D2S 8 (Cout % 4 == 0). grid and smem are the
// launch kernels/conv3x3.py:head_plan chose: blocks (a multiple of the N
// tiles) and dynamic shared memory, which must be this layout's.
extern "C" int nesr_conv3x3_head(const void* x, const void* wp,
                                 const void* bias, void* y, int N, int H,
                                 int W, int Cin, int Cout, int n_width,
                                 int flags, int grid, int smem,
                                 void* stream) {
  Params p;
  p.wp = (const bf16*)wp;
  p.bias = (const float*)bias;
  p.y = (bf16*)y;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.flags = flags;
  p.D = Cout / 4;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + HTH - 1) / HTH;
  p.tiles = N * p.tiles_x * p.tiles_y;
  p.n_tiles = (Cout + n_width - 1) / n_width;
  p.npass = (Cin + HKC - 1) / HKC;
  p.per_nt = p.n_tiles > 0 ? grid / p.n_tiles : 0;
  const bool d2s = flags & HD2S;
  p.vec_out = Cout % 8 == 0 && (!d2s || p.D % 8 == 0);
  p.tma_out = n_width >= 64 && (d2s ? p.D % 32 == 0 : Cout % 8 == 0) &&
              ((uintptr_t)y & 15) == 0;
  const Layout l = layout(n_width, p.npass);
  p.stg = l.stg;
  p.w_off = l.w_off;
  p.p_off = l.p_off;
  p.bar_off = l.bar_off;
  p.bias_off = l.bias_off;
  const bool ok =
      !(flags & ~(HLRELU | HROUND_FIRST | HD2S)) && (!d2s || Cout % 4 == 0) &&
      Cin % 8 == 0 && ((uintptr_t)x & 15) == 0 && N >= 1 && H >= 1 &&
      W >= 1 && p.npass * n_width <= 128 && p.per_nt >= 1 &&
      grid == p.per_nt * p.n_tiles && 2 * (p.per_nt - 1) < p.tiles &&
      l.total == smem && smem <= MAX_SMEM;
  if (!ok) return (int)cudaErrorInvalidValue;
  Maps m;
  const int err = make_maps(m, x, y, p, N);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_width) {
    case 8: return launch<8>(m, p, grid, smem, s);
    case 16: return launch<16>(m, p, grid, smem, s);
    case 64: return launch<64>(m, p, grid, smem, s);
    case 128: return launch<128>(m, p, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
