// K4 step: one conv of the int8 residual dense block with its input's
// per-tensor quantisation in the patch load and its share of the dense-block
// assembly in the epilogue. Five launches an RDB (k = 0..4) compute the
// JAX package's _rdb_fused_int8
// (neural_enhanced_super_resolution_tpu/models/rrdbnet.py:240-280): conv_q
// (:255, XLA's int8 conv with int32 sums, not a Pallas kernel), the
// quantise before it and the float32 assembly after it, with the same
// rounding points, so the trunk equals the composition quantize_int8 ->
// conv3x3_int8 -> PyTorch assembly bit for bit (kernels/conv3x3_int8.py:
// conv3x3_int8_rdb_plain is that composition, one step at a time). The
// library is built without --use_fast_math; every rounding below is an
// IEEE one (__fdiv_rn, __fmul_rn, __fadd_rn, round-to-nearest-even casts).
//
// Step k reads its source h (k 0: the RDB input x in x's dtype; k >= 1:
// x_k in float32) and the raw max|h| (a float >= 0; s = max(raw, 1e-8)),
// quantises each element as q = clamp(rint(h * (127 / s)), -127, 127)
// while it stages the patch, and dequantises the int32 sums to
// c = bf16(float(acc) * ((s / 127) * w_s[co])). Conv k's output channel j
// belongs to assembly slot channel k g + j of the bf16 slot buffer (N, H,
// W, 4g + nf), laid out as conv 0's output: its first g channels complete
// slot k + 1 and give x_{k+1} = lrelu(float(bf16(slot + c)) + b) in
// float32; the rest are added into the slots, bf16(float(slot) + float(c)),
// conv 0 first, as PyTorch's bf16 adds run. Step 4 completes x5 = bf16(slot5
// + c4) and writes out = x + 0.2 * (x5 + b), each op rounded to x's dtype,
// and with `skip` (the RRDB input, for an RRDB's third RDB) skip + 0.2 *
// out: the RRDB's residual. Each step also takes the max
// of |what it writes| in each block (warp shuffles on the float's bits,
// which order like the values since they are >= 0) and issues one
// atomicMax into the next step's raw scale; nesr_int8_amax zeroes the
// chain of scales and fills the first one.
//
// What bounds it on an H100 (1,979 TOP/s int8, 3.35 TB/s), all five
// steps of an RDB on the 4 x 268 x 268 tile batch (nf 64, g 32): bytes,
// 3,200 a pixel (the float sources, the slots read and written, x1..x4
// written, x read twice and out written), 0.274 ms an RDB, against 0.070
// ms of int8 operations. A tile's phases (patch, MMAs, epilogue) run one
// after the other, each short of the card's memory or tensor rate alone;
// what hides one phase is another tile's different phase, so the design
// keeps four tiles in flight an SM (tools/k4_step_ablation.py times each
// phase and the step without it).
//
// Design: K4's (csrc/conv3x3_int8.cu) implicit GEMM, persistent, with each
// warpgroup of a block a worker of its own: it walks its own 4 x 16-pixel
// tiles (one 16-pixel output row a warp, every output channel in N tiles
// of at most 128) with its own named barrier and staging, so that one
// worker's loads and epilogue overlap the other's MMAs. The two share the
// weights:
//  * The patch (6 x 18 pixels, 32 or 64 channels a pass) arrives as it
//    stands in the source's type by 16-byte cp.async into a raw buffer
//    while the worker is on its previous tile, and is quantised from
//    there into the conflict-free int8 layout ldmatrix reads (pixel pitch
//    KC + 16 bytes). A source wider than 128 bytes a pixel (float32 with
//    64 channels) or of several passes goes through registers instead.
//  * Weights as pack_conv3x3_int8_weights lays them out. A Cin <= 32 conv
//    takes all nine taps of an N tile as one slab (9 x 32 x N bytes), and
//    when every N tile fits in the ring (w1..w4 of the trunk) the slabs
//    are loaded once a block and stay: one mbarrier wait, then nine
//    MMAs, and each worker goes its own pace. A wider conv (w0) streams
//    one slab a tap (64 x N) through a ring of four with full/empty
//    mbarriers that both workers walk and release, which keeps them
//    within a few taps of each other there.
//  * wgmma.mma_async m64nNk32.s32.s8.s8: A from registers (ldmatrix), B
//    from the ring by descriptor, int32 accumulators.
//  * Before an N tile's MMAs, cp.async brings the slots it adds to into
//    the output staging tile; each thread then adds its dequantised
//    fragment there in place, and the tile leaves with 16-byte stores
//    (x_{k+1} in float32, the slots in bf16, out in x's dtype).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using nesr::bf16;

constexpr int TW = 16;   // output columns per tile = one warp's M rows
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WG_THREADS = 128;   // a worker: one warpgroup
constexpr int TH = 4;             // a worker's tile: 4 rows, a warp each
constexpr int PX = TH * TW;
constexpr int PATCH_PX = (TH + 2) * (TW + 2);
constexpr int SM_SMEM = 233472;   // shared memory of an H100 SM (228 KB)
constexpr int RAW_PITCH = 128;    // bytes a pixel of the raw patch

struct Params {
  const void* src;       // (N, H, W, Cin): x (k 0) or x_k (float32)
  const int8_t* wp;      // packed weights (pack_conv3x3_int8_weights)
  const float* w_s;      // (Cout,) weight scales
  const float* bias;     // (cs,) the RDB's biases, conv1..conv5
  const float* s_src;    // raw max|src|
  int* s_out;            // raw max of what this step writes, float bits
  bf16* slots;           // (N, H, W, cs) bf16 assembly slots
  float* xn;             // k < 4: x_{k+1}, (N, H, W, g) float32
  const void* x;         // k 4: the RDB input, x's dtype
  const void* skip;      // k 4: the RRDB input or null
  void* out;             // k 4: (N, H, W, nf), x's dtype
  int H, W, Cin, Cout, kp, k, g, cs;   // kp: Cin padded to the pass width
  int tiles_x, tiles, n_tiles;   // tiles: spatial tiles of the batch
  int src_bf16, x_bf16, vec;     // vec: 16-byte paths
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared memory: [weight ring] [worker 0: output tile, patch, raw patch,
// the N tile's dequantisation scales and biases] [worker 1: the same]
// [warp maxima] [full bars] [empty bars]. A pass is KS k-steps of 32
// input channels; a slab holds TPS taps of one pass of one N tile.
template <int N, int KS>
struct Smem {
  static constexpr int KC = 32 * KS, PITCH = KC + 16;
  static constexpr int TPS = KS == 1 ? 9 : 1;
  static constexpr int SLAB = TPS * KC * N;
  static constexpr int OUT = PX * (N + 8) * 2;
  static constexpr int PATCH = round_up(PATCH_PX * PITCH, 16);
  static constexpr int RAW = PATCH_PX * RAW_PITCH;
  static constexpr int COLS = 2 * N * 4;
  static constexpr int WORKER = OUT + PATCH + RAW + COLS;
  static constexpr int FIXED = 2 * WORKER + 64;
  static constexpr bool fits(int s) {
    return 2 * (s * SLAB + FIXED + 16 * s + 1024) <= SM_SMEM;
  }
  static constexpr int STAGES = fits(4) ? 4 : fits(3) ? 3 : fits(2) ? 2 : 1;
  static constexpr int WORKER_OFF = STAGES * SLAB;
  static constexpr int PATCH_OFF = OUT, RAW_OFF = OUT + PATCH;
  static constexpr int COLS_OFF = RAW_OFF + RAW;
  static constexpr int RED_OFF = WORKER_OFF + 2 * WORKER;
  static constexpr int BAR_OFF = RED_OFF + 64;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES;
  static_assert(fits(1), "K4 step: two blocks an SM");
};

// This thread's index in its worker (warpgroup).
__device__ __forceinline__ int wtid() { return threadIdx.x % WG_THREADS; }

// Barrier of one worker's 128 threads (named barrier 1 or 2).
__device__ __forceinline__ void worker_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's committed cp.async groups
// (the newest ones) are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// q = clamp(rint(h * r), -127, 127): cvt.rni rounds half to even.
__device__ __forceinline__ uint32_t quant(float h, float r) {
  const int v = __float2int_rn(__fmul_rn(h, r));
  return (uint32_t)(uint8_t)(int8_t)max(-127, min(127, v));
}

__device__ __forceinline__ uint32_t quant4(float a, float b, float c,
                                           float d, float r) {
  return quant(a, r) | quant(b, r) << 8 | quant(c, r) << 16 |
         quant(d, r) << 24;
}

__device__ __forceinline__ float bf16_bits_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_bits_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void store_q(int8_t* dst, uint4 v, float r,
                                        bool is_bf16) {
  if (!is_bf16) {
    *reinterpret_cast<uint32_t*>(dst) =
        quant4(__uint_as_float(v.x), __uint_as_float(v.y),
               __uint_as_float(v.z), __uint_as_float(v.w), r);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        quant4(bf16_bits_lo(v.x), bf16_bits_hi(v.x), bf16_bits_lo(v.y),
               bf16_bits_hi(v.y), r),
        quant4(bf16_bits_lo(v.z), bf16_bits_hi(v.z), bf16_bits_lo(v.w),
               bf16_bits_hi(v.w), r));
  }
}

// The raw patch: channels [0, KC) of the (TH+2) x (TW+2) input pixels of
// a tile, RAW_PITCH bytes a pixel (KC x the source's E-element 16-byte
// vectors, <= 128 bytes), by 16-byte cp.async with zero fill for
// out-of-image pixels and channels >= Cin (Cin a multiple of E here). It
// lands while the block works on the tile before.
template <int KC, int E>
__device__ __forceinline__ void load_raw(const Params& p, unsigned char* raw,
                                         int n, int oy, int ox) {
  constexpr int NV = KC / E;
  const char* src = static_cast<const char*>(p.src);
  for (int it = wtid(); it < PATCH_PX * NV; it += WG_THREADS) {
    const int px = it / NV, ch = it % NV * E;
    const int gy = oy - 1 + px / (TW + 2), gx = ox - 1 + px % (TW + 2);
    const bool ok =
        gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && ch < p.Cin;
    const char* g = ok ? src + (((size_t)(n * p.H + gy) * p.W + gx) * p.Cin +
                                ch) * (16 / E)
                       : src;
    nesr::cp_async_zfill<16>(raw + px * RAW_PITCH + it % NV * 16, g,
                             ok ? 16 : 0);
  }
}

// Quantise the landed raw patch into the int8 patch ldmatrix reads.
template <int KC, int E>
__device__ __forceinline__ void quantise_raw(const unsigned char* raw,
                                             int8_t* patch, float r) {
  constexpr int NV = KC / E;
  for (int it = wtid(); it < PATCH_PX * NV; it += WG_THREADS) {
    const int px = it / NV, v = it % NV;
    store_q(patch + px * (KC + 16) + v * E,
            *reinterpret_cast<const uint4*>(raw + px * RAW_PITCH + v * 16), r,
            E == 8);
  }
}

// Quantise channels [c0, c0 + KC) of the (TH+2) x (TW+2) input patch into
// int8 without the raw buffer (a float32 source of more than 32 channels,
// or several passes): 16-byte loads into registers, six a thread in
// flight, zeros for out-of-image pixels and channels >= Cin.
template <typename T, int KC>
__device__ __forceinline__ void stage_patch_vec(const Params& p,
                                                int8_t* patch, int n, int oy,
                                                int ox, int c0, float r) {
  constexpr int PITCH = KC + 16, E = 16 / sizeof(T), NV = KC / E;
  constexpr int TOTAL = PATCH_PX * NV, R = 6;
  const T* src = static_cast<const T*>(p.src);
  for (int i0 = 0; i0 < TOTAL; i0 += R * WG_THREADS) {
    uint4 v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int it = wtid() + i0 + i * WG_THREADS;
      const int px = it / NV, ch = c0 + it % NV * E;
      const int gy = oy - 1 + px / (TW + 2), gx = ox - 1 + px % (TW + 2);
      const bool ok = it < TOTAL && gy >= 0 && gy < p.H && gx >= 0 &&
                      gx < p.W && ch < p.Cin;
      v[i] = ok ? __ldg(reinterpret_cast<const uint4*>(
                      src + ((size_t)(n * p.H + gy) * p.W + gx) * p.Cin + ch))
                : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int it = wtid() + i0 + i * WG_THREADS;
      if (it < TOTAL)
        store_q(patch + it / NV * PITCH + it % NV * E, v[i], r, E == 8);
    }
  }
}

// The same one element at a time, for widths the 16-byte path does not
// take.
template <typename T, int KC>
__device__ void stage_patch_scalar(const Params& p, int8_t* patch, int n,
                                   int oy, int ox, int c0, float r) {
  const T* src = static_cast<const T*>(p.src);
  for (int it = wtid(); it < PATCH_PX * KC; it += WG_THREADS) {
    const int px = it / KC, ch = c0 + it % KC;
    const int gy = oy - 1 + px / (TW + 2), gx = ox - 1 + px % (TW + 2);
    const bool ok =
        gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && ch < p.Cin;
    const float h = ok ? to_f(src[((size_t)(n * p.H + gy) * p.W + gx) *
                                      p.Cin + ch])
                       : 0.f;
    patch[px * (KC + 16) + it % KC] = (int8_t)quant(h, r);
  }
}

template <int KC>
__device__ __forceinline__ void stage_patch(const Params& p, int8_t* patch,
                                            int n, int oy, int ox, int c0,
                                            float r) {
  if (p.vec) {
    if (p.src_bf16) stage_patch_vec<bf16, KC>(p, patch, n, oy, ox, c0, r);
    else stage_patch_vec<float, KC>(p, patch, n, oy, ox, c0, r);
  } else {
    if (p.src_bf16) stage_patch_scalar<bf16, KC>(p, patch, n, oy, ox, c0, r);
    else stage_patch_scalar<float, KC>(p, patch, n, oy, ox, c0, r);
  }
}

// V values (8: one 16-byte bf16 vector or two float4; 1: a scalar) at
// element offset i of a bf16 or float32 array, as floats, and back.
template <int V>
__device__ __forceinline__ void load_any(const void* base, bool is_bf16,
                                         size_t i, float (&f)[V]) {
  if (is_bf16) {
    const bf16* s = static_cast<const bf16*>(base) + i;
    if constexpr (V == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(s));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[2 * e] = bf16_bits_lo(w[e]);
        f[2 * e + 1] = bf16_bits_hi(w[e]);
      }
    } else {
      f[0] = __bfloat162float(*s);
    }
  } else {
    const float* s = static_cast<const float*>(base) + i;
    if constexpr (V == 8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(s));
      const float4 b = __ldg(reinterpret_cast<const float4*>(s) + 1);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    } else {
      f[0] = *s;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_any(void* base, bool is_bf16, size_t i,
                                          const float (&f)[V]) {
  if (is_bf16) {
    bf16* d = static_cast<bf16*>(base) + i;
    if constexpr (V == 8) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *d = __float2bfloat16_rn(f[0]);
    }
  } else {
    float* d = static_cast<float*>(base) + i;
    if constexpr (V == 8) {
      reinterpret_cast<float4*>(d)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(d)[1] = make_float4(f[4], f[5], f[6], f[7]);
    } else {
      *d = f[0];
    }
  }
}

// max of the bits of |v| (>= 0, so integer order is float order; a NaN's
// bits exceed infinity's, so it wins as in torch.amax).
__device__ __forceinline__ int amax_bits(int m, float v) {
  return max(m, __float_as_int(fabsf(v)));
}

// Rounds to the output dtype as a PyTorch op of that dtype would.
__device__ __forceinline__ float rnd(float v, bool is_bf16) {
  return is_bf16 ? nesr::round_bf16(v) : v;
}

// The block's max into *dst: warp shuffles, then one atomicMax.
__device__ __forceinline__ void block_amax(int m, int* red, int* dst) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, red[w]);
    atomicMax(dst, m);
  }
}

// The coalesced half of the epilogue, V channels an item, consecutive
// threads on consecutive vectors of a pixel (16-byte stores when V is 8).
// `tile` holds this N tile's bf16 values after the fragment adds: x_{k+1}'s
// slot sums (channels < g), the other slots' sums, or x5 (step 4); `bias`
// the N tile's biases.
template <int V, int N>
__device__ int write_tile(const Params& p, const bf16* tile,
                          const float* bias, int n, int oy, int ox, int co0,
                          int nvalid, int m) {
  const size_t img = (size_t)n * p.H * p.W;
  if (p.k < 4) {
    const int nx = max(0, min(p.g - co0, nvalid));   // x_{k+1} channels
    const int nvx = nx / V, nvs = (nvalid - nx) / V;
#pragma unroll 1
    for (int it = wtid(); it < PX * nvx; it += WG_THREADS) {
      const int v = it % nvx, px = it / nvx;
      const int gy = oy + px / TW, gx = ox + px % TW;
      if (gy >= p.H || gx >= p.W) continue;
      float f[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        f[e] = nesr::lrelu(__fadd_rn(
            __bfloat162float(tile[px * (N + 8) + V * v + e]),
            bias[V * v + e]));
        m = amax_bits(m, f[e]);
      }
      store_any<V>(p.xn, false,
                   (img + (size_t)gy * p.W + gx) * p.g + co0 + V * v, f);
    }
#pragma unroll 1
    for (int it = wtid(); it < PX * nvs; it += WG_THREADS) {
      const int v = it % nvs, px = it / nvs;
      const int gy = oy + px / TW, gx = ox + px % TW;
      if (gy >= p.H || gx >= p.W) continue;
      const bf16* s = tile + px * (N + 8) + nx + V * v;
      bf16* d = p.slots + (img + (size_t)gy * p.W + gx) * p.cs + p.k * p.g +
                co0 + nx + V * v;
      if constexpr (V == 8) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      } else {
        *d = *s;
      }
    }
    return m;
  }
  // Step 4: out = x + 0.2 * (x5 + b) in x's dtype, then skip + 0.2 * out.
  const bool xb = p.x_bf16;
  const int nv = nvalid / V;
#pragma unroll 1
  for (int it = wtid(); it < PX * nv; it += WG_THREADS) {
    const int v = it % nv, px = it / nv;
    const int gy = oy + px / TW, gx = ox + px % TW;
    if (gy >= p.H || gx >= p.W) continue;
    const size_t at = (img + (size_t)gy * p.W + gx) * p.Cout + co0 + V * v;
    float xv[V], sv[V], o[V];
    load_any<V>(p.x, xb, at, xv);
    if (p.skip) load_any<V>(p.skip, xb, at, sv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x5 = __bfloat162float(tile[px * (N + 8) + V * v + e]);
      const float t = rnd(__fadd_rn(x5, bias[V * v + e]), xb);
      o[e] = rnd(__fadd_rn(xv[e], rnd(__fmul_rn(0.2f, t), xb)), xb);
      if (p.skip)
        o[e] = rnd(__fadd_rn(sv[e], rnd(__fmul_rn(0.2f, o[e]), xb)), xb);
      m = amax_bits(m, o[e]);
    }
    store_any<V>(p.out, xb, at, o);
  }
  return m;
}

// Step k >= 1: the slots this N tile adds to (slot channels k g + co0 ..)
// into the output staging tile, by 16-byte cp.async under the MMAs (the
// scalar path by plain loads); out-of-image pixels are left as they are,
// since nothing of them is written.
template <int N>
__device__ void prefetch_slots(const Params& p, bf16* tile, int n, int oy,
                               int ox, int co0, int nvalid) {
  const bf16* base = p.slots + (size_t)n * p.H * p.W * p.cs + p.k * p.g +
                     co0;
  const int v8 = p.vec ? 8 : 1, nv = nvalid / v8;
#pragma unroll 1
  for (int it = wtid(); it < PX * nv; it += WG_THREADS) {
    const int v = it % nv, px = it / nv;
    const int gy = oy + px / TW, gx = ox + px % TW;
    if (gy >= p.H || gx >= p.W) continue;
    const bf16* s = base + ((size_t)gy * p.W + gx) * p.cs + v8 * v;
    bf16* d = tile + px * (N + 8) + v8 * v;
    if (p.vec) nesr::cp_async_zfill<16>(d, s, 16);
    else *d = *s;
  }
}

template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
rdb_int8_step_kernel(const Params p) {
  using S = Smem<N, KS>;
  constexpr int STAGES = S::STAGES, TPS = S::TPS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, lt = tid % WG_THREADS;
  // This worker's own staging: output tile, patch, raw patch, columns.
  unsigned char* mine = smem + S::WORKER_OFF + wg * S::WORKER;
  bf16* tile = reinterpret_cast<bf16*>(mine);
  int8_t* patch = reinterpret_cast<int8_t*>(mine + S::PATCH_OFF);
  unsigned char* raw = mine + S::RAW_OFF;
  float* cscale = reinterpret_cast<float*>(mine + S::COLS_OFF);
  float* cbias = cscale + N;
  int* red = reinterpret_cast<int*>(smem + S::RED_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int npass = p.kp / S::KC;
  // Slabs a tile walks; with all of them in the ring they stay resident
  // and the two workers walk their tiles on their own. Through a ring,
  // both walk every slab, and release each.
  const int per_tile = p.n_tiles * npass * 9 / TPS;
  const bool ring = per_tile > STAGES;
  const int stride = 2 * gridDim.x, w = 2 * blockIdx.x + wg;
  const int iters = (p.tiles - w + stride - 1) / stride;
  const int iters0 = (p.tiles - 2 * (int)blockIdx.x + stride - 1) / stride;
  const int total = ring ? iters0 * per_tile : per_tile;
  const uint32_t ring_s = nesr::smem_u32(smem);
  const uint32_t full_s = nesr::smem_u32(full), empty_s = full_s + 8 * STAGES;
  const uint32_t a_s = nesr::smem_u32(patch) +
      (warp % 4 * (TW + 2) + lane % 16) * S::PITCH + lane / 16 * 16;
  // Slab g of the block's walk holds slab g % per_tile of the packing.
  auto issue = [&](int g) {
    const int s = g % STAGES;
    nesr::bulk_load(ring_s + s * S::SLAB,
                    p.wp + (size_t)(g % per_tile) * S::SLAB, S::SLAB,
                    full_s + 8 * s);
  };
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

  // The JAX package's order: 127 / s to quantise, s / 127 (then times w_s)
  // to dequantise, each one IEEE division.
  const float s_raw = *p.s_src;
  const float s_in = s_raw < 1e-8f ? 1e-8f : s_raw;   // a NaN stays a NaN
  const float r = __fdiv_rn(127.0f, s_in), sx = __fdiv_rn(s_in, 127.0f);
  const int frow = lane / 4, q = lane % 4;   // accumulator row, column pair
  // The raw patch path: one pass of at most 128 bytes a pixel.
  const bool use_raw =
      p.vec && npass == 1 && S::KC * (p.src_bf16 ? 2 : 4) <= RAW_PITCH;
  const int per_img = p.tiles_x * ((p.H + TH - 1) / TH);
  auto origin = [&](int t_idx, int& n, int& oy, int& ox) {
    n = t_idx / per_img;
    const int ti = t_idx % per_img;
    oy = ti / p.tiles_x * TH;
    ox = ti % p.tiles_x * TW;
  };
  int acc[N / 2];
  uint32_t a[2][KS][4];
  int m = 0;   // max |written| as float bits
  int G = 0;   // slabs walked (ring)
  // The raw path in the source's type: 16-byte vectors of 8 bf16 or 4
  // floats.
  auto raw_load = [&](int t_idx) {
    int n0, oy0, ox0;
    origin(t_idx, n0, oy0, ox0);
    if (p.src_bf16) load_raw<S::KC, 8>(p, raw, n0, oy0, ox0);
    else load_raw<S::KC, 4>(p, raw, n0, oy0, ox0);
    cp_async_commit();
  };
  if (use_raw && iters > 0) raw_load(w);

  for (int it = 0; it < (ring ? iters0 : iters); ++it) {
    const int t_idx = w + it * stride;
    if (t_idx >= p.tiles) {
      // A worker out of tiles still walks the ring's slabs of its
      // partner's last tile, so that each slot is released.
      for (int g = G; g < G + per_tile; ++g) {
        nesr::mbar_wait(full_s + 8 * (g % STAGES), (g / STAGES) & 1);
        release(g);
      }
      G += per_tile;
      continue;
    }
    int n, oy, ox;
    origin(t_idx, n, oy, ox);
    const bool next = t_idx + stride < p.tiles;
    for (int nt = 0; nt < p.n_tiles; ++nt) {
      const int co0 = nt * N, nvalid = min(N, p.Cout - co0);
      worker_sync(wg);   // the last N tile's staging and patch are free
      if (lt < N) {
        const int co = co0 + lt;
        cscale[lt] = co < p.Cout ? __fmul_rn(sx, p.w_s[co]) : 0.f;
        cbias[lt] = co < p.Cout ? p.bias[p.k * p.g + co] : 0.f;
      }
      if (p.k > 0) {
        prefetch_slots<N>(p, tile, n, oy, ox, co0, nvalid);
        cp_async_commit();
      }
      if (use_raw && nt == 0) {
        // This tile's raw patch (committed before the slots) has landed.
        if (p.k > 0) cp_async_wait<1>();
        else cp_async_wait<0>();
        worker_sync(wg);
        if (p.src_bf16) quantise_raw<S::KC, 8>(raw, patch, r);
        else quantise_raw<S::KC, 4>(raw, patch, r);
        worker_sync(wg);
        if (next) raw_load(t_idx + stride);
      }
      for (int c = 0; c < npass; ++c) {
        if (!use_raw && (nt == 0 || npass > 1)) {
          if (c > 0) worker_sync(wg);   // every warp done reading it
          stage_patch<S::KC>(p, patch, n, oy, ox, c * S::KC, r);
          worker_sync(wg);
        }
        if (c == 0) {
#pragma unroll
          for (int e = 0; e < N / 2; ++e) acc[e] = 0;
        }
        // This pass's first slab: its index in the block's walk.
        const int g0 = ring ? G : (nt * npass + c) * (9 / TPS);
        if constexpr (TPS == 9) {
          nesr::mbar_wait(full_s + 8 * (g0 % STAGES),
                          ring ? (g0 / STAGES) & 1 : 0);
          __syncwarp();
          const uint32_t bs = ring_s + (g0 % STAGES) * S::SLAB;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int tap_off = ((t / 3) * (TW + 2) + t % 3) * S::PITCH;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              nesr::ldsm_x4_at(a[t & 1][kk], a_s + tap_off + kk * 32);
            nesr::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              nesr::wgmma_rs_s8<N>(
                  acc, a[t & 1][kk],
                  nesr::wgmma_desc(bs + (t * KS + kk) * 32 * N, 128, 256));
            nesr::wgmma_commit();
            if (t > 0) nesr::wgmma_wait<1>();
          }
          nesr::wgmma_wait<0>();
          if (ring) {
            release(g0);
            if (tid == 0 && g0 + STAGES < total) {
              nesr::mbar_wait(empty_s + 8 * (g0 % STAGES),
                              (g0 / STAGES) & 1);
              issue(g0 + STAGES);
            }
            G += 1;
          }
        } else {
          // One slab a tap, through the ring (per_tile >= 9 > STAGES).
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int g = g0 + t, s = g % STAGES;
            nesr::mbar_wait(full_s + 8 * s, (g / STAGES) & 1);
            __syncwarp();
            const int tap_off = ((t / 3) * (TW + 2) + t % 3) * S::PITCH;
            const uint32_t bs = ring_s + s * S::SLAB;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              nesr::ldsm_x4_at(a[t & 1][kk], a_s + tap_off + kk * 32);
            nesr::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              nesr::wgmma_rs_s8<N>(acc, a[t & 1][kk],
                                   nesr::wgmma_desc(bs + kk * 32 * N, 128,
                                                    256));
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
          G += 9;
        }
      }
#pragma unroll
      for (int e = 0; e < N / 2; ++e) nesr::reg_fence(acc[e]);

      // Dequantise, round to bf16 once, and add into the prefetched slots
      // in place (step 0 has none: its values are the slots' first terms).
      // The next tile's raw patch, committed after tile 0's slots, may
      // stay in flight.
      if (p.k > 0) {
        if (use_raw && nt == 0 && next) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      worker_sync(wg);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(
            cscale + 8 * j + 2 * q);
        const float s0 = sc.x, s1 = sc.y;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0);
          float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1);
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              tile + (warp % 4 * TW + frow + 8 * h) * (N + 8) + 8 * j + 2 * q);
          if (p.k > 0) {
            const __nv_bfloat162 sl = *o;
            v0 = __fadd_rn(__bfloat162float(sl.x), nesr::round_bf16(v0));
            v1 = __fadd_rn(__bfloat162float(sl.y), nesr::round_bf16(v1));
          }
          *o = __floats2bfloat162_rn(v0, v1);
        }
      }
      worker_sync(wg);
      m = p.vec
              ? write_tile<8, N>(p, tile, cbias, n, oy, ox, co0, nvalid, m)
              : write_tile<1, N>(p, tile, cbias, n, oy, ox, co0, nvalid, m);
    }
  }
  block_amax(m, red, p.s_out);
}

// Lets the kernel take its shared memory, two blocks an SM.
template <int N, int KS>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      rdb_int8_step_kernel<N, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<N, KS>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(rdb_int8_step_kernel<N, KS>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int N, int KS>
int occupancy(int* blocks, int* smem) {
  cudaError_t err = configure<N, KS>();
  if (err != cudaSuccess) return (int)err;
  *smem = Smem<N, KS>::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rdb_int8_step_kernel<N, KS>, THREADS, Smem<N, KS>::BYTES);
}

template <int N, int KS>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Smem<N, KS>::BYTES;
  cudaError_t err = configure<N, KS>();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = min((p.tiles + 1) / 2, 2 * sms);
  rdb_int8_step_kernel<N, KS><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int N>
int launch_ks(const Params& p, int ks, cudaStream_t stream) {
  return ks == 1 ? launch<N, 1>(p, stream) : launch<N, 2>(p, stream);
}

// max|x| over n elements (bf16 or float32) as float bits into *dst.
__global__ void __launch_bounds__(THREADS)
amax_kernel(const void* x, int is_bf16, long long n, int vec, int* dst) {
  __shared__ int red[THREADS / 32];
  int m = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const int e = is_bf16 ? 8 : 4;
    const long long nv = n / e;
    const uint4* v = static_cast<const uint4*>(x);
    for (long long i = first; i < nv; i += stride) {
      const uint4 u = __ldg(v + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (is_bf16) {
          m = amax_bits(m, bf16_bits_lo(w[j]));
          m = amax_bits(m, bf16_bits_hi(w[j]));
        } else {
          m = amax_bits(m, __uint_as_float(w[j]));
        }
      }
    }
    done = nv * e;
  }
  for (long long i = done + first; i < n; i += stride)
    m = amax_bits(m, is_bf16 ? __bfloat162float(static_cast<const bf16*>(x)[i])
                             : static_cast<const float*>(x)[i]);
  block_amax(m, red, dst);
}

}  // namespace

// One step k (0..4) of the int8 RDB; see the header. n_width: the N tile
// width the weights were packed for (kernels/conv3x3.py:tile_width(Cout)).
// vec: every width a multiple of 8 and every pointer 16-byte aligned.
extern "C" int nesr_rdb_int8_step(
    const void* src, const void* wp, const void* w_s, const void* bias,
    const void* s_src, void* s_out, void* slots, void* xn, const void* x,
    const void* skip, void* out, int N, int H, int W, int Cin, int Cout,
    int k, int g, int cs, int n_width, int src_bf16, int x_bf16, int vec,
    void* stream) {
  const int ks = Cin <= 32 ? 1 : 2;
  Params p;
  p.src = src;
  p.wp = (const int8_t*)wp;
  p.w_s = (const float*)w_s;
  p.bias = (const float*)bias;
  p.s_src = (const float*)s_src;
  p.s_out = (int*)s_out;
  p.slots = (bf16*)slots;
  p.xn = (float*)xn;
  p.x = x;
  p.skip = skip;
  p.out = out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kp = round_up(Cin, 32 * ks);
  p.k = k;
  p.g = g;
  p.cs = cs;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles = N * p.tiles_x * ((H + TH - 1) / TH);
  p.n_tiles = (Cout + n_width - 1) / n_width;
  p.src_bf16 = src_bf16;
  p.x_bf16 = x_bf16;
  p.vec = vec;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_width) {
    case 8: return launch_ks<8>(p, ks, s);
    case 16: return launch_ks<16>(p, ks, s);
    case 32: return launch_ks<32>(p, ks, s);
    case 64: return launch_ks<64>(p, ks, s);
    case 80: return launch_ks<80>(p, ks, s);
    case 96: return launch_ks<96>(p, ks, s);
    case 128: return launch_ks<128>(p, ks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks an SM the step kernel of (n_width, Cin) runs at, and its dynamic
// shared memory in bytes.
extern "C" int nesr_rdb_int8_occupancy(int n_width, int Cin, int* blocks,
                                       int* smem) {
  const bool k1 = Cin <= 32;
  switch (n_width) {
    case 8: return k1 ? occupancy<8, 1>(blocks, smem)
                      : occupancy<8, 2>(blocks, smem);
    case 16: return k1 ? occupancy<16, 1>(blocks, smem)
                       : occupancy<16, 2>(blocks, smem);
    case 32: return k1 ? occupancy<32, 1>(blocks, smem)
                       : occupancy<32, 2>(blocks, smem);
    case 64: return k1 ? occupancy<64, 1>(blocks, smem)
                       : occupancy<64, 2>(blocks, smem);
    case 80: return k1 ? occupancy<80, 1>(blocks, smem)
                       : occupancy<80, 2>(blocks, smem);
    case 96: return k1 ? occupancy<96, 1>(blocks, smem)
                       : occupancy<96, 2>(blocks, smem);
    case 128: return k1 ? occupancy<128, 1>(blocks, smem)
                        : occupancy<128, 2>(blocks, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Zeroes the n_scales raw scales of an int8 trunk's chain, then puts
// max|x| over its n elements into the first: the scale of the first
// step's source. vec: x 16-byte aligned.
extern "C" int nesr_int8_amax(const void* x, int is_bf16, long long n,
                              int vec, void* scales, int n_scales,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scales, 0, sizeof(float) * n_scales, s);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)THREADS * (is_bf16 ? 8 : 4) * 4;
  const long long want = (n + per_block - 1) / per_block;
  const int grid = (int)(want < 4LL * sms ? (want > 0 ? want : 1) : 4LL * sms);
  amax_kernel<<<grid, THREADS, 0, s>>>(x, is_bf16, n, vec, (int*)scales);
  return (int)cudaGetLastError();
}
