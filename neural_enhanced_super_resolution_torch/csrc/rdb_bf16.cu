// K1 step: one conv of the bf16 residual dense block with its share of the
// dense-block assembly in the epilogue. Five launches an RDB (k = 0..4)
// compute the JAX package's _rdb_fused
// (neural_enhanced_super_resolution_tpu/models/rrdbnet.py:167-193), which
// is no Pallas kernel: XLA's bias-free bf16 convs (_conv3x3_f32, rounded
// to the compute dtype) with the assembly fused into their outputs. The
// port's plain composition of it, five K1 launches with the assembly in
// PyTorch between them (models/rrdbnet.py: FusedRDB._composition), is
// what this kernel equals bit for bit: K1's mainloop itself (the same
// K order: pass, tap, k16; the same N tiles), and the same rounding
// points in the epilogue (kernels/conv3x3_rdb.py: conv3x3_rdb_plain is
// that composition one step at a time). Built without --use_fast_math;
// every rounding below is an IEEE one (__fadd_rn, __fmul_rn,
// round-to-nearest-even casts).
//
// Step k reads its source (k 0: the RDB input x; k >= 1: x_k, bf16) and
// rounds the conv's fp32 sums once, c = bf16(acc). Conv k's output
// channel j belongs to assembly slot channel k g + j of the bf16 slot
// buffer (N, H, W, 4g + nf), laid out as conv 0's output: its first g
// channels complete slot k + 1 and give x_{k+1} = bf16(lrelu(float(
// bf16(slot + c)) + b)) (k 0: bf16(lrelu(float(c) + b))), stored into a
// buffer other than x_k, whose halo neighbouring blocks still read; the
// rest are added into the slots, bf16(float(slot) + float(c)), conv 0
// first, as PyTorch's bf16 adds run (step 0 stores c there). Step 4
// completes x5 = bf16(slot5 + c4) and writes out = x + 0.2 * bf16(x5 + b),
// each op rounded to bf16 as PyTorch rounds it, and with `skip` (the RRDB
// input, for an RRDB's third RDB) skip + 0.2 * out: the RRDB's residual.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), an RDB on the
// 4 x 268 x 268 tile batch (nf 64, g 32): its operations, 0.1392 ms (x
// read and out written, 256 bytes a pixel, take 0.022 ms). Five launches
// move 2,688 bytes a pixel (x read twice, x1..x4 written and read, the
// slots read and written, out written): 0.2307 ms, the floor of this
// design, not of the RDB. The five K1 convs of the composition already
// move the conv outputs (1,280 B a pixel written) and their inputs; the
// assembly between them moved each slot again, several times, as separate
// PyTorch passes. A block's stores and slot loads, which run after its
// MMAs, not the MMAs, are most of the step's time (PERF.md,
// tools/rdb_step_ablation.py).
//
// Design: K1's mainloop (csrc/conv3x3_body.cuh; one 8 x 16-pixel tile a
// block with every output channel in N tiles of at most 128, two blocks
// an SM, on the packed weights FusedRDB holds) with this epilogue, the K4
// step's (csrc/rdb_int8.cu): before an N tile's MMAs, cp.async brings the
// slot channels it adds to into the output staging tile (after the patch,
// which is waited for first); each thread adds its rounded fragment there
// in place, and the tile leaves with 16-byte stores (x_{k+1} and the
// slots, or out).
#include "conv3x3_body.cuh"

namespace {

constexpr int PX = TH * TW;

// x: the step's source (k 0: the RDB input; k >= 1: x_k, (N, H, W, g)).
struct Params : ConvParams {
  const float* bias;   // (cs,) the RDB's biases, conv1..conv5
  bf16* slots;         // (N, H, W, cs) bf16 assembly slots
  bf16* xn;            // k < 4: x_{k+1}, (N, H, W, g)
  const bf16* res;     // k 4: the RDB input, (N, H, W, nf)
  const bf16* skip;    // k 4: the RRDB input or null
  bf16* out;           // k 4: (N, H, W, nf)
  int k, g, cs;
  int vec_out;         // 16-byte slot, x_{k+1} and out paths
};

// Step k >= 1: the slots this N tile adds to (slot channels k g + co0 ..
// + nvalid) into the output staging tile, by 16-byte cp.async (the scalar
// path by plain loads); out-of-image pixels are left as they are, since
// nothing of them is written.
template <int N>
__device__ void prefetch_slots(const Params& p, bf16* tile, int n, int oy,
                               int ox, int co0, int nvalid) {
  const bf16* base = p.slots + (size_t)n * p.H * p.W * p.cs + p.k * p.g +
                     co0;
  const int v8 = p.vec_out ? 8 : 1, nv = nvalid / v8;
#pragma unroll 1
  for (int it = threadIdx.x; it < PX * nv; it += THREADS) {
    const int v = it % nv, px = it / nv;
    const int gy = oy + px / TW, gx = ox + px % TW;
    if (gy >= p.H || gx >= p.W) continue;
    const bf16* s = base + ((size_t)gy * p.W + gx) * p.cs + v8 * v;
    bf16* d = tile + px * (N + 8) + v8 * v;
    if (p.vec_out) nesr::cp_async_zfill<16>(d, s, 16);
    else *d = *s;
  }
}

__device__ __forceinline__ float bf16_bits_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_bits_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// V bf16 values (8: one 16-byte vector; 1: a scalar) at element offset i,
// as floats, and back, rounded to nearest even.
template <int V>
__device__ __forceinline__ void load_v(const bf16* base, size_t i,
                                       float (&f)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(base + i));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = bf16_bits_lo(w[e]);
      f[2 * e + 1] = bf16_bits_hi(w[e]);
    }
  } else {
    f[0] = __bfloat162float(base[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(bf16* base, size_t i,
                                        const float (&f)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(base + i) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    base[i] = __float2bfloat16_rn(f[0]);
  }
}

// The coalesced half of the epilogue, V channels an item, consecutive
// threads on consecutive vectors of a pixel (16-byte stores when V is 8).
// `tile` holds this N tile's bf16 values after the fragment adds: x_{k+1}'s
// slot sums (channels < g), the other slots' sums, or x5 (step 4).
template <int V, int N>
__device__ void write_tile(const Params& p, const bf16* tile, int n, int oy,
                           int ox, int co0, int nvalid) {
  const size_t img = (size_t)n * p.H * p.W;
  const float* bias = p.bias + p.k * p.g + co0;
  if (p.k < 4) {
    const int nx = max(0, min(p.g - co0, nvalid));   // x_{k+1} channels
    const int nvx = nx / V, nvs = (nvalid - nx) / V;
#pragma unroll 1
    for (int it = threadIdx.x; it < PX * nvx; it += THREADS) {
      const int v = it % nvx, px = it / nvx;
      const int gy = oy + px / TW, gx = ox + px % TW;
      if (gy >= p.H || gx >= p.W) continue;
      float f[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        f[e] = nesr::lrelu(__fadd_rn(
            __bfloat162float(tile[px * (N + 8) + V * v + e]),
            __ldg(bias + V * v + e)));
      store_v<V>(p.xn, (img + (size_t)gy * p.W + gx) * p.g + co0 + V * v, f);
    }
#pragma unroll 1
    for (int it = threadIdx.x; it < PX * nvs; it += THREADS) {
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
    return;
  }
  // Step 4: out = x + 0.2 * bf16(x5 + b), then skip + 0.2 * out, each op
  // rounded to bf16 as PyTorch's bf16 ops round (in float, 0.2 as 0.2f).
  const int nv = nvalid / V;
#pragma unroll 1
  for (int it = threadIdx.x; it < PX * nv; it += THREADS) {
    const int v = it % nv, px = it / nv;
    const int gy = oy + px / TW, gx = ox + px % TW;
    if (gy >= p.H || gx >= p.W) continue;
    const size_t at = (img + (size_t)gy * p.W + gx) * p.Cout + co0 + V * v;
    float xv[V], sv[V], o[V];
    load_v<V>(p.res, at, xv);
    if (p.skip) load_v<V>(p.skip, at, sv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x5 = __bfloat162float(tile[px * (N + 8) + V * v + e]);
      const float t = nesr::round_bf16(__fadd_rn(x5, __ldg(bias + V * v + e)));
      o[e] = nesr::round_bf16(
          __fadd_rn(xv[e], nesr::round_bf16(__fmul_rn(0.2f, t))));
      if (p.skip)
        o[e] = nesr::round_bf16(
            __fadd_rn(sv[e], nesr::round_bf16(__fmul_rn(0.2f, o[e]))));
    }
    store_v<V>(p.out, at, o);
  }
}

// The step's epilogue (conv_body's Epi).
struct StepEpi {
  using P = Params;

  static __device__ __forceinline__ int pad(const P&) { return 1; }

  // Step k >= 1 adds into the slots; step 0 writes their first terms.
  static __device__ __forceinline__ bool prefetches(const P& p) {
    return p.k > 0;
  }

  template <int N>
  static __device__ __forceinline__ void prefetch(const P& p, bf16* tile,
                                                  int n, int oy, int ox,
                                                  int co0, int nvalid) {
    prefetch_slots<N>(p, tile, n, oy, ox, co0, nvalid);
    cp_async_commit();
  }

  // Round the sums to bf16 once and add them into the prefetched slots in
  // place (step 0 has none: its values are the slots' first terms).
  template <int N>
  static __device__ __forceinline__ void stage(const P& p, bf16* tile,
                                               const float (&acc)[N / 2],
                                               int warp, int frow, int q,
                                               int) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
            tile + (warp * TW + frow + 8 * h) * (N + 8) + 8 * j + 2 * q);
        if (p.k > 0) {
          const __nv_bfloat162 sl = *o;
          v0 = __fadd_rn(__bfloat162float(sl.x), nesr::round_bf16(v0));
          v1 = __fadd_rn(__bfloat162float(sl.y), nesr::round_bf16(v1));
        }
        *o = __floats2bfloat162_rn(v0, v1);
      }
    }
  }

  template <int N>
  static __device__ __forceinline__ void write(const P& p, const bf16* tile,
                                               int n, int oy, int ox, int co0,
                                               int nvalid) {
    if (p.vec_out) write_tile<8, N>(p, tile, n, oy, ox, co0, nvalid);
    else write_tile<1, N>(p, tile, n, oy, ox, co0, nvalid);
  }
};

template <int N, int KS>
__global__ void __launch_bounds__(THREADS, 2)
rdb_bf16_step_kernel(const Params p) {
  conv_body<N, KS, 3, StepEpi>(p);
}

template <int N>
int launch_ks(const Params& p, int ks, int batch, cudaStream_t stream) {
  switch (ks) {
    case 1: return launch_tiles(rdb_bf16_step_kernel<N, 1>,
                                Smem<N, 1, 3>::BYTES, p, p.H, batch, stream);
    case 2: return launch_tiles(rdb_bf16_step_kernel<N, 2>,
                                Smem<N, 2, 3>::BYTES, p, p.H, batch, stream);
    default: return launch_tiles(rdb_bf16_step_kernel<N, 4>,
                                 Smem<N, 4, 3>::BYTES, p, p.H, batch, stream);
  }
}

}  // namespace

// One step k (0..4) of the bf16 RDB; see the header. n_width: the N tile
// width the weights were packed for (kernels/conv3x3.py:tile_width(Cout));
// a pass is 16, 32 or 64 input channels as Cin is at most 16, at most 32
// or more (kernels/conv3x3.py:pass_width). vec: g and nf multiples of 8
// and every pointer 16-byte aligned.
extern "C" int nesr_rdb_bf16_step(
    const void* src, const void* wp, const void* bias, void* slots, void* xn,
    const void* x, const void* skip, void* out, int N, int H, int W, int Cin,
    int Cout, int k, int g, int cs, int n_width, int vec, void* stream) {
  const int ks = Cin <= 16 ? 1 : Cin <= 32 ? 2 : 4;
  Params p;
  p.x = (const bf16*)src;
  p.wp = (const bf16*)wp;
  p.bias = (const float*)bias;
  p.slots = (bf16*)slots;
  p.xn = (bf16*)xn;
  p.res = (const bf16*)x;
  p.skip = (const bf16*)skip;
  p.out = (bf16*)out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kp = round_up(Cin, 16 * ks);
  p.k = k;
  p.g = g;
  p.cs = cs;
  p.tiles_x = (W + TW - 1) / TW;
  p.vec = Cin % 8 == 0 ? 8 : Cin % 4 == 0 ? 4 : 1;
  p.vec_out = vec;
  p.n_tiles = (Cout + n_width - 1) / n_width;
  p.wave = 0;
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
